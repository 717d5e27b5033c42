/* lattisense_plugin.h — C ABI for foreign libraries (SEAL / Lattigo / any
 * C or C++ application) to run LattiSense compiled tasks on raw-RNS
 * C structs, without touching Python types.
 *
 * Mirrors the reference plug-in boundary:
 *   - struct layout:   abi/c_types.h:26-60 (CComponent .. CGaloisKey)
 *   - argument layout: mega_ag_runners/c_argument.h:26-46 (CArgument)
 *   - entry shape:     mega_ag_runners/wrapper.h:31-105
 *                      (create_fhe_*_task / run_fhe_*_task / release)
 *
 * The implementation embeds CPython (the graph runtime is Python);
 * a foreign binary links ONLY against liblattisense_plugin.so and this
 * header. Signature checking uses the reference's verbatim error strings
 * (retrieve with lst_last_error after a nonzero run return).
 *
 * Data convention (matches cxx_sdk_v2/cxx_argument.h:143,193): CArgument
 * .data points to an array of .size element pointers; each element is a
 * CCiphertext pointer or CPlaintext pointer for TYPE_CIPHERTEXT and
 * TYPE_PLAINTEXT, a CRelinKey pointer for TYPE_RELIN_KEY, and a
 * CGaloisKey pointer for TYPE_GALOIS_KEY.
 * Output arguments are filled with freshly allocated structs owned by the
 * task handle (valid until release_fhe_tpu_task).
 */
#ifndef LATTISENSE_PLUGIN_H
#define LATTISENSE_PLUGIN_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- raw-RNS exchange structs (abi/c_types.h layout) ------------------ */
typedef struct {
    int n;
    uint64_t* data;
} CComponent;

typedef struct {
    int n_component;
    CComponent* components;
} CPolynomial;

typedef struct {
    int level;
    CPolynomial poly;
} CPlaintext;

typedef struct {
    int level;
    int degree;
    CPolynomial* polys;
} CCiphertext;

typedef CCiphertext CPublicKey;

typedef struct {
    int n_public_key;
    CPublicKey* public_keys;
} CKeySwitchKey;

typedef CKeySwitchKey CRelinKey;

typedef struct {
    int n_key_switch_key;
    uint64_t* galois_elements;
    CKeySwitchKey* key_switch_keys;
} CGaloisKey;

/* ---- argument marshaling (c_argument.h layout) ------------------------ */
typedef enum {
    TYPE_PLAINTEXT,
    TYPE_CIPHERTEXT,
    TYPE_RELIN_KEY,
    TYPE_GALOIS_KEY,
    TYPE_SWITCH_KEY,
    TYPE_CUSTOM,
} DataType;

typedef struct {
    const char* id;
    DataType type;
    void* data;   /* void*[size]: element pointers (see header comment) */
    int level;
    int size;
} CArgument;

typedef struct fhe_task_handle_st* fhe_task_handle;

/* ---- task lifecycle ---------------------------------------------------- */

/* Load a compiled task directory (mega_ag.json + task_signature.json).
 * Returns NULL on failure (message via lst_last_error(NULL)). */
fhe_task_handle create_fhe_tpu_task(const char* project_path);

void release_fhe_tpu_task(fhe_task_handle handle);

/* Run the task. input_args: data arguments in signature order, then key
 * arguments (rlk/glk as needed). output_args: ids set by caller; data is
 * filled with CCiphertext* arrays owned by the handle. Returns 0 on
 * success; nonzero = validation/run failure, message via lst_last_error.
 * mf_nbits mirrors the reference Montgomery-form control
 * (cxx_abi_bridge_executors.h:70): 0 = plain NTT/coeff residues. */
int run_fhe_tpu_task(fhe_task_handle handle,
                     CArgument* input_args, uint64_t n_in_args,
                     CArgument* output_args, uint64_t n_out_args,
                     int mf_nbits);

/* Last error message for the handle (or the global creation error when
 * handle is NULL). Valid until the next call on the same handle. */
const char* lst_last_error(fhe_task_handle handle);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* LATTISENSE_PLUGIN_H */
