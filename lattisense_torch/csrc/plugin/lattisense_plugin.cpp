/* liblattisense_plugin.so — C ABI implementation of lattisense_torch
 * (embedded CPython).
 *
 * The runner is the port's PyTorch task runtime on the card, so it lives
 * in Python; this shim owns the interpreter and forwards raw struct
 * POINTERS (as uintptr_t) to lattisense_torch.plugin.capi, which casts
 * them with ctypes against the same abi layout and runs the task. No data
 * is copied at this boundary; outputs come back as struct pointers kept
 * alive by the Python-side handle registry until release. The exported C
 * symbols are those of csrc/lattisense_plugin.h, so a foreign binary links
 * against either library unchanged.
 *
 * Reference parity: the entry shapes mirror mega_ag_runners/wrapper.h
 * (create/run/release + int status) and run errors carry the verbatim
 * check_sig.h message strings.
 */
#include "lattisense_plugin.h"

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>

namespace {

std::mutex g_lock;
std::string g_create_error;
bool g_py_owned = false;

struct TaskState {
    long capi_id;          /* id in the Python-side registry */
    std::string last_error;
};

void ensure_python() {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        g_py_owned = true;
        /* release the GIL acquired by initialization */
        PyEval_SaveThread();
    }
}

struct Gil {
    PyGILState_STATE st;
    Gil() : st(PyGILState_Ensure()) {}
    ~Gil() { PyGILState_Release(st); }
};

/* call lattisense_torch.plugin.capi.<fn>(*args); returns new ref or NULL */
PyObject* call_capi(const char* fn, PyObject* args, std::string* err) {
    PyObject* mod = PyImport_ImportModule("lattisense_torch.plugin.capi");
    if (!mod) {
        PyObject *t, *v, *tb;
        PyErr_Fetch(&t, &v, &tb);
        PyObject* s = v ? PyObject_Str(v) : nullptr;
        *err = std::string("import lattisense_torch.plugin.capi failed: ") +
               (s ? PyUnicode_AsUTF8(s) : "unknown");
        Py_XDECREF(s);
        Py_XDECREF(t); Py_XDECREF(v); Py_XDECREF(tb);
        return nullptr;
    }
    PyObject* f = PyObject_GetAttrString(mod, fn);
    Py_DECREF(mod);
    if (!f) {
        *err = std::string("capi has no attribute ") + fn;
        return nullptr;
    }
    PyObject* out = PyObject_CallObject(f, args);
    Py_DECREF(f);
    if (!out) {
        PyObject *t, *v, *tb;
        PyErr_Fetch(&t, &v, &tb);
        PyErr_NormalizeException(&t, &v, &tb);
        PyObject* s = v ? PyObject_Str(v) : nullptr;
        *err = s ? PyUnicode_AsUTF8(s) : "unknown python error";
        Py_XDECREF(s);
        Py_XDECREF(t); Py_XDECREF(v); Py_XDECREF(tb);
        return nullptr;
    }
    return out;
}

}  // namespace

extern "C" {

fhe_task_handle create_fhe_tpu_task(const char* project_path) {
    std::lock_guard<std::mutex> g(g_lock);
    ensure_python();
    Gil gil;
    std::string err;
    PyObject* args = Py_BuildValue("(s)", project_path);
    PyObject* out = call_capi("create_task", args, &err);
    Py_DECREF(args);
    if (!out) {
        g_create_error = err;
        return nullptr;
    }
    long cid = PyLong_AsLong(out);
    Py_DECREF(out);
    if (cid < 0) {
        g_create_error = "create_task returned invalid id";
        return nullptr;
    }
    auto* st = new TaskState{cid, ""};
    return reinterpret_cast<fhe_task_handle>(st);
}

void release_fhe_tpu_task(fhe_task_handle handle) {
    if (!handle) return;
    std::lock_guard<std::mutex> g(g_lock);
    auto* st = reinterpret_cast<TaskState*>(handle);
    Gil gil;
    std::string err;
    PyObject* args = Py_BuildValue("(l)", st->capi_id);
    PyObject* out = call_capi("release_task", args, &err);
    Py_DECREF(args);
    Py_XDECREF(out);
    delete st;
}

int run_fhe_tpu_task(fhe_task_handle handle,
                     CArgument* input_args, uint64_t n_in_args,
                     CArgument* output_args, uint64_t n_out_args,
                     int mf_nbits) {
    if (!handle) return 1;
    std::lock_guard<std::mutex> g(g_lock);
    auto* st = reinterpret_cast<TaskState*>(handle);
    st->last_error.clear();
    Gil gil;

    /* marshal arguments as [(id, type, [elem_addr...], level), ...] */
    auto pack = [](CArgument* a, uint64_t n) {
        PyObject* lst = PyList_New((Py_ssize_t)n);
        for (uint64_t i = 0; i < n; i++) {
            void** elems = reinterpret_cast<void**>(a[i].data);
            PyObject* addrs = PyList_New(a[i].size);
            for (int k = 0; k < a[i].size; k++) {
                PyList_SET_ITEM(addrs, k, PyLong_FromVoidPtr(
                    elems ? elems[k] : nullptr));
            }
            PyObject* row = Py_BuildValue("(siNi)", a[i].id,
                                          (int)a[i].type, addrs,
                                          a[i].level);
            PyList_SET_ITEM(lst, (Py_ssize_t)i, row);
        }
        return lst;
    };
    PyObject* ins = pack(input_args, n_in_args);
    PyObject* out_ids = PyList_New((Py_ssize_t)n_out_args);
    for (uint64_t i = 0; i < n_out_args; i++) {
        PyList_SET_ITEM(out_ids, (Py_ssize_t)i,
                        PyUnicode_FromString(output_args[i].id));
    }
    std::string err;
    PyObject* args = Py_BuildValue("(lNNi)", st->capi_id, ins, out_ids,
                                   mf_nbits);
    PyObject* out = call_capi("run_task", args, &err);
    Py_DECREF(args);
    if (!out) {
        st->last_error = err;
        return 2;
    }
    /* out: list of (elem_ptr_array_addr, size, level) per output argument;
     * the void*[] arrays live in the Python-side registry (freed at
     * release_fhe_tpu_task), so nothing is allocated here */
    for (uint64_t i = 0; i < n_out_args; i++) {
        PyObject* row = PyList_GetItem(out, (Py_ssize_t)i);
        output_args[i].data =
            PyLong_AsVoidPtr(PyTuple_GetItem(row, 0));
        output_args[i].size = (int)PyLong_AsLong(PyTuple_GetItem(row, 1));
        output_args[i].level = (int)PyLong_AsLong(PyTuple_GetItem(row, 2));
        output_args[i].type = TYPE_CIPHERTEXT;
    }
    Py_DECREF(out);
    return 0;
}

const char* lst_last_error(fhe_task_handle handle) {
    if (!handle) return g_create_error.c_str();
    return reinterpret_cast<TaskState*>(handle)->last_error.c_str();
}

} /* extern "C" */
