// Kernel B5: negacyclic NTT / inverse NTT over 64-bit-word primes (below 2^62).
//
// Replaces lattisense_tpu/ops/ntt_pallas64f.py `ntt_fused64` / `intt_fused64`
// and lattisense_tpu/ops/ntt_pallas.py `ntt_fused`, `_intt_fused_impl` and
// `intt_fused` (`_intt_conj_impl`): all five compute the u64 forward and
// inverse transforms of lattisense_tpu/core/ntt.py, so one kernel with both
// directions stands for them. Forward is Cooley-Tukey, natural ->
// bit-reversed order; inverse Gentleman-Sande, bit-reversed -> natural with
// the n^-1 scale. Butterflies are lazy Shoup multiplications with R = 2^64
// (the quotient from __umul64hi) by the ring's bit-reversed twiddles,
// rearranged per pass on the host (ops/ntt64_cuda.py `_tables`); every output
// is the canonical residue in [0, q) and equal to any correct reference NTT.
//
// What bounds it: a row of n residues moves twice through device memory
// (8 B in, 8 B out) against one Shoup product (three 64-bit multiplies, about
// 20 IMAD in SASS) and two additions per butterfly, n/2 * log2(n)
// butterflies: at n = 2^14 the integer multiplies on the CUDA cores, not the
// bytes, set the pace (the tensor cores are no lever). So the design
// (csrc/ntt_passes.cuh) spends its registers on the arithmetic: lazy
// butterflies in [0, 4q) (forward) or [0, 2q) (inverse) drop two of three
// conditional subtractions, the row touches device memory once each way in
// coalesced 8-byte pieces, and the four register passes (16 residues a
// thread, 1024 threads at n = 2^14) exchange whole 64-bit words through a
// 128 KB buffer. There is no room to stage the next row beside it; a staged
// row with an exchange in 32-bit halves spilled more and ran slower.
//
// n = 2^15 and 2^16 (a row of 256 or 512 KB, above the 227 KB a block may
// hold) take the cluster kernel of csrc/ntt_cluster.cuh, one launch for the
// reference's phase split (`_launch` / `_ilaunch` / `_claunch` of
// ntt_pallas.py): a cluster of 2^k blocks (4 at 2^15, 8 at 2^16) holds a
// row in sub-rows of 2^13, trades the k stages that span sub-rows through
// distributed shared memory and runs this row body on each sub-row as a
// limb of its own (the host re-indexes the tables, ops/ntt_cuda.py
// `split_pass_tables`). Above 2^16 is refused.
//
// Rows are laid out (rows, n) contiguous; row r uses limb r % limbs of the
// tables, so any (..., L, n) stack is one launch. Tables and residues are
// int64 tensors on the Python side, read here as the same 64-bit patterns.

#include "ntt_passes.cuh"
#include "ntt_cluster.cuh"

namespace {

constexpr int kMaxLogn = 14;          // the row kernel: a 64-bit row of 2^14 in 128 KB

template <bool kInverse>
int run(const int64_t* x, int64_t* y, int rows, int limbs, int logn, const void* tab,
        const void* q, const void* post, const void* posts, void* stream) {
  return ntt::dispatch<ntt::W64, kMaxLogn, kInverse, false>(
      logn, x, y, rows, limbs, tab, q, post, posts, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Forward transform of `rows` rows; `tab` is the forward pass table
// (limbs, entries, 2) of uint64 (value, Shoup companion); `post`/`posts` may
// be null (no epilogue) or per-limb (value, Shoup companion) multiplied into
// every output.
extern "C" int ntt64_fwd_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                const void* tab, const void* q, const void* post,
                                const void* posts, void* stream) {
  return run<false>(x, y, rows, limbs, logn, tab, q, post, posts, stream);
}

// Inverse transform with the inverse pass table; `ninv`/`ninvs` are the
// per-limb n^-1 (times 2^-64 when a from-Montgomery is folded in) and its
// companion.
extern "C" int ntt64_inv_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                const void* tab, const void* q, const void* ninv,
                                const void* ninvs, void* stream) {
  return run<true>(x, y, rows, limbs, logn, tab, q, ninv, ninvs, stream);
}

// Blocks of the forward (inverse != 0: inverse) kernel an SM holds at
// n = 2^logn, from the occupancy calculator, or minus a cudaError_t.
extern "C" int ntt64_blocks_per_sm(int logn, int inverse) {
  return inverse ? ntt::occupancy<ntt::W64, kMaxLogn, true>(logn)
                 : ntt::occupancy<ntt::W64, kMaxLogn, false>(logn);
}

// The transform of `rows` rows of n = 2^logn (15 or 16) in one launch of
// clusters of 2^(logn - logs) blocks over sub-rows of 2^logs (logs must be
// ntt::kSubLogn, the host's SUB_LOGN). `tab` is the
// direction's pass table over the virtual limbs (limbs 2^k, entries, 2),
// `ctab` the (limbs, 2^k, 2) column table, `q` the limbs' primes; `post` /
// `posts` per virtual limb as above (the inverse's n^-1 always).
extern "C" int ntt64_cluster_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                    int logs, int inverse, const void* tab, const void* ctab,
                                    const void* q, const void* post, const void* posts,
                                    void* stream) {
  return inverse ? ntt::launch_cluster_at<ntt::W64, true>(logn, logs, x, y, rows, limbs, tab,
                                                          ctab, q, post, posts, stream, nullptr)
                 : ntt::launch_cluster_at<ntt::W64, false>(logn, logs, x, y, rows, limbs, tab,
                                                           ctab, q, post, posts, stream, nullptr);
}

// Clusters of the cluster kernel at n = 2^logn over sub-rows of 2^logs that
// the current card holds at once (cudaOccupancyMaxActiveClusters), or minus
// a cudaError_t.
extern "C" int ntt64_cluster_fit(int logn, int logs, int inverse) {
  int fit = 0;
  const int err =
      inverse ? ntt::launch_cluster_at<ntt::W64, true>(logn, logs, nullptr, nullptr, 0, 1, nullptr,
                                                     nullptr, nullptr, nullptr, nullptr, nullptr,
                                                     &fit)
              : ntt::launch_cluster_at<ntt::W64, false>(logn, logs, nullptr, nullptr, 0, 1, nullptr,
                                                      nullptr, nullptr, nullptr, nullptr, nullptr,
                                                      &fit);
  return err != 0 ? -err : fit;
}
