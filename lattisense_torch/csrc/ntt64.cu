// Kernel B5: negacyclic NTT / inverse NTT over 64-bit-word primes (below 2^62),
// one row per block.
//
// Replaces lattisense_tpu/ops/ntt_pallas64f.py `ntt_fused64` / `intt_fused64`
// and lattisense_tpu/ops/ntt_pallas.py `ntt_fused`, `_intt_fused_impl` and
// `intt_fused` (`_intt_conj_impl`): all five compute the u64 forward and
// inverse transforms of lattisense_tpu/core/ntt.py, so one kernel with both
// directions stands for them. Forward is Cooley-Tukey, natural ->
// bit-reversed order; inverse Gentleman-Sande, bit-reversed -> natural with
// the n^-1 scale. Butterflies are Shoup multiplications with R = 2^64
// (the quotient from __umul64hi) by the ring's bit-reversed twiddle tables,
// so every output is the canonical residue in [0, q) and equal to any correct
// reference NTT.
//
// What bounds it: a row of n residues is moved twice through device memory
// (8 B in, 8 B out) against one Shoup product (three 64-bit multiplies, each
// several 32-bit IMADs) and two modular adds per butterfly, n/2 * log2(n)
// butterflies: at n = 16384 about 30 32-bit operations per byte, so the
// kernel sits near the card's balance point and its first bound is bytes.
// The design keeps the whole row resident in shared memory (n * 8 B, 128 KB
// at n = 16384: one block per SM, hence the attribute), so all log2(n)
// stages run between one read and one write of the row. Twiddles are read
// from global memory (L2-resident). The optional `post` constant multiplies
// every output by a per-limb constant with its Shoup companion: n^-1 (or
// n^-1 * 2^-64, folding a from-Montgomery into the inverse) and 2^64 mod q
// (to-Montgomery) for the forward transform when the caller asks for it.
// n above 2^14 does not fit a block's shared memory and is refused.
//
// Rows are laid out (rows, n) contiguous; row r uses limb r % limbs of the
// tables, so any (..., L, n) stack is one launch. Tables and residues are
// int64 tensors on the Python side, read here as the same 64-bit patterns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLogn = 14;

__device__ __forceinline__ uint64_t shoup_mul(uint64_t a, uint64_t w, uint64_t ws, uint64_t q) {
  const uint64_t hi = __umul64hi(a, ws);
  const uint64_t r = a * w - hi * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b, uint64_t q) {
  const uint64_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint64_t sub_mod(uint64_t a, uint64_t b, uint64_t q) {
  return a >= b ? a - b : a + q - b;
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads) ntt64_kernel(
    const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int limbs, int logn,
    const uint64_t* __restrict__ tw, const uint64_t* __restrict__ tws,
    const uint64_t* __restrict__ qv, const uint64_t* __restrict__ post,
    const uint64_t* __restrict__ posts) {
  extern __shared__ uint64_t s[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const size_t row = blockIdx.x;
  const int limb = static_cast<int>(row % limbs);
  const uint64_t q = qv[limb];
  const uint64_t* w = tw + static_cast<size_t>(limb) * n;
  const uint64_t* ws = tws + static_cast<size_t>(limb) * n;

  const uint64_t* xr = x + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = xr[i];
  __syncthreads();

  if (!kInverse) {
    // stage with m groups of distance t = n / (2m): twiddle psi_rev[m + group]
    for (int m = 1, lt = logn - 1; m < n; m <<= 1, --lt) {
      const int t = 1 << lt;
      for (int k = threadIdx.x; k < half; k += blockDim.x) {
        const int g = k >> lt;
        const int idx = (g << (lt + 1)) + (k & (t - 1));
        const uint64_t u = s[idx];
        const uint64_t v = shoup_mul(s[idx + t], w[m + g], ws[m + g], q);
        s[idx] = add_mod(u, v, q);
        s[idx + t] = sub_mod(u, v, q);
      }
      __syncthreads();
    }
  } else {
    for (int m = half, lt = 0; m >= 1; m >>= 1, ++lt) {
      const int t = 1 << lt;
      for (int k = threadIdx.x; k < half; k += blockDim.x) {
        const int g = k >> lt;
        const int idx = (g << (lt + 1)) + (k & (t - 1));
        const uint64_t u = s[idx];
        const uint64_t v = s[idx + t];
        s[idx] = add_mod(u, v, q);
        s[idx + t] = shoup_mul(sub_mod(u, v, q), w[m + g], ws[m + g], q);
      }
      __syncthreads();
    }
  }

  uint64_t* yr = y + row * n;
  if (post != nullptr) {
    const uint64_t pv = post[limb], pvs = posts[limb];
    for (int i = threadIdx.x; i < n; i += blockDim.x) yr[i] = shoup_mul(s[i], pv, pvs, q);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) yr[i] = s[i];
  }
}

template <bool kInverse>
int launch(const uint64_t* x, uint64_t* y, int rows, int limbs, int logn, const uint64_t* tw,
           const uint64_t* tws, const uint64_t* q, const uint64_t* post, const uint64_t* posts,
           cudaStream_t stream) {
  if (logn < 1 || logn > kMaxLogn) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint64_t) << logn;
  cudaError_t err = cudaFuncSetAttribute(ntt64_kernel<kInverse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (1 << logn) / 2 < kThreads ? (1 << logn) / 2 : kThreads;
  ntt64_kernel<kInverse><<<rows, threads, smem, stream>>>(x, y, limbs, logn, tw, tws, q, post,
                                                          posts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward transform of `rows` rows; `post`/`posts` may be null (no epilogue)
// or per-limb (value, Shoup companion) multiplied into every output.
extern "C" int ntt64_fwd_launch(const uint64_t* x, uint64_t* y, int rows, int limbs, int logn,
                                const uint64_t* psi_rev, const uint64_t* psi_rev_shoup,
                                const uint64_t* q, const uint64_t* post, const uint64_t* posts,
                                void* stream) {
  return launch<false>(x, y, rows, limbs, logn, psi_rev, psi_rev_shoup, q, post, posts,
                       static_cast<cudaStream_t>(stream));
}

// Inverse transform; `ninv`/`ninvs` are the per-limb n^-1 (times 2^-64 when
// a from-Montgomery is folded in) and its companion.
extern "C" int ntt64_inv_launch(const uint64_t* x, uint64_t* y, int rows, int limbs, int logn,
                                const uint64_t* psi_inv_rev, const uint64_t* psi_inv_rev_shoup,
                                const uint64_t* q, const uint64_t* ninv, const uint64_t* ninvs,
                                void* stream) {
  return launch<true>(x, y, rows, limbs, logn, psi_inv_rev, psi_inv_rev_shoup, q, ninv, ninvs,
                      static_cast<cudaStream_t>(stream));
}
