// Kernel B1: negacyclic NTT / inverse NTT over 31-bit primes, one row per block.
//
// Replaces lattisense_tpu/ops/ntt_pallas32.py `ntt_fused32` / `intt_fused32`
// (kernels `_fwd_kernel` and `_inv_kernel`): forward Cooley-Tukey, natural ->
// bit-reversed order; inverse Gentleman-Sande, bit-reversed -> natural with the
// n^-1 scale. Butterflies are Shoup multiplications (R = 2^32) by the ring's
// bit-reversed twiddle tables, so every output is the canonical residue in
// [0, q) and equal to any correct reference NTT.
//
// What bounds it: a row of n residues is moved twice through device memory
// (int64 in, int64 out) against ~12 32-bit integer operations per butterfly
// and n/2 * log2(n) butterflies, so at n = 16384 the kernel is bound by
// bytes. The design keeps the whole row resident in shared memory (n * 4 B,
// 64 KB at n = 16384, above the 48 KB default, hence the attribute), so all
// log2(n) stages run between one read and one write of the row. Twiddles are
// read from global memory (L2-resident: a few hundred KB per chain). The
// optional `post` constant multiplies every output by a per-limb constant
// with its Shoup companion: n^-1 for the inverse, 2^32 mod q (to-Montgomery)
// for the forward transform when the caller asks for it.
//
// Rows are laid out (rows, n) contiguous; row r uses limb r % limbs of the
// tables, so any (..., L, n) stack is one launch.
//
// The perm entries (lattisense_tpu/ops/ntt_pallas32.py `ntt_fused32_perm` /
// `intt_fused32_perm`) are the same transform with the forward output stored,
// or the inverse input loaded, in the transposed tile layout: position
// b * (n / 128) + a of a perm-layout row holds standard-order element a * 128 + b.
// Only the row's load or store changes; its shared-memory side reads or
// writes with a stride of 128 words (bank conflicts, off the main path).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w, uint32_t ws, uint32_t q) {
  uint32_t hi = __umulhi(a, ws);
  uint32_t r = a * w - hi * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

constexpr int kLanes = 128;

template <bool kInverse, bool kPerm>
__global__ void __launch_bounds__(kThreads) ntt32_kernel(
    const int64_t* __restrict__ x, int64_t* __restrict__ y, int limbs, int logn,
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws,
    const uint32_t* __restrict__ qv, const uint32_t* __restrict__ post,
    const uint32_t* __restrict__ posts) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const size_t row = blockIdx.x;
  const int limb = static_cast<int>(row % limbs);
  const uint32_t q = qv[limb];
  const uint32_t* w = tw + static_cast<size_t>(limb) * n;
  const uint32_t* ws = tws + static_cast<size_t>(limb) * n;

  const int64_t* xr = x + row * n;
  if (kPerm && kInverse) {
    // perm position i = b * sub + a holds standard element a * 128 + b
    const int sub = n / kLanes;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      s[(i % sub) * kLanes + i / sub] = static_cast<uint32_t>(xr[i]);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = static_cast<uint32_t>(xr[i]);
  }
  __syncthreads();

  if (!kInverse) {
    // stage with m groups of distance t = n / (2m): twiddle psi_rev[m + group]
    for (int m = 1, lt = logn - 1; m < n; m <<= 1, --lt) {
      const int t = 1 << lt;
      for (int k = threadIdx.x; k < half; k += blockDim.x) {
        const int g = k >> lt;
        const int idx = (g << (lt + 1)) + (k & (t - 1));
        const uint32_t u = s[idx];
        const uint32_t v = shoup_mul(s[idx + t], w[m + g], ws[m + g], q);
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
        const uint32_t u = s[idx];
        const uint32_t v = s[idx + t];
        s[idx] = add_mod(u, v, q);
        s[idx + t] = shoup_mul(sub_mod(u, v, q), w[m + g], ws[m + g], q);
      }
      __syncthreads();
    }
  }

  int64_t* yr = y + row * n;
  if (kPerm && !kInverse) {
    const int sub = n / kLanes;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t v = s[(i % sub) * kLanes + i / sub];
      yr[i] = post != nullptr ? shoup_mul(v, post[limb], posts[limb], q) : v;
    }
  } else if (post != nullptr) {
    const uint32_t pv = post[limb], pvs = posts[limb];
    for (int i = threadIdx.x; i < n; i += blockDim.x) yr[i] = shoup_mul(s[i], pv, pvs, q);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) yr[i] = s[i];
  }
}

template <bool kInverse, bool kPerm = false>
int launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn, const uint32_t* tw,
           const uint32_t* tws, const uint32_t* q, const uint32_t* post, const uint32_t* posts,
           cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) << logn;
  cudaError_t err = cudaFuncSetAttribute(ntt32_kernel<kInverse, kPerm>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (1 << logn) / 2 < kThreads ? (1 << logn) / 2 : kThreads;
  ntt32_kernel<kInverse, kPerm><<<rows, threads, smem, stream>>>(x, y, limbs, logn, tw, tws, q,
                                                                 post, posts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward transform of `rows` rows; `post`/`posts` may be null (no epilogue)
// or per-limb (value, Shoup companion) multiplied into every output.
extern "C" int ntt32_fwd_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                const uint32_t* psi_rev, const uint32_t* psi_rev_shoup,
                                const uint32_t* q, const uint32_t* post, const uint32_t* posts,
                                void* stream) {
  return launch<false>(x, y, rows, limbs, logn, psi_rev, psi_rev_shoup, q, post, posts,
                       static_cast<cudaStream_t>(stream));
}

// Inverse transform; `ninv`/`ninvs` are the per-limb n^-1 and its companion.
extern "C" int ntt32_inv_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                const uint32_t* psi_inv_rev, const uint32_t* psi_inv_rev_shoup,
                                const uint32_t* q, const uint32_t* ninv, const uint32_t* ninvs,
                                void* stream) {
  return launch<true>(x, y, rows, limbs, logn, psi_inv_rev, psi_inv_rev_shoup, q, ninv, ninvs,
                      static_cast<cudaStream_t>(stream));
}

// The forward transform with its output stored in the perm layout (n % 128 == 0).
extern "C" int ntt32_fwd_perm_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                     const uint32_t* psi_rev, const uint32_t* psi_rev_shoup,
                                     const uint32_t* q, const uint32_t* post,
                                     const uint32_t* posts, void* stream) {
  return launch<false, true>(x, y, rows, limbs, logn, psi_rev, psi_rev_shoup, q, post, posts,
                             static_cast<cudaStream_t>(stream));
}

// The inverse transform with its input loaded from the perm layout (n % 128 == 0).
extern "C" int ntt32_inv_perm_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                     const uint32_t* psi_inv_rev,
                                     const uint32_t* psi_inv_rev_shoup, const uint32_t* q,
                                     const uint32_t* ninv, const uint32_t* ninvs, void* stream) {
  return launch<true, true>(x, y, rows, limbs, logn, psi_inv_rev, psi_inv_rev_shoup, q, ninv,
                            ninvs, static_cast<cudaStream_t>(stream));
}
