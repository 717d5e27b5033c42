// Kernel B6: the 64-bit-word fast base conversion sum (FastBConv).
//
// Replaces lattisense_tpu/ops/bconv_pallas.py `bconv_convert_fused` and
// `bconv_raw_fused` (kernel `_bconv_kernel`, launch `_launch`):
//
//   out[r, t, i] = sum_l mont_mul(y[r, l, i], C[g, t, l]) mod d_t,  g = r % groups,
//
// with mont_mul(a, b) = a * b * 2^-64 mod d_t (REDC, pinv_t = -d_t^-1 mod 2^64),
// the sum folded with modular adds, so every output is the canonical residue
// and bit-identical to lattisense_tpu/core/rns.py `BasisConv.convert`. One
// constant group (groups = 1) is a BasisConv; `groups` = beta is the key
// switch's grouped mod-up of all beta digits in one launch, row r of the
// (..., beta, alpha, n) digit stack taking digit r % beta's constants.
//
// What bounds it: each output residue costs L Montgomery products (two
// 64x64->128 products and one 64x64 low product each) against 8 bytes
// written, and each source residue is read once for T outputs; at the
// path's shapes (L <= 5, T <= 6) that is ~20-40 32-bit operations per byte,
// near the card's balance point, first bound by bytes. The design is one
// thread per (row, coefficient): the thread reads its L source residues once
// into registers and writes all T outputs, so neighbouring threads read and
// write neighbouring coefficients (coalesced). The (groups, T, L) constants
// and the T moduli and pinv (a few hundred bytes) sit in shared memory.
//
// Residues and constants are int64 tensors on the Python side, read here as
// the same 64-bit patterns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSrc = 32;           // L: source limbs held per thread
constexpr int kMaxConstWords = 6144;  // groups * T * L + 2 * T, 48 KB of shared memory

__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b, uint64_t q, uint64_t pinv) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t m = lo * pinv;
  const uint64_t t = hi + __umul64hi(m, q) + (lo != 0 ? 1 : 0);
  return t >= q ? t - q : t;
}

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b, uint64_t q) {
  const uint64_t s = a + b;
  return s >= q ? s - q : s;
}

__global__ void __launch_bounds__(kThreads) bconv64_kernel(
    const uint64_t* __restrict__ y, uint64_t* __restrict__ out, int rows, int groups, int L,
    int T, int n, const uint64_t* __restrict__ C, const uint64_t* __restrict__ dq,
    const uint64_t* __restrict__ dpinv) {
  extern __shared__ uint64_t sh[];
  const int nc = groups * T * L;
  uint64_t* sc = sh;
  uint64_t* sq = sh + nc;
  uint64_t* sp = sq + T;
  for (int i = threadIdx.x; i < nc; i += blockDim.x) sc[i] = C[i];
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    sq[i] = dq[i];
    sp[i] = dpinv[i];
  }
  __syncthreads();

  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(rows) * n) return;
  const size_t row = idx / n;
  const int i = static_cast<int>(idx % n);
  const uint64_t* yr = y + row * L * n + i;
  uint64_t v[kMaxSrc];
  for (int l = 0; l < L; ++l) v[l] = yr[static_cast<size_t>(l) * n];
  const uint64_t* cg = sc + static_cast<size_t>(row % groups) * T * L;
  uint64_t* o = out + row * T * n + i;
  for (int t = 0; t < T; ++t) {
    const uint64_t q = sq[t], pinv = sp[t];
    const uint64_t* ct = cg + t * L;
    uint64_t acc = mont_mul(v[0], ct[0], q, pinv);
    for (int l = 1; l < L; ++l) acc = add_mod(acc, mont_mul(v[l], ct[l], q, pinv), q);
    o[static_cast<size_t>(t) * n] = acc;
  }
}

}  // namespace

extern "C" int bconv64_max_src() { return kMaxSrc; }
extern "C" int bconv64_max_const_words() { return kMaxConstWords; }

// out (rows, T, n) from y (rows, L, n); C (groups, T, L) Montgomery constants,
// dq / dpinv the T destination moduli and -d^-1 mod 2^64.
extern "C" int bconv64_launch(const uint64_t* y, uint64_t* out, int rows, int groups, int L,
                              int T, int n, const uint64_t* C, const uint64_t* dq,
                              const uint64_t* dpinv, void* stream) {
  if (L < 1 || L > kMaxSrc || T < 1 || groups < 1 || groups * T * L + 2 * T > kMaxConstWords)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(rows) * n;
  if (total == 0) return 0;
  const size_t smem = sizeof(uint64_t) * (groups * T * L + 2 * T);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  bconv64_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, out, rows, groups, L, T, n, C, dq, dpinv);
  return static_cast<int>(cudaGetLastError());
}
