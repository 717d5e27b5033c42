// Kernel B2, first half: BEHZ exact extension Q -> B u {m_sk}, one thread per
// coefficient of one polynomial.
//
// Replaces the extension part of lattisense_tpu/ops/behz_pallas32.py
// `behz_prep32` (kernel `_k1_kernel`): x * m~ -> digit decomposition ->
// FastBConv to the aux basis -> the m~ channel -> SmMRq overflow removal.
// The wrapper (ops/behz_cuda.py) then runs kernel B1's forward NTT with the
// to-Montgomery epilogue over the q rows and over these aux rows, which
// completes behz_prep32's contract:
//   (to_mont(ntt(x, ring_q)), to_mont(ntt(ExactExtend(x), ring_aux))).
//
// What bounds it: each coefficient reads L int64 residues and writes T int64
// residues against ~(9 L + 12) T 32-bit operations; at L = 8, T = 11 that is
// ~1 000 operations per 152 bytes, 6.6 per byte, under the ~20 per byte at
// which the card's 32-bit peak meets its memory rate: bytes bound it, with
// the integer multiplies not far behind. The TPU kernel keeps all L + T rows of a
// polynomial in VMEM (~1.2 MB at n = 16384), which does not fit a block's
// 227 KB here; this design instead keeps the L decomposed digits of one
// coefficient in a per-thread array (L is a runtime value, so ptxas places
// it in a 128-byte stack frame in local memory, L1-cached, with no spills)
// and all conversion constants in shared memory, so the only device-memory
// traffic is one read of x and one write of the aux rows (which the NTT
// kernel reads back once).
//
// Constant block (uint32), loaded to shared memory by every block:
//   src  6L : q, m~ mod q, its Shoup, (Q/q_i)^-1 mod q_i, its Shoup, Q/q_i mod m~
//   dst  5T : d, Q mod d, its Shoup, m~^-1 mod d, its Shoup
//   conv 2LT: [Q/q_i]_{d_t} at [i*T + t], then its Shoup companions
//   1       : -Q^-1 mod m~

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 32;
constexpr int kThreads = 256;
constexpr uint32_t kMtilde = 1u << 16;

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w, uint32_t ws, uint32_t q) {
  uint32_t hi = __umulhi(a, ws);
  uint32_t r = a * w - hi * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__global__ void __launch_bounds__(kThreads) behz32_extend_kernel(
    const int64_t* __restrict__ x, int64_t* __restrict__ ext, int L, int T, int n,
    const uint32_t* __restrict__ consts) {
  extern __shared__ uint32_t c[];
  const int total = 6 * L + 5 * T + 2 * L * T + 1;
  for (int i = threadIdx.x; i < total; i += blockDim.x) c[i] = consts[i];
  __syncthreads();

  const uint32_t* q = c;
  const uint32_t* mt = c + L;
  const uint32_t* mts = c + 2 * L;
  const uint32_t* qhi = c + 3 * L;
  const uint32_t* qhis = c + 4 * L;
  const uint32_t* qmt = c + 5 * L;
  const uint32_t* d = c + 6 * L;
  const uint32_t* qm = d + T;
  const uint32_t* qms = d + 2 * T;
  const uint32_t* mti = d + 3 * T;
  const uint32_t* mtis = d + 4 * T;
  const uint32_t* cv = d + 5 * T;
  const uint32_t* cs = cv + L * T;
  const uint32_t neg_qinv = cs[L * T];

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t poly = blockIdx.y;
  const int64_t* xp = x + poly * L * n + j;

  uint32_t y[kMaxL];
  uint32_t emt = 0;  // m~ channel: wraps mod 2^32, exact mod m~ = 2^16
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    const uint32_t xm = shoup_mul(static_cast<uint32_t>(xp[static_cast<size_t>(i) * n]), mt[i],
                                  mts[i], q[i]);
    y[i] = shoup_mul(xm, qhi[i], qhis[i], q[i]);
    emt += (y[i] & (kMtilde - 1)) * qmt[i];
  }
  emt &= kMtilde - 1;
  const uint32_t r = (emt * neg_qinv) & (kMtilde - 1);

  int64_t* ep = ext + poly * T * n + j;
  for (int t = 0; t < T; ++t) {
    const uint32_t dt = d[t];
    uint32_t acc = 0;
#pragma unroll 4
    for (int i = 0; i < L; ++i) acc = add_mod(acc, shoup_mul(y[i], cv[i * T + t], cs[i * T + t], dt), dt);
    const uint32_t r_mod = r >= kMtilde / 2 ? dt - (kMtilde - r) : r;
    const uint32_t s = add_mod(acc, shoup_mul(r_mod, qm[t], qms[t], dt), dt);
    ep[static_cast<size_t>(t) * n] = shoup_mul(s, mti[t], mtis[t], dt);
  }
}

}  // namespace

extern "C" int behz32_max_limbs() { return kMaxL; }

// x: (polys, L, n) int64 residues mod q; ext: (polys, T, n) int64 output.
extern "C" int behz32_extend_launch(const int64_t* x, int64_t* ext, int polys, int L, int T, int n,
                                    const uint32_t* consts, void* stream) {
  if (L > kMaxL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) * (6 * L + 5 * T + 2 * L * T + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        behz32_extend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((n + kThreads - 1) / kThreads, polys);
  behz32_extend_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, ext, L, T,
                                                                                   n, consts);
  return static_cast<int>(cudaGetLastError());
}
