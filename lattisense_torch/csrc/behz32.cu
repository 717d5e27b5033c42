// Kernels B2 and B4 (the per-coefficient halves), one thread per coefficient
// of one polynomial.
//
// B2, first half: BEHZ exact extension Q -> B u {m_sk}.
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

// B4, second half: `scale_back`, BEHZ's scale by t/Q and exact conversion
// back to Q (lattisense_tpu/ops/behz_pallas32.py `behz_finish32`, kernel
// `_k3_kernel`, after its inverse NTTs). The wrapper first runs kernel B1's
// inverse NTT over the (..., L, n) and (..., T, n) tensor products with the
// from-Montgomery folded into the n^-1 epilogue; this kernel then reads the
// L + T residues of one coefficient and writes its L outputs:
//   [t X]_Q, FastBConv q -> aux, (t X_aux - conv) * Q^-1 on the aux basis,
//   Shenoy-Kumaresan B -> Q through the m_sk channel with the centred
//   correction.
// It does ~(L T + Tb (L + 1)) Shoup products per coefficient against
// 8 (2L + T) bytes moved: ~2.7 operations per byte at L = 8, T = 11, so
// bytes bound it. The L digits and the T aux values stay in per-thread arrays
// (runtime sizes: a local-memory stack frame, L1-cached), the constants in
// shared memory.
//
// Constant block (uint32), Tb = T - 1 (the B primes; aux row T-1 is m_sk):
//   q   7L  : q, t mod q, its Shoup, (Q/q_i)^-1 mod q_i, its Shoup, B mod q, its Shoup
//   aux 5T  : d, t mod d, its Shoup, Q^-1 mod d, its Shoup
//   conv1 2LT: [Q/q_i]_{d_t} at [i*T + t], then its Shoup companions
//   shen 2Tb: (B/b_k)^-1 mod b_k, its Shoup
//   conv2 2Tb(L+1): [B/b_k]_{q_i} at [k*(L+1) + i], i = L for m_sk, then Shoups
//   3       : B^-1 mod m_sk, its Shoup, m_sk >> 1

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 32;
constexpr int kMaxT = 40;
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

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
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

__host__ __device__ inline int scale_back_consts(int L, int T) {
  const int Tb = T - 1;
  return 7 * L + 5 * T + 2 * L * T + 2 * Tb + 2 * Tb * (L + 1) + 3;
}

__global__ void __launch_bounds__(kThreads) behz32_scale_back_kernel(
    const int64_t* __restrict__ xq, const int64_t* __restrict__ xa, int64_t* __restrict__ out,
    int L, int T, int n, const uint32_t* __restrict__ consts) {
  extern __shared__ uint32_t c[];
  const int Tb = T - 1;
  const int total = scale_back_consts(L, T);
  for (int i = threadIdx.x; i < total; i += blockDim.x) c[i] = consts[i];
  __syncthreads();

  const uint32_t* q = c;
  const uint32_t* tq = c + L;
  const uint32_t* tqs = c + 2 * L;
  const uint32_t* qhi = c + 3 * L;
  const uint32_t* qhis = c + 4 * L;
  const uint32_t* bq = c + 5 * L;
  const uint32_t* bqs = c + 6 * L;
  const uint32_t* d = c + 7 * L;
  const uint32_t* td = d + T;
  const uint32_t* tds = d + 2 * T;
  const uint32_t* qinv = d + 3 * T;
  const uint32_t* qinvs = d + 4 * T;
  const uint32_t* c1v = d + 5 * T;
  const uint32_t* c1s = c1v + L * T;
  const uint32_t* shi = c1s + L * T;
  const uint32_t* shis = shi + Tb;
  const uint32_t* c2v = shis + Tb;
  const uint32_t* c2s = c2v + Tb * (L + 1);
  const uint32_t* sc = c2s + Tb * (L + 1);
  const uint32_t msk = d[Tb], binv = sc[0], binvs = sc[1], msk_half = sc[2];

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t poly = blockIdx.y;
  const int64_t* qp = xq + poly * L * n + j;
  const int64_t* ap = xa + poly * T * n + j;

  // [t X]_Q, decomposed for the conversion to the aux basis
  uint32_t y[kMaxL];
  for (int i = 0; i < L; ++i) {
    const uint32_t u =
        shoup_mul(static_cast<uint32_t>(qp[static_cast<size_t>(i) * n]), tq[i], tqs[i], q[i]);
    y[i] = shoup_mul(u, qhi[i], qhis[i], q[i]);
  }
  // w = (t X_aux - conv) * Q^-1 on B u {m_sk}; the B rows then decomposed
  uint32_t w[kMaxT];
  for (int k = 0; k < T; ++k) {
    const uint32_t dk = d[k];
    uint32_t conv = 0;
    for (int i = 0; i < L; ++i)
      conv = add_mod(conv, shoup_mul(y[i], c1v[i * T + k], c1s[i * T + k], dk), dk);
    const uint32_t tx =
        shoup_mul(static_cast<uint32_t>(ap[static_cast<size_t>(k) * n]), td[k], tds[k], dk);
    w[k] = shoup_mul(sub_mod(tx, conv, dk), qinv[k], qinvs[k], dk);
    if (k < Tb) w[k] = shoup_mul(w[k], shi[k], shis[k], dk);
  }
  // Shenoy-Kumaresan: the m_sk channel gives the overflow alpha of the B -> Q
  // conversion, centred to allow slight negatives
  uint32_t conv_sk = 0;
  for (int k = 0; k < Tb; ++k)
    conv_sk = add_mod(conv_sk, shoup_mul(w[k], c2v[k * (L + 1) + L], c2s[k * (L + 1) + L], msk),
                      msk);
  const uint32_t alpha = shoup_mul(sub_mod(conv_sk, w[Tb], msk), binv, binvs, msk);
  int64_t* op = out + poly * L * n + j;
  for (int i = 0; i < L; ++i) {
    const uint32_t qi = q[i];
    uint32_t conv = 0;
    for (int k = 0; k < Tb; ++k)
      conv = add_mod(conv, shoup_mul(w[k], c2v[k * (L + 1) + i], c2s[k * (L + 1) + i], qi), qi);
    const uint32_t amod = alpha >= msk_half ? qi - (msk - alpha) : alpha;
    op[static_cast<size_t>(i) * n] = sub_mod(conv, shoup_mul(amod, bq[i], bqs[i], qi), qi);
  }
}

}  // namespace

extern "C" int behz32_max_limbs() { return kMaxL; }

extern "C" int behz32_max_aux() { return kMaxT; }

// xq: (polys, L, n), xa: (polys, T, n) coefficient-domain int64 residues over
// Q and B u {m_sk}; out: (polys, L, n) int64 output over Q.
extern "C" int behz32_scale_back_launch(const int64_t* xq, const int64_t* xa, int64_t* out,
                                        int polys, int L, int T, int n, const uint32_t* consts,
                                        void* stream) {
  if (L > kMaxL || T > kMaxT || T < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) * scale_back_consts(L, T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(behz32_scale_back_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((n + kThreads - 1) / kThreads, polys);
  behz32_scale_back_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xq, xa, out, L, T, n, consts);
  return static_cast<int>(cudaGetLastError());
}

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
