// Kernel B3: the hybrid key switch over 31-bit primes, without its NTTs.
//
// Replaces lattisense_tpu/ops/ksw_pallas32.py `ksw_switch32` (kernel
// `_ksw_kernel`, launch `_ksw_impl`): for a coefficient-domain x over Q_l it
// returns (e0, e1) over Q_l with e0 + e1*s ~ x*s'. The wrapper
// (ops/ksw_cuda.py) runs the whole switch as one sequence on one stream:
//   (a) ksw32_modup: digit decomposition (Shoup product by (Q_d/q_j)^-1 in
//       beta = ceil(L/alpha) digits of alpha limbs, a ragged last digit has
//       zero lanes) and per-digit FastBConv mod-up to Q_l u P, T = L + alpha
//       rows per digit;
//   (b) kernel B1 forward over the beta*T digit rows (row r takes limb r % T);
//   (c) ksw32_inner: gadget inner product with the Montgomery-form key,
//       both components;
//   (d) kernel B1 inverse over the 2*T rows;
//   (e) ksw32_moddown: RoundDivP, the exact mod-down Q_l u P -> Q_l with the
//       fixed-point overflow estimate v = (sum_j y_j * floor(2^62 / p_j)) >> 62
//       taken on a wrapping 64-bit sum, as the reference's u32 hi:lo pair;
//   (f) with output_ntt, kernel B1 forward over the result.
//
// What bounds it: every stage moves int64 rows through device memory
// against a few dozen 32-bit operations per residue, so bytes bound each of
// them. The TPU kernel keeps one ciphertext's ~48 rows (~3 MB at n = 16384)
// in VMEM between the stages; a block here holds three such rows at most,
// so the stages meet in device memory instead. Each per-coefficient kernel
// reads its inputs once and writes its outputs once, with every conversion
// constant in shared memory (Shoup pairs: each product gives the canonical
// residue, equal to the reference's). The key is read in place: digit d,
// component c, row t comes from key_q[d][c][t] for t < L and from
// key_p[d][c][t - L] otherwise, so no per-level copy is made.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxAlpha = 8;
constexpr int kThreads = 256;

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

// a*b*2^-32 mod q (Montgomery, pinv = -q^-1 mod 2^32), for a*b < q*2^32.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t q, uint32_t pinv) {
  const uint64_t prod = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(prod);
  const uint32_t m = lo * pinv;
  const uint32_t t = static_cast<uint32_t>(prod >> 32) + __umulhi(m, q) + (lo != 0);
  return t >= q ? t - q : t;
}

__device__ __forceinline__ void load_consts(uint32_t* c, const uint32_t* consts, int total) {
  for (int i = threadIdx.x; i < total; i += blockDim.x) c[i] = consts[i];
  __syncthreads();
}

// Constants (uint32), BA = beta * alpha digit lanes, lane r = d * alpha + j:
//   src q[BA], (Q_d/q_j)^-1 mod q_j [BA], its Shoup [BA]   (padded lanes: 1, 0, 0)
//   qp[T]
//   [Q_d/q_j]_{qp_t} at [r * T + t] (BA*T), then its Shoup companions (BA*T)
__global__ void __launch_bounds__(kThreads) ksw32_modup_kernel(
    const int64_t* __restrict__ x, int64_t* __restrict__ digits, int L, int alpha, int beta,
    int T, int n, const uint32_t* __restrict__ consts) {
  extern __shared__ uint32_t c[];
  const int BA = beta * alpha;
  load_consts(c, consts, 3 * BA + T + 2 * BA * T);
  const uint32_t* srcq = c;
  const uint32_t* qhi = c + BA;
  const uint32_t* qhis = c + 2 * BA;
  const uint32_t* qp = c + 3 * BA;
  const uint32_t* mv = qp + T;
  const uint32_t* ms = mv + BA * T;

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t g = blockIdx.y;
  const int64_t* xp = x + g * L * n + j;
  int64_t* out = digits + g * beta * T * n + j;

  for (int d = 0; d < beta; ++d) {
    uint32_t y[kMaxAlpha];
    for (int k = 0; k < alpha; ++k) {
      const int r = d * alpha + k;
      y[k] = r < L ? shoup_mul(static_cast<uint32_t>(xp[static_cast<size_t>(r) * n]), qhi[r],
                               qhis[r], srcq[r])
                   : 0u;
    }
    for (int t = 0; t < T; ++t) {
      const uint32_t q = qp[t];
      uint32_t acc = 0;
      for (int k = 0; k < alpha; ++k) {
        const int r = d * alpha + k;
        acc = add_mod(acc, shoup_mul(y[k], mv[r * T + t], ms[r * T + t], q), q);
      }
      out[static_cast<size_t>(d * T + t) * n] = acc;
    }
  }
}

// Constants: qp[T], pinv[T]. One thread per (coefficient, row t, ciphertext).
__global__ void __launch_bounds__(kThreads) ksw32_inner_kernel(
    const int64_t* __restrict__ digits, const int64_t* __restrict__ key_q,
    const int64_t* __restrict__ key_p, int64_t* __restrict__ acc_out, int L, int Lq, int alpha,
    int beta, int T, int n, const uint32_t* __restrict__ consts) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int t = blockIdx.y;
  const size_t g = blockIdx.z;
  const uint32_t q = consts[t], pinv = consts[T + t];
  const int64_t* dg = digits + g * beta * T * n + static_cast<size_t>(t) * n + j;
  for (int comp = 0; comp < 2; ++comp) {
    uint32_t acc = 0;
    for (int d = 0; d < beta; ++d) {
      const int64_t* kr =
          t < L ? key_q + (static_cast<size_t>(d * 2 + comp) * Lq + t) * n
                : key_p + (static_cast<size_t>(d * 2 + comp) * alpha + (t - L)) * n;
      acc = add_mod(acc,
                    mont_mul(static_cast<uint32_t>(dg[static_cast<size_t>(d) * T * n]),
                             static_cast<uint32_t>(kr[j]), q, pinv),
                    q);
    }
    acc_out[((g * 2 + comp) * T + t) * n + j] = acc;
  }
}

// Constants (uint32):
//   q[L], (P/2) mod q [L], P^-1 mod q [L], its Shoup [L]
//   p[alpha], (P/2) mod p [alpha], (P/p_j)^-1 mod p_j [alpha], its Shoup [alpha],
//   floor(2^62 / p_j) [alpha]
//   [P/p_j]_{q_i} at [j * L + i] (alpha*L), then its Shoup companions (alpha*L)
__global__ void __launch_bounds__(kThreads) ksw32_moddown_kernel(
    const int64_t* __restrict__ cin, int64_t* __restrict__ e, int L, int alpha, int T, int n,
    const uint32_t* __restrict__ consts) {
  extern __shared__ uint32_t c[];
  load_consts(c, consts, 4 * L + 5 * alpha + 2 * alpha * L);
  const uint32_t* q = c;
  const uint32_t* hq = c + L;
  const uint32_t* pi = c + 2 * L;
  const uint32_t* pis = c + 3 * L;
  const uint32_t* p = c + 4 * L;
  const uint32_t* hp = p + alpha;
  const uint32_t* rhi = p + 2 * alpha;
  const uint32_t* rhis = p + 3 * alpha;
  const uint32_t* fx = p + 4 * alpha;
  const uint32_t* cv = p + 5 * alpha;
  const uint32_t* cs = cv + alpha * L;

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t poly = blockIdx.y;  // ciphertext * 2 + component
  const int64_t* cp = cin + poly * T * n + j;
  int64_t* ep = e + poly * L * n + j;

  uint32_t y[kMaxAlpha];
  uint64_t over = 0;  // wraps mod 2^64, as the reference's 64-bit sum
  for (int k = 0; k < alpha; ++k) {
    const uint32_t xk = static_cast<uint32_t>(cp[static_cast<size_t>(L + k) * n]);
    y[k] = shoup_mul(add_mod(xk, hp[k], p[k]), rhi[k], rhis[k], p[k]);
    over += static_cast<uint64_t>(y[k]) * fx[k];
  }
  const uint32_t v = static_cast<uint32_t>(over >> 62);
  for (int i = 0; i < L; ++i) {
    const uint32_t qi = q[i];
    uint32_t conv = 0;
    for (int k = 0; k < alpha; ++k)
      conv = add_mod(conv, shoup_mul(y[k], cv[k * L + i], cs[k * L + i], qi), qi);
    const uint32_t xq = static_cast<uint32_t>(cp[static_cast<size_t>(i) * n]);
    const uint32_t num = sub_mod(add_mod(xq, hq[i], qi), conv, qi);
    ep[static_cast<size_t>(i) * n] = add_mod(shoup_mul(num, pi[i], pis[i], qi), v, qi);
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

extern "C" int ksw32_max_alpha() { return kMaxAlpha; }

// x: (G, L, n) int64 residues over Q_l; digits: (G, beta, T, n) int64 output.
extern "C" int ksw32_modup_launch(const int64_t* x, int64_t* digits, int G, int L, int alpha,
                                  int beta, int T, int n, const uint32_t* consts, void* stream) {
  if (alpha > kMaxAlpha) return static_cast<int>(cudaErrorInvalidValue);
  const int BA = beta * alpha;
  const size_t smem = sizeof(uint32_t) * (3 * BA + T + 2 * BA * T);
  int err = set_smem(reinterpret_cast<const void*>(ksw32_modup_kernel), smem);
  if (err != 0) return err;
  dim3 grid((n + kThreads - 1) / kThreads, G);
  ksw32_modup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, digits, L, alpha, beta, T, n, consts);
  return static_cast<int>(cudaGetLastError());
}

// digits: (G, beta, T, n) NTT domain; key_q (>=beta, 2, Lq, n), key_p (>=beta, 2, alpha, n)
// NTT + Montgomery; acc: (G, 2, T, n) output.
extern "C" int ksw32_inner_launch(const int64_t* digits, const int64_t* key_q,
                                  const int64_t* key_p, int64_t* acc, int G, int L, int Lq,
                                  int alpha, int beta, int T, int n, const uint32_t* consts,
                                  void* stream) {
  dim3 grid((n + kThreads - 1) / kThreads, T, G);
  ksw32_inner_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      digits, key_q, key_p, acc, L, Lq, alpha, beta, T, n, consts);
  return static_cast<int>(cudaGetLastError());
}

// cin: (G * 2, T, n) coefficient domain over Q_l u P; e: (G * 2, L, n) output over Q_l.
extern "C" int ksw32_moddown_launch(const int64_t* cin, int64_t* e, int polys, int L, int alpha,
                                    int T, int n, const uint32_t* consts, void* stream) {
  if (alpha > kMaxAlpha) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) * (4 * L + 5 * alpha + 2 * alpha * L);
  int err = set_smem(reinterpret_cast<const void*>(ksw32_moddown_kernel), smem);
  if (err != 0) return err;
  dim3 grid((n + kThreads - 1) / kThreads, polys);
  ksw32_moddown_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cin, e, L, alpha, T, n, consts);
  return static_cast<int>(cudaGetLastError());
}
