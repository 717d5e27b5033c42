// Kernel B3: the hybrid key switch over 31-bit primes.
//
// Replaces lattisense_tpu/ops/ksw_pallas32.py `ksw_switch32` (kernel
// `_ksw_kernel`, launch `_ksw_impl`): for a coefficient-domain x over Q_l it
// returns (e0, e1) over Q_l with e0 + e1*s ~ x*s':
//   digit decomposition (Shoup product by (Q_d/q_j)^-1 in beta =
//   ceil(L/alpha) digits of alpha limbs, a ragged last digit has zero
//   lanes), per-digit FastBConv mod-up to Q_l u P (T = L + alpha rows), the
//   forward NTT of every digit row, the gadget inner product with the
//   Montgomery-form key (both components), the inverse NTT of both
//   components, and RoundDivP, the exact mod-down Q_l u P -> Q_l with the
//   fixed-point overflow estimate v = (sum_j y_j * floor(2^62 / p_j)) >> 62
//   taken on a wrapping 64-bit sum, as the reference's u32 hi:lo pair; with
//   output_ntt the wrapper adds kernel B1's forward over the result.
//
// What bounds it: x, the key and (e0, e1) cross device memory once, ~110 MB
// at the main path's shapes (B = 32, L = 8, alpha = 4, beta = 2, T = 12,
// n = 16384), against ~3.5 G 32-bit operations, most of them the NTTs'
// butterflies: the operations bound it (0.052 ms at the float32 rate). The
// TPU kernel keeps one ciphertext's ~48 rows in VMEM between the stages. Here
// the gadget inner product is local to a row: row t of the result needs only
// row t of each digit and of the key. So the fused route runs one block per
// (ciphertext, row t) that builds digit d's row t from x's alpha limbs in
// the registers of the forward's first window (x, 1 MB a ciphertext, stays
// in L2 across its T row blocks), transforms it with the passes of
// csrc/ntt_passes.cuh, multiplies it with the key read in place at the
// elements the registers hold and accumulates both components in shared
// memory (canonical 32-bit residues at their parking slots), and after the
// last digit inverse-transforms each component through its own accumulator
// row. Nothing of that reaches device memory until the inverse's output,
// which leaves as 32-bit residues, (G, 2, T, n): the mod-down is the only
// step across rows, and one per-coefficient kernel does it, reading that
// intermediate once and writing (e0, e1). Measured on the H100 at the main
// path's shapes: 0.30 ms, 17 % of the bound, against 0.43 ms for the split
// route below; the block, one an SM, leaves its loads exposed between its
// transforms. The key is read in place: digit d,
// component c, row t comes from key_q[d][c][t] for t < L and from
// key_p[d][c][t - L] otherwise, so no per-level copy is made.
//
// n = 2^15 and 2^16, whose three 32-bit rows do not fit a block's shared
// memory, take the split route: a mod-up kernel, kernel B1's forward over the
// beta * T digit rows, an inner-product kernel, B1's inverse over the 2 * T
// rows and the mod-down kernel, meeting in device memory as int64 stacks (at
// 2^16 B1 runs its own split, csrc/ntt_columns.cuh). The three kernels index
// a polynomial in size_t: at n = 2^16, T = 52 and beta = 12 one
// ciphertext's digit stack holds 4.1e7 residues, and a batch of 32 holds
// 1.3e9, near 2^31.
// The wrapper (ops/ksw_cuda.py `switch_route`) chooses by shape. Per-thread
// arrays are indexed by alpha, a template parameter, so they stay in
// registers.

#include "row_fusion.cuh"

namespace {

using fused::add_mod;
using fused::mont_mul;
using fused::shoup_mul;
using fused::sub_mod;

constexpr int kMaxAlpha = 8;
constexpr int kMaxFusedLogn = 14;
constexpr int kThreads = 256;

__device__ __forceinline__ void load_consts(uint32_t* c, const uint32_t* consts, int total) {
  for (int i = threadIdx.x; i < total; i += blockDim.x) c[i] = consts[i];
  __syncthreads();
}

// Constants (uint32), BA = beta * alpha digit lanes, lane r = d * alpha + j:
//   src q[BA], (Q_d/q_j)^-1 mod q_j [BA], its Shoup [BA]   (padded lanes: 1, 0, 0)
//   qp[T]
//   [Q_d/q_j]_{qp_t} at [r * T + t] (BA*T), then its Shoup companions (BA*T)
template <int ALPHA>
__global__ void __launch_bounds__(kThreads) ksw32_modup_kernel(
    const int64_t* __restrict__ x, int64_t* __restrict__ digits, int L, int beta, int T, int n,
    const uint32_t* __restrict__ consts) {
  extern __shared__ uint32_t c[];
  const int BA = beta * ALPHA;
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
    uint32_t y[ALPHA];
#pragma unroll
    for (int k = 0; k < ALPHA; ++k) {
      const int r = d * ALPHA + k;
      y[k] = r < L ? shoup_mul(static_cast<uint32_t>(xp[static_cast<size_t>(r) * n]), qhi[r],
                               qhis[r], srcq[r])
                   : 0u;
    }
    for (int t = 0; t < T; ++t) {
      const uint32_t q = qp[t];
      uint32_t acc = 0;
#pragma unroll
      for (int k = 0; k < ALPHA; ++k) {
        const int r = d * ALPHA + k;
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

// The fused route: one block per (ciphertext g, row t), blockIdx.x = g * T + t.
// Shared memory: the forward's exchange buffer, then the two components'
// accumulators, one 32-bit row each. `modup` is the mod-up kernel's constant
// block, `inner` the inner-product kernel's; `fwd`, `inv`, `ninv`, `ninvs`
// kernel B1's pass tables and n^-1 of the ring Q_l u P.
template <int LOGN>
__global__ void __launch_bounds__(ntt::row_threads(LOGN)) ksw32_rows_kernel(
    const int64_t* __restrict__ x, const int64_t* __restrict__ key_q,
    const int64_t* __restrict__ key_p, uint32_t* __restrict__ cout, int L, int Lq, int alpha,
    int beta, int T, const unsigned char* __restrict__ fwd, const unsigned char* __restrict__ inv,
    const uint32_t* __restrict__ ninv, const uint32_t* __restrict__ ninvs,
    const uint32_t* __restrict__ modup, const uint32_t* __restrict__ inner) {
  using ntt::W32;
  constexpr int N = 1 << LOGN, K = ntt::reg_bits(LOGN), E = 1 << K;
  constexpr int TOP = ntt::window_lo(LOGN, 0);
  constexpr size_t kTable = static_cast<size_t>(ntt::table_entries(LOGN)) * W32::kEntryBytes;
  const int t = blockIdx.x % T;
  const size_t g = blockIdx.x / T;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* xb = reinterpret_cast<uint32_t*>(smem);
  uint32_t* acc = xb + N;
  const int BA = beta * alpha;
  const uint32_t* srcq = modup;
  const uint32_t* qhi = modup + BA;
  const uint32_t* qhis = modup + 2 * BA;
  const uint32_t* mv = modup + 3 * BA + T;
  const uint32_t* ms = mv + BA * T;
  const uint32_t q = inner[t], pinv = inner[T + t];
  const int64_t* xg = x + g * L * N;

  for (int d = 0; d < beta; ++d) {
    if (d > 0) __syncthreads();   // the last digit's exchanges are read
    // mod-up: digit d's row t at the elements of the forward's first window,
    // one limb of x at a time, its E reads issued together
    uint32_t a[E];
    const int lane = ntt::lane_id();
#pragma unroll
    for (int i = 0; i < E; ++i) a[i] = 0;
    for (int r = d * alpha; r < L && r < (d + 1) * alpha; ++r) {
      const int64_t* xr = xg + static_cast<size_t>(r) * N;
      uint32_t xv[E];
#pragma unroll
      for (int i = 0; i < E; ++i) xv[i] = static_cast<uint32_t>(xr[ntt::element<TOP, K>(lane, i)]);
      const uint32_t h = qhi[r], hs = qhis[r], qr = srcq[r], m = mv[r * T + t], mss = ms[r * T + t];
#pragma unroll
      for (int i = 0; i < E; ++i) a[i] = add_mod(a[i], shoup_mul(shoup_mul(xv[i], h, hs, qr), m, mss, q), q);
    }
    ntt::passes<W32, LOGN, false>(a, xb, fwd + t * kTable, q);
    // the gadget product at the chunk window's elements, which the thread
    // holds as E consecutive ones: key read in place, 16 bytes a load, all
    // of a component's reads issued before its products
    const int base = ntt::element<0, K>(ntt::lane_id(), 0);
#pragma unroll
    for (int i = 0; i < E; ++i) a[i] = W32::canon(a[i], q);
    for (int comp = 0; comp < 2; ++comp) {
      const int64_t* kr =
          t < L ? key_q + (static_cast<size_t>(d * 2 + comp) * Lq + t) * N
                : key_p + (static_cast<size_t>(d * 2 + comp) * alpha + (t - L)) * N;
      uint32_t kv[E];
#pragma unroll
      for (int i = 0; i < E; i += 2) {
        const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(kr + (base | i)));
        kv[i] = static_cast<uint32_t>(v.x);
        kv[i + 1] = static_cast<uint32_t>(v.y);
      }
      uint32_t* ac = acc + comp * N;
      const int from = fused::parked_slot(base);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const uint32_t v = mont_mul(a[i], kv[i], q, pinv);
        const int s = from ^ fused::parked_slot(i);
        ac[s] = d == 0 ? v : add_mod(ac[s], v, q);
      }
    }
  }
  // the inverse of each component through its own accumulator row, whose
  // slots each thread filled for the elements it now reads back
  for (int comp = 0; comp < 2; ++comp) {
    uint32_t* ac = acc + comp * N;
    uint32_t a[E];
    fused::unpark<LOGN, 0>(a, ac);
    ntt::passes<W32, LOGN, true>(a, ac, inv + t * kTable, q);
    ntt::epilogue<W32>(a, q, true, ninv[t], ninvs[t]);
    uint32_t* orow = cout + ((g * 2 + comp) * T + t) * N;
    const int lane = ntt::lane_id();
#pragma unroll
    for (int i = 0; i < E; ++i) orow[ntt::element<TOP, K>(lane, i)] = a[i];
  }
}

// Constants (uint32):
//   q[L], (P/2) mod q [L], P^-1 mod q [L], its Shoup [L]
//   p[alpha], (P/2) mod p [alpha], (P/p_j)^-1 mod p_j [alpha], its Shoup [alpha],
//   floor(2^62 / p_j) [alpha]
//   [P/p_j]_{q_i} at [j * L + i] (alpha*L), then its Shoup companions (alpha*L)
// `In` is the word of the coefficient-domain input over Q_l u P: int64
// (the split route) or uint32 (the fused route's intermediate).
template <class In, int ALPHA>
__global__ void __launch_bounds__(kThreads) ksw32_moddown_kernel(
    const In* __restrict__ cin, int64_t* __restrict__ e, int L, int T, int n,
    const uint32_t* __restrict__ consts) {
  extern __shared__ uint32_t c[];
  load_consts(c, consts, 4 * L + 5 * ALPHA + 2 * ALPHA * L);
  const uint32_t* q = c;
  const uint32_t* hq = c + L;
  const uint32_t* pi = c + 2 * L;
  const uint32_t* pis = c + 3 * L;
  const uint32_t* p = c + 4 * L;
  const uint32_t* hp = p + ALPHA;
  const uint32_t* rhi = p + 2 * ALPHA;
  const uint32_t* rhis = p + 3 * ALPHA;
  const uint32_t* fx = p + 4 * ALPHA;
  const uint32_t* cv = p + 5 * ALPHA;
  const uint32_t* cs = cv + ALPHA * L;

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t poly = blockIdx.y;  // ciphertext * 2 + component
  const In* cp = cin + poly * T * n + j;
  int64_t* ep = e + poly * L * n + j;

  uint32_t y[ALPHA];
  uint64_t over = 0;  // wraps mod 2^64, as the reference's 64-bit sum
#pragma unroll
  for (int k = 0; k < ALPHA; ++k) {
    const uint32_t xk = static_cast<uint32_t>(cp[static_cast<size_t>(L + k) * n]);
    y[k] = shoup_mul(add_mod(xk, hp[k], p[k]), rhi[k], rhis[k], p[k]);
    over += static_cast<uint64_t>(y[k]) * fx[k];
  }
  const uint32_t v = static_cast<uint32_t>(over >> 62);
  for (int i = 0; i < L; ++i) {
    const uint32_t qi = q[i];
    uint32_t conv = 0;
#pragma unroll
    for (int k = 0; k < ALPHA; ++k)
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

template <class In>
int moddown(const In* cin, int64_t* e, int polys, int L, int alpha, int T, int n,
            const uint32_t* consts, void* stream) {
  const size_t smem = sizeof(uint32_t) * (4 * L + 5 * alpha + 2 * alpha * L);
  return fused::by_value<kMaxAlpha>(alpha, [&](auto size) -> int {
    constexpr int ALPHA = decltype(size)::value;
    int err = set_smem(reinterpret_cast<const void*>(ksw32_moddown_kernel<In, ALPHA>), smem);
    if (err != 0) return err;
    dim3 grid((n + kThreads - 1) / kThreads, polys);
    ksw32_moddown_kernel<In, ALPHA><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        cin, e, L, T, n, consts);
    return static_cast<int>(cudaGetLastError());
  });
}

constexpr int rows_smem(int logn) { return 12 << logn; }

}  // namespace

extern "C" int ksw32_max_alpha() { return kMaxAlpha; }

// x: (G, L, n) int64 residues over Q_l; digits: (G, beta, T, n) int64 output.
extern "C" int ksw32_modup_launch(const int64_t* x, int64_t* digits, int G, int L, int alpha,
                                  int beta, int T, int n, const uint32_t* consts, void* stream) {
  const int BA = beta * alpha;
  const size_t smem = sizeof(uint32_t) * (3 * BA + T + 2 * BA * T);
  return fused::by_value<kMaxAlpha>(alpha, [&](auto size) -> int {
    constexpr int ALPHA = decltype(size)::value;
    int err = set_smem(reinterpret_cast<const void*>(ksw32_modup_kernel<ALPHA>), smem);
    if (err != 0) return err;
    dim3 grid((n + kThreads - 1) / kThreads, G);
    ksw32_modup_kernel<ALPHA><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        x, digits, L, beta, T, n, consts);
    return static_cast<int>(cudaGetLastError());
  });
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
  return moddown(cin, e, polys, L, alpha, T, n, consts, stream);
}

// The same on the fused route's 32-bit intermediate.
extern "C" int ksw32_moddown32_launch(const uint32_t* cin, int64_t* e, int polys, int L,
                                      int alpha, int T, int n, const uint32_t* consts,
                                      void* stream) {
  return moddown(cin, e, polys, L, alpha, T, n, consts, stream);
}

// The fused route up to the mod-down: x (G, L, n) int64 over Q_l, the key
// in place (16-byte aligned), into cout (G, 2, T, n) uint32, the
// coefficient-domain product of both components over Q_l u P.
extern "C" int ksw32_rows_launch(const int64_t* x, const int64_t* key_q, const int64_t* key_p,
                                 uint32_t* cout, int G, int L, int Lq, int alpha, int beta, int T,
                                 int logn, const void* fwd, const void* inv, const void* ninv,
                                 const void* ninvs, const uint32_t* modup, const uint32_t* inner,
                                 void* stream) {
  if (alpha > kMaxAlpha || logn > kMaxFusedLogn || rows_smem(logn) > ntt::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  return ntt::by_logn<kMaxFusedLogn>(logn, [&](auto size) -> int {
    constexpr int LOGN = decltype(size)::value;
    static int allowed[fused::kMaxDevices] = {};
    int err = fused::allow_smem(ksw32_rows_kernel<LOGN>, rows_smem(LOGN), allowed);
    if (err != 0) return err;
    ksw32_rows_kernel<LOGN><<<G * T, ntt::row_threads(LOGN), rows_smem(LOGN),
                              static_cast<cudaStream_t>(stream)>>>(
        x, key_q, key_p, cout, L, Lq, alpha, beta, T, static_cast<const unsigned char*>(fwd),
        static_cast<const unsigned char*>(inv), static_cast<const uint32_t*>(ninv),
        static_cast<const uint32_t*>(ninvs), modup, inner);
    return static_cast<int>(cudaGetLastError());
  });
}

// Blocks of the fused kernel an SM holds at 2^logn, or minus a cudaError_t.
extern "C" int ksw32_rows_blocks_per_sm(int logn) {
  if (logn > kMaxFusedLogn) return -static_cast<int>(cudaErrorInvalidValue);
  return ntt::by_logn<kMaxFusedLogn>(logn, [&](auto size) -> int {
    constexpr int LOGN = decltype(size)::value;
    static int allowed[fused::kMaxDevices] = {};
    int err = fused::allow_smem(ksw32_rows_kernel<LOGN>, rows_smem(LOGN), allowed);
    if (err != 0) return -err;
    int per_sm = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ksw32_rows_kernel<LOGN>, ntt::row_threads(LOGN), rows_smem(LOGN)));
    return err != 0 ? -err : per_sm;
  });
}
