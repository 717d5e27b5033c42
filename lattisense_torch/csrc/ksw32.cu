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
// path's shapes: 0.30 ms, 17 % of the bound; the block, one an SM, leaves
// its loads exposed between its transforms. The key is read in place:
// digit d, component c, row t comes from key_q[d][c][t] for t < L and from
// key_p[d][c][t - L] otherwise, so no per-level copy is made.
//
// n = 2^15 and 2^16, whose three 32-bit rows (384 or 768 KB) do not fit a
// block's shared memory, take the cluster route: the fused route's row
// spread over a thread-block cluster of C = 2^k blocks, block s owning
// sub-row s (2^logs elements, logs = ntt::kSubLogn = 13, k = log2 n - logs:
// 4 blocks at 2^15, 8 at 2^16, 96 KB of shared memory each) of the digit
// row and of both accumulators, the cross stages of csrc/ntt_cluster.cuh
// between them. For each digit each block builds the cells of its columns
// (the C cells c + r 2^logs of each, straight from x's limbs, the mod-up in
// registers), runs the k cross stages on them and scatters them to their
// owners through distributed shared memory; after a cluster barrier each
// block runs the row passes on its sub-row with the virtual-limb tables
// (ops/ntt_cuda.py `split_pass_tables`) and takes the gadget product with
// the key read in place, accumulating both components at their parking
// slots. A barrier before each scatter keeps a block's exchange buffer
// until its owner has read it. After the last digit each component's
// inverse runs the row passes, parks, crosses the cluster and applies
// n^-1, and the product leaves as 32-bit residues into the same mod-down
// kernel. So the digit and product stacks never reach device memory (at
// n = 2^16, T = 52, beta = 12 a digit stack is about 0.33 GB a ciphertext
// as int64). What bounds it is the fused route's: the operations; the
// cluster adds one crossing of distributed shared memory each way a digit
// and component. The kernels index a polynomial in size_t. The wrapper
// (ops/ksw_cuda.py `switch_route`) chooses by shape.
// Per-thread arrays are indexed by alpha, a template parameter, or by
// compile-time sizes, so they stay in registers.

#include "ntt_cluster.cuh"
#include "row_fusion.cuh"

namespace {

namespace cg = cooperative_groups;
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

// The fused route: one block per (ciphertext g, row t), blockIdx.x = g * T + t.
// Shared memory: the forward's exchange buffer, then the two components'
// accumulators, one 32-bit row each. `fwd`, `inv`, `ninv`, `ninvs` are
// kernel B1's pass tables and n^-1 of the ring Q_l u P. Constant blocks
// (uint32), BA = beta * alpha digit lanes, lane r = d * alpha + j:
//   modup: src q[BA], (Q_d/q_j)^-1 mod q_j [BA], its Shoup [BA] (padded
//          lanes: 1, 0, 0), qp[T], [Q_d/q_j]_{qp_t} at [r * T + t] (BA*T),
//          then its Shoup companions (BA*T)
//   inner: qp[T], -qp^-1 mod 2^32 [T]
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

// The cluster route: one cluster of C = 2^K blocks per (ciphertext g, row
// t), cluster blockIdx.x / C = g * T + t, block s (its rank) owning sub-row s
// of 2^LOGS elements. Shared memory a block: its exchange buffer, then the
// two components' accumulators, one 32-bit sub-row each. `fwd`, `inv` are
// kernel B1's pass tables over the virtual limbs of Q_l u P at depth K
// (T * C, entries, 2), `cfwd`, `cinv` its column tables (T, C, 2), `ninv`,
// `ninvs` n^-1 per virtual limb; `modup`, `inner` the fused route's blocks.
template <int LOGS, int K>
__global__ void __launch_bounds__(ntt::row_threads(LOGS)) ksw32_cluster_kernel(
    const int64_t* __restrict__ x, const int64_t* __restrict__ key_q,
    const int64_t* __restrict__ key_p, uint32_t* __restrict__ cout, int L, int Lq, int alpha,
    int beta, int T, const unsigned char* __restrict__ fwd, const unsigned char* __restrict__ inv,
    const uint32_t* __restrict__ cfwd, const uint32_t* __restrict__ cinv,
    const uint32_t* __restrict__ ninv, const uint32_t* __restrict__ ninvs,
    const uint32_t* __restrict__ modup, const uint32_t* __restrict__ inner) {
  using ntt::W32;
  constexpr int C = 1 << K, SUB = 1 << LOGS, KR = ntt::reg_bits(LOGS), E = 1 << KR;
  constexpr int COLS = E / C;
  constexpr size_t N = static_cast<size_t>(SUB) << K;
  constexpr size_t kTable = static_cast<size_t>(ntt::table_entries(LOGS)) * W32::kEntryBytes;
  static_assert(K >= 1 && C <= E, "a thread takes whole columns");
  cg::cluster_group cluster = cg::this_cluster();
  const int s = static_cast<int>(cluster.block_rank());
  const size_t cl = blockIdx.x / C;
  const int t = static_cast<int>(cl % static_cast<size_t>(T));
  const size_t g = cl / static_cast<size_t>(T);
  const int vlimb = t * C + s;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* xb = reinterpret_cast<uint32_t*>(smem);
  uint32_t* acc = xb + SUB;
  const int BA = beta * alpha;
  const uint32_t* srcq = modup;
  const uint32_t* qhi = modup + BA;
  const uint32_t* qhis = modup + 2 * BA;
  const uint32_t* mv = modup + 3 * BA + T;
  const uint32_t* ms = mv + BA * T;
  const uint32_t q = inner[t], pinv = inner[T + t];
  const int64_t* xg = x + g * L * N;
  const unsigned char* tf = fwd + static_cast<size_t>(vlimb) * kTable;
  const unsigned char* ti = inv + static_cast<size_t>(vlimb) * kTable;
  uint32_t a[E];
  ntt::cluster_arrive_relaxed();

  for (int d = 0; d < beta; ++d) {
    // mod-up: the C cells of each of the thread's columns of digit d's row
    // t, one limb of x at a time, its E reads (a warp's on consecutive
    // addresses) issued together
#pragma unroll
    for (int i = 0; i < E; ++i) a[i] = 0;
    for (int r = d * alpha; r < L && r < (d + 1) * alpha; ++r) {
      const int64_t* xr = xg + static_cast<size_t>(r) * N;
      uint32_t xv[E];
#pragma unroll
      for (int j = 0; j < COLS; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c)
          xv[j * C + c] = static_cast<uint32_t>(
              xr[static_cast<size_t>(c) * SUB + ntt::cluster_column<LOGS, K>(s, j)]);
      const uint32_t h = qhi[r], hs = qhis[r], qr = srcq[r], m = mv[r * T + t], mss = ms[r * T + t];
#pragma unroll
      for (int i = 0; i < E; ++i) a[i] = add_mod(a[i], shoup_mul(shoup_mul(xv[i], h, hs, qr), m, mss, q), q);
    }
    ntt::column_stages<W32, K, COLS, false>(a, cfwd + static_cast<size_t>(t) * 2 * C, q);
    if (d == 0)
      ntt::cluster_wait();       // every block of the cluster has started
    else
      cluster.sync();            // every block has read its buffer for the last digit
    ntt::scatter_cells<W32, LOGS, K>(cluster, a, xb, s);
    cluster.sync();              // every cell has landed in its owner's buffer
    ntt::take_top<W32, LOGS>(a, xb);
    ntt::passes<W32, LOGS, false>(a, xb, tf, q);
    // the gadget product at the chunk window's elements, E consecutive ones
    // of the sub-row: key read in place, 16 bytes a load
    const int base = ntt::element<0, KR>(ntt::lane_id(), 0);
#pragma unroll
    for (int i = 0; i < E; ++i) a[i] = W32::canon(a[i], q);
    for (int comp = 0; comp < 2; ++comp) {
      const int64_t* kr =
          (t < L ? key_q + (static_cast<size_t>(d * 2 + comp) * Lq + t) * N
                 : key_p + (static_cast<size_t>(d * 2 + comp) * alpha + (t - L)) * N) +
          static_cast<size_t>(s) * SUB;
      uint32_t kv[E];
#pragma unroll
      for (int i = 0; i < E; i += 2) {
        const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(kr + (base | i)));
        kv[i] = static_cast<uint32_t>(v.x);
        kv[i + 1] = static_cast<uint32_t>(v.y);
      }
      uint32_t* ac = acc + comp * SUB;
      const int from = fused::parked_slot(base);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const uint32_t v = mont_mul(a[i], kv[i], q, pinv);
        const int sl = from ^ fused::parked_slot(i);
        ac[sl] = d == 0 ? v : add_mod(ac[sl], v, q);
      }
    }
  }
  // each component's inverse row passes through its own accumulator, whose
  // slots each thread filled for the elements it now reads back; the last
  // window parks where the thread read it
  for (int comp = 0; comp < 2; ++comp) {
    uint32_t* ac = acc + comp * SUB;
    fused::unpark<LOGS, 0>(a, ac);
    ntt::passes<W32, LOGS, true>(a, ac, ti, q);
    ntt::park_top<W32, LOGS>(a, ac);
  }
  cluster.sync();   // both components' last windows are parked in every block
  for (int comp = 0; comp < 2; ++comp) {
    ntt::gather_cells<W32, LOGS, K>(cluster, a, acc + comp * SUB, s);
    ntt::column_stages<W32, K, COLS, true>(a, cinv + static_cast<size_t>(t) * 2 * C, q);
    ntt::epilogue<W32>(a, q, true, ninv[vlimb], ninvs[vlimb]);
    uint32_t* orow = cout + ((g * 2 + comp) * T + t) * N;
#pragma unroll
    for (int j = 0; j < COLS; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c)
        orow[static_cast<size_t>(c) * SUB + ntt::cluster_column<LOGS, K>(s, j)] = a[j * C + c];
  }
  cluster.sync();   // no block leaves while another still reads its accumulators
}

// Constants (uint32):
//   q[L], (P/2) mod q [L], P^-1 mod q [L], its Shoup [L]
//   p[alpha], (P/2) mod p [alpha], (P/p_j)^-1 mod p_j [alpha], its Shoup [alpha],
//   floor(2^62 / p_j) [alpha]
//   [P/p_j]_{q_i} at [j * L + i] (alpha*L), then its Shoup companions (alpha*L)
// on the coefficient-domain 32-bit product over Q_l u P.
template <int ALPHA>
__global__ void __launch_bounds__(kThreads) ksw32_moddown_kernel(
    const uint32_t* __restrict__ cin, int64_t* __restrict__ e, int L, int T, int n,
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
  const uint32_t* cp = cin + poly * T * n + j;
  int64_t* ep = e + poly * L * n + j;

  uint32_t y[ALPHA];
  uint64_t over = 0;  // wraps mod 2^64, as the reference's 64-bit sum
#pragma unroll
  for (int k = 0; k < ALPHA; ++k) {
    const uint32_t xk = cp[static_cast<size_t>(L + k) * n];
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
    const uint32_t xq = cp[static_cast<size_t>(i) * n];
    const uint32_t num = sub_mod(add_mod(xq, hq[i], qi), conv, qi);
    ep[static_cast<size_t>(i) * n] = add_mod(shoup_mul(num, pi[i], pis[i], qi), v, qi);
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

int moddown(const uint32_t* cin, int64_t* e, int polys, int L, int alpha, int T, int n,
            const uint32_t* consts, void* stream) {
  const size_t smem = sizeof(uint32_t) * (4 * L + 5 * alpha + 2 * alpha * L);
  return fused::by_value<kMaxAlpha>(alpha, [&](auto size) -> int {
    constexpr int ALPHA = decltype(size)::value;
    int err = set_smem(reinterpret_cast<const void*>(ksw32_moddown_kernel<ALPHA>), smem);
    if (err != 0) return err;
    dim3 grid((n + kThreads - 1) / kThreads, polys);
    ksw32_moddown_kernel<ALPHA><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        cin, e, L, T, n, consts);
    return static_cast<int>(cudaGetLastError());
  });
}

constexpr int rows_smem(int logn) { return 12 << logn; }

// G * T clusters of the cluster route (clusters == 0: only the occupancy
// check, into `fit`).
int cluster_route(const int64_t* x, const int64_t* key_q, const int64_t* key_p, uint32_t* cout,
                  int G, int L, int Lq, int alpha, int beta, int T, int logn, int logs,
                  const void* fwd, const void* inv, const void* cfwd, const void* cinv,
                  const void* ninv, const void* ninvs, const uint32_t* modup,
                  const uint32_t* inner, void* stream, int* fit) {
  if (alpha > kMaxAlpha) return static_cast<int>(cudaErrorInvalidValue);
  return ntt::by_depth(logn, logs, [&](auto depth) -> int {
    constexpr int LOGS = ntt::kSubLogn, K = decltype(depth)::value;
    static int ready[ntt::kMaxClusterDevices] = {};
    return ntt::launch_clusters(
        ksw32_cluster_kernel<LOGS, K>, G * T, 1 << K, ntt::row_threads(LOGS), rows_smem(LOGS),
        ready, static_cast<cudaStream_t>(stream), fit, x, key_q, key_p, cout, L, Lq, alpha, beta,
        T, static_cast<const unsigned char*>(fwd), static_cast<const unsigned char*>(inv),
        static_cast<const uint32_t*>(cfwd), static_cast<const uint32_t*>(cinv),
        static_cast<const uint32_t*>(ninv), static_cast<const uint32_t*>(ninvs), modup, inner);
  });
}

}  // namespace

extern "C" int ksw32_max_alpha() { return kMaxAlpha; }

// The mod-down of either route's 32-bit intermediate cin (G * 2, T, n) over
// Q_l u P into e (G * 2, L, n), int64 over Q_l.
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

// The cluster route up to the mod-down, n = 2^logn (15 or 16) over sub-rows
// of 2^logs (logs must be ntt::kSubLogn, the host's SUB_LOGN): as
// ksw32_rows_launch, with kernel B1's virtual-limb pass tables `fwd` / `inv`
// (T 2^k, entries, 2), its column tables `cfwd` / `cinv` (T, 2^k, 2) and
// n^-1 per virtual limb.
extern "C" int ksw32_cluster_launch(const int64_t* x, const int64_t* key_q, const int64_t* key_p,
                                    uint32_t* cout, int G, int L, int Lq, int alpha, int beta,
                                    int T, int logn, int logs, const void* fwd, const void* inv,
                                    const void* cfwd, const void* cinv, const void* ninv,
                                    const void* ninvs, const uint32_t* modup,
                                    const uint32_t* inner, void* stream) {
  if (G <= 0) return 0;
  return cluster_route(x, key_q, key_p, cout, G, L, Lq, alpha, beta, T, logn, logs, fwd, inv, cfwd,
                       cinv, ninv, ninvs, modup, inner, stream, nullptr);
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

// Clusters of the cluster route at n = 2^logn over sub-rows of 2^logs that
// the current card holds at once (cudaOccupancyMaxActiveClusters), or minus
// a cudaError_t.
extern "C" int ksw32_cluster_fit(int logn, int logs) {
  int fit = 0;
  const int err = cluster_route(nullptr, nullptr, nullptr, nullptr, 0, 1, 1, 1, 1, 1, logn, logs,
                                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, &fit);
  return err != 0 ? -err : fit;
}
