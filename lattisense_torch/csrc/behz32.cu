// Kernels B2 and B4, the two ends of the BEHZ multiply at the 32-bit word.
//
// B2: lattisense_tpu/ops/behz_pallas32.py `behz_prep32` (kernel `_k1_kernel`):
// for the (L rows over Q) coefficient-domain polynomials x it returns
//   (to_mont(ntt(x, ring_q)), to_mont(ntt(ExactExtend(x), ring_aux))),
// the BEHZ exact extension Q -> B u {m_sk} being x * m~ -> digit
// decomposition -> FastBConv to the aux basis -> the m~ channel -> SmMRq
// overflow removal.
//
// What bounds it: x read once as int64 and fq, fa written once as int64,
// 8 L + 8 (L + T) bytes a coefficient, against ~(9 L + 12) T 32-bit
// operations of the extension and the L + T rows' forward NTT: bytes bound
// it (0.136 ms at the main path's shapes, B = 32, four polynomials a pair,
// L = 8, T = 11, n = 16384). The TPU kernel keeps all L + T rows of a
// polynomial in VMEM (~1.2 MB at n = 16384), more than a block's 227 KB
// here, so the extension, which needs every limb of a coefficient, and the
// NTT, which needs every coefficient of a row, meet in device memory once,
// as 32-bit rows, in two launches:
//   1. one thread per two coefficients reads the L int64 residues of x
//      (16 bytes a limb), extends them and writes the T aux residues as
//      uint32 into a scratch (polys, T, n); L is a template parameter, so
//      the decomposed digits stay in registers (a run-time L put them in a
//      local-memory stack frame);
//   2. kernel B1's row loop (ntt::ntt_kernel, csrc/ntt_passes.cuh), restated
//      for two sources, walks the polys (L + T) rows of the joint stack, q row k < L from x (int64, the staging of
//      B1) and aux row k - L from the scratch (uint32, a 4-byte staging
//      variant), each with limb k of one joint (L + T)-limb table, ring_q's
//      limbs followed by ring_aux's, and ends each row with the
//      to-Montgomery epilogue and int64 stores to fq or fa, 16 bytes a
//      store (B1 stores 8: with pairs the launch measured 0.28 ms at the
//      main path's shapes against 0.33).
// Device memory sees 8 L + 4 T + 8 L + 4 T + 8 (L + T) bytes a coefficient,
// 1.7 times the bound's, with one wave tail for all the rows; no B1 entry
// point is called. Measured on the H100 at the main path's shapes: 0.40 ms
// (the extension 0.11, the rows 0.28) against 0.50 for the first design, an
// extension into int64 rows and B1's forward over the q rows and the aux
// rows (0.16 + 0.33).
//
// Extension constant block (uint32), loaded to shared memory by every block:
//   src  6L : q, m~ mod q, its Shoup, (Q/q_i)^-1 mod q_i, its Shoup, Q/q_i mod m~
//   dst  5T : d, Q mod d, its Shoup, m~^-1 mod d, its Shoup
//   conv 2LT: [Q/q_i]_{d_t} at [i*T + t], then its Shoup companions
//   1       : -Q^-1 mod m~
//
// B4: lattisense_tpu/ops/behz_pallas32.py `behz_finish32` (kernel
// `_k3_kernel`): for the NTT + Montgomery tensor products dq (L rows over Q)
// and da (T rows over B u {m_sk}) of each polynomial, the inverse NTT of
// every row with the from-Montgomery folded into the n^-1 epilogue (the
// transform is linear), then `scale_back`, BEHZ's scale by t/Q and exact
// conversion back to Q, on the L + T residues of each coefficient:
//   [t X]_Q, FastBConv q -> aux, (t X_aux - conv) * Q^-1 on the aux basis,
//   Shenoy-Kumaresan B -> Q through the m_sk channel with the centred
//   correction.
//
// What bounds it: the inputs are read once and the output written once,
// 8 (2L + T) bytes a coefficient, against ~(L T + Tb (L + 1)) Shoup products
// of the scale-back and the inverse NTT's log2(n) / 2 butterflies a residue:
// bytes bound it (0.10 ms at the main path's shapes, B = 32, L = 8, T = 11,
// n = 16384). The TPU kernel keeps a polynomial's L + T rows in VMEM between
// the inverse NTTs and the scale-back, which works across them; a block here
// holds three 32-bit rows at most. Its row-local steps run where the rows
// are in registers, and only 32-bit rows meet in device memory:
//   1. kernel B1's loop over the dq rows (csrc/ntt_passes.cuh, ntt_kernel)
//      ends each row with y_i = [t X_i (Q/q_i)^-1]_{q_i} (DecomposeQ);
//   2. its loop over the da rows ends each row with X_aux,k (Store32);
//   3. one thread per coefficient reads its L + T 32-bit residues and runs
//      the rest of the scale-back, L a template parameter so that its arrays
//      stay in registers.
// Device memory sees 8 (2L + T) + 8 (L + T) bytes a coefficient, 1.7 times
// the bound's, and no B1 entry point is called. Measured on the H100 at the
// main path's shapes: 0.395 ms, 26 % of the bound, against 0.55 ms for B1's
// inverse into int64 rows and an int64 scale-back. A cluster of 8 blocks
// parking a polynomial's 19 rows in shared memory and reading them through
// distributed shared memory measured 0.62 ms: a block holds three rows, so
// each wave of 15 clusters does three rows a block in turn before its
// scale-back, and 96 polynomials take 7 waves.
//
// Constant block (uint32), Tb = T - 1 (the B primes; aux row T-1 is m_sk):
//   q   7L  : q, t mod q, its Shoup, (Q/q_i)^-1 mod q_i, its Shoup, B mod q, its Shoup
//   aux 5T  : d, t mod d, its Shoup, Q^-1 mod d, its Shoup
//   conv1 2LT: [Q/q_i]_{d_t} at [i*T + t], then its Shoup companions
//   shen 2Tb: (B/b_k)^-1 mod b_k, its Shoup
//   conv2 2Tb(L+1): [B/b_k]_{q_i} at [k*(L+1) + i], i = L for m_sk, then Shoups
//   3       : B^-1 mod m_sk, its Shoup, m_sk >> 1
//
// Above the row loops' cap (kMaxLogn = 2^14, B1's row kernel's), at n = 2^15
// and 2^16, a row does not fit a block's registers and both halves take
// the cluster route: the row loop's step replaced by one launch of the
// cluster body of csrc/ntt_cluster.cuh (`cluster_kernel`, one thread-block
// cluster of 2^k blocks a row, sub-rows of 2^13, 4 blocks at 2^15 and 8 at
// 2^16), with rows of its own (`PrepCluster`, `FinishCluster`):
//   B2: the extension kernel above into the uint32 scratch, then one
//       cluster launch over the polys (L + T) rows of the joint ring: block
//       s reads the cells of its columns of a q row from x (int64) or of an
//       aux row from the scratch (uint32), runs the cross stages and the row
//       passes on its sub-row, and ends it with the to-Montgomery epilogue
//       and 16-byte paired stores to fq or fa;
//   B4: one cluster launch over the dq rows and the da rows (each block
//       reads its sub-row as int64, runs the row passes, parks its top
//       window, crosses the cluster and applies the epilogue once): a dq row
//       ends in y_i = [t X_i (Q/q_i)^-1]_{q_i}, a da row in X_aux,k, both
//       32-bit cells; then the scale-back kernel above.
// Device memory sees the row loops' bytes, so what bounds them is the same.
// The scale-back stays a launch of its own: a cluster that parked a
// polynomial's rows for it measured slower (above). Measured on the H100 at
// the n = 2^15 path's shapes (B = 32, L = 22, T = 25): B2 2.60 ms (the
// extension 1.02, the cluster launch 1.58) and B4 3.05 ms (the cluster
// launch 1.42, the scale-back 1.62), against 2.92 and 5.11 for the row
// loops restated at 2^15 (32 residues a thread, 272 and 736 bytes of
// stack). Both cluster instances are held to two blocks an SM
// (`kTwoBlocks`, 64 registers): B4's took 74, one block an SM and 1.91 ms
// for its cluster launch without.
// The constant blocks are the row routes'.

#include "ntt_cluster.cuh"
#include "row_fusion.cuh"

namespace {

using fused::add_mod;
using fused::shoup_mul;
using fused::sub_mod;

constexpr int kMaxL = 32;
constexpr int kMaxT = 40;
constexpr int kMaxLogn = 14;         // the row loops' cap (B1's); above, the cluster route
constexpr int kThreads = 256;
constexpr uint32_t kMtilde = 1u << 16;

// ---------------------------------------------------------------------------
// B2, step 1: the extension, two coefficients a thread
// ---------------------------------------------------------------------------

// From x (polys, L, n) int64 to the aux residues ext (polys, T, n), uint32,
// coefficients j, j + 1 of polynomial blockIdx.x.
template <int L>
__global__ void __launch_bounds__(kThreads) behz32_extend_kernel(
    const int64_t* __restrict__ x, uint32_t* __restrict__ ext, int T, int n,
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

  const int j = 2 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (j >= n) return;
  const size_t poly = blockIdx.x;
  const int64_t* xp = x + poly * L * n + j;

  uint32_t y0[L], y1[L];
  uint32_t e0 = 0, e1 = 0;  // m~ channel: wraps mod 2^32, exact mod m~ = 2^16
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const longlong2 v = *reinterpret_cast<const longlong2*>(xp + static_cast<size_t>(i) * n);
    const uint32_t qi = q[i], m = mt[i], ms = mts[i], h = qhi[i], hs = qhis[i];
    y0[i] = shoup_mul(shoup_mul(static_cast<uint32_t>(v.x), m, ms, qi), h, hs, qi);
    y1[i] = shoup_mul(shoup_mul(static_cast<uint32_t>(v.y), m, ms, qi), h, hs, qi);
    e0 += (y0[i] & (kMtilde - 1)) * qmt[i];
    e1 += (y1[i] & (kMtilde - 1)) * qmt[i];
  }
  const uint32_t r0 = ((e0 & (kMtilde - 1)) * neg_qinv) & (kMtilde - 1);
  const uint32_t r1 = ((e1 & (kMtilde - 1)) * neg_qinv) & (kMtilde - 1);

  uint32_t* ep = ext + poly * T * n + j;
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const uint32_t dt = d[t];
    uint32_t a0 = 0, a1 = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint32_t w = cv[i * T + t], ws = cs[i * T + t];
      a0 = add_mod(a0, shoup_mul(y0[i], w, ws, dt), dt);
      a1 = add_mod(a1, shoup_mul(y1[i], w, ws, dt), dt);
    }
    const uint32_t rm0 = r0 >= kMtilde / 2 ? dt - (kMtilde - r0) : r0;
    const uint32_t rm1 = r1 >= kMtilde / 2 ? dt - (kMtilde - r1) : r1;
    const uint32_t s0 = add_mod(a0, shoup_mul(rm0, qm[t], qms[t], dt), dt);
    const uint32_t s1 = add_mod(a1, shoup_mul(rm1, qm[t], qms[t], dt), dt);
    const uint32_t o0 = shoup_mul(s0, mti[t], mtis[t], dt), o1 = shoup_mul(s1, mti[t], mtis[t], dt);
    *reinterpret_cast<uint2*>(ep + static_cast<size_t>(t) * n) = make_uint2(o0, o1);
  }
}

// ---------------------------------------------------------------------------
// B2, step 2: the forward NTT of the joint (L + T)-row stack
// ---------------------------------------------------------------------------

// Where row `row` of the joint stack comes from and goes to: q row k < L of
// polynomial `poly` is x's (int64) and fq's, aux row k - L the scratch's
// (uint32) and fa's.
struct PrepRows {
  const int64_t* x;
  const uint32_t* ext;
  int64_t* fq;
  int64_t* fa;
  int L, T;
};

// A uint32 row into the staging buffer by cp.async, 16 bytes (4 residues)
// a copy, in element order: the forward's first window reads 32
// consecutive residues a warp, one to a bank.
template <int LOGN>
__device__ __forceinline__ void stage_row32(uint32_t* stage, const uint32_t* src, int lane) {
  constexpr int CHUNKS = 1 << (LOGN - 2), T = ntt::row_threads(LOGN);
#pragma unroll
  for (int c = lane; c < CHUNKS; c += T) ntt::cp_async16(stage + 4 * c, src + 4 * c);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int LOGN>
__device__ __forceinline__ void stage_prep_row(unsigned char* stage, const PrepRows& p, int row) {
  const int lt = p.L + p.T, poly = row / lt, k = row - poly * lt;
  if (k < p.L)
    ntt::stage_row<LOGN>(reinterpret_cast<int64_t*>(stage),
                         p.x + ((static_cast<size_t>(poly) * p.L + k) << LOGN), ntt::lane_id());
  else
    stage_row32<LOGN>(reinterpret_cast<uint32_t*>(stage),
                      p.ext + ((static_cast<size_t>(poly) * p.T + k - p.L) << LOGN),
                      ntt::lane_id());
}

// The row's registers, in the forward's last window (the chunk window), to
// yr as int64, through one exchange to the layout where registers 2j and
// 2j + 1 of thread `lane` hold elements 2 lane + {0, 1} + j 2^(LOGN - K + 1):
// 16-byte stores, 512 consecutive bytes a warp, half the store
// instructions of B1's 8-byte ones. Slots of an element pair are adjacent
// (xswz32 is linear and leaves bit 0 to the pair), so each pair is one
// 8-byte shared-memory read, conflict-free by half-warp.
template <int LOGN>
__device__ __forceinline__ void store_row_pairs(uint32_t (&a)[1 << ntt::reg_bits(LOGN)],
                                                int64_t* __restrict__ yr, uint32_t* xb) {
  constexpr int K = ntt::reg_bits(LOGN), E = 1 << K, TB = LOGN - K;
  if constexpr (ntt::num_passes(LOGN) == 1) {      // one thread holds the row in order
#pragma unroll
    for (int j = 0; j < E / 2; ++j)
      *reinterpret_cast<longlong2*>(yr + 2 * j) = make_longlong2(a[2 * j], a[2 * j + 1]);
  } else {
    const int from = ntt::xswz32(ntt::element<0, K>(ntt::lane_id(), 0));
#pragma unroll
    for (int i = 0; i < E; ++i) xb[from ^ ntt::xswz32(i)] = a[i];
    __syncthreads();
    const int lane = ntt::lane_id();
#pragma unroll
    for (int j = 0; j < E / 2; ++j) {
      const int e = (lane << 1) | (j << (TB + 1));
      const int slot = ntt::xswz32(e);
      const uint2 v = *reinterpret_cast<const uint2*>(xb + (slot & ~1));
      const bool swap = slot & 1;
      *reinterpret_cast<longlong2*>(yr + e) = make_longlong2(swap ? v.y : v.x, swap ? v.x : v.y);
    }
  }
}

// ntt::ntt_kernel's forward row loop on two sources: persistent blocks walk
// the rows, the next row streams into the staging buffer (8-byte or 4-byte
// residues as its source has them) behind the passes of the current one,
// and each row ends with the to-Montgomery epilogue (`post`, `posts`: 2^32
// mod q and its companion, per joint limb) and int64 stores in 16-byte
// pairs.
template <int LOGN>
__global__ void __launch_bounds__(ntt::row_threads(LOGN)) behz32_prep_rows_kernel(
    PrepRows p, int rows, const unsigned char* __restrict__ tw, const uint32_t* __restrict__ qv,
    const uint32_t* __restrict__ post, const uint32_t* __restrict__ posts) {
  using ntt::W32;
  constexpr int N = 1 << LOGN, K = ntt::reg_bits(LOGN), E = 1 << K, P = ntt::num_passes(LOGN);
  constexpr int TOP = ntt::window_lo(LOGN, 0);
  constexpr bool STAGE = W32::stages(LOGN) && LOGN >= 2;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* xb = reinterpret_cast<uint32_t*>(smem + (STAGE ? 8 * N : 0));
  const int lt = p.L + p.T;
  int row = blockIdx.x;
  if constexpr (STAGE) {
    if (row < rows) stage_prep_row<LOGN>(smem, p, row);
  }
  for (; row < rows; row += gridDim.x) {
    const int poly = row / lt, k = row - poly * lt;
    const bool qrow = k < p.L;
    const uint32_t q = qv[k];
    uint32_t a[E];
    if constexpr (STAGE) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // the staged row has landed; the last row's exchange is read

    // the first window: the top one, where a warp's lanes hold consecutive elements
    const int lane = ntt::lane_id();
    if constexpr (STAGE) {
      if (qrow) {
        const int64_t* st = reinterpret_cast<const int64_t*>(smem);
        const int base = ntt::sswz(ntt::element<TOP, K>(lane, 0));   // sswz is linear
#pragma unroll
        for (int i = 0; i < E; ++i) a[i] = static_cast<uint32_t>(st[base ^ ntt::sswz(i << TOP)]);
      } else {
        const uint32_t* st = reinterpret_cast<const uint32_t*>(smem);
#pragma unroll
        for (int i = 0; i < E; ++i) a[i] = st[ntt::element<TOP, K>(lane, i)];
      }
    } else if (qrow) {
      const int64_t* xr = p.x + ((static_cast<size_t>(poly) * p.L + k) << LOGN);
#pragma unroll
      for (int i = 0; i < E; ++i) a[i] = static_cast<uint32_t>(xr[ntt::element<TOP, K>(lane, i)]);
    } else {
      const uint32_t* er = p.ext + ((static_cast<size_t>(poly) * p.T + k - p.L) << LOGN);
#pragma unroll
      for (int i = 0; i < E; ++i) a[i] = er[ntt::element<TOP, K>(lane, i)];
    }

    const unsigned char* tl = tw + static_cast<size_t>(k) * ntt::table_entries(LOGN) *
                                       W32::kEntryBytes;
    if constexpr (STAGE) {
      // the staging buffer is free once every thread has read its first
      // window: fetch the next row behind the passes, after the first
      // exchange's barrier
      const auto fetch_next = [&] {
        if (row + static_cast<int>(gridDim.x) < rows)
          stage_prep_row<LOGN>(smem, p, row + gridDim.x);
      };
      if constexpr (P == 1) {
        __syncthreads();
        fetch_next();
        ntt::passes<W32, LOGN, false>(a, xb, tl, q);
      } else {
        ntt::passes<W32, LOGN, false>(a, xb, tl, q, fetch_next);
      }
    } else {
      ntt::passes<W32, LOGN, false>(a, xb, tl, q);
    }
    ntt::epilogue<W32>(a, q, true, post[k], posts[k]);
    int64_t* yr = qrow ? p.fq + ((static_cast<size_t>(poly) * p.L + k) << LOGN)
                       : p.fa + ((static_cast<size_t>(poly) * p.T + k - p.L) << LOGN);
    store_row_pairs<LOGN>(a, yr, xb);
  }
}

// Launch the rows kernel at 2^LOGN on a persistent grid (blocks per SM
// times the SMs, set up once per device).
template <int LOGN>
int prep_rows_launch(const PrepRows& p, int rows, const void* tw, const void* q, const void* post,
                     const void* posts, cudaStream_t stream) {
  static int grid_of[fused::kMaxDevices] = {};
  static int allowed[fused::kMaxDevices] = {};
  auto kernel = behz32_prep_rows_kernel<LOGN>;
  constexpr int smem = ntt::W32::smem_bytes(LOGN);
  int e = fused::allow_smem(kernel, smem, allowed);
  if (e != 0) return e;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid_of[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ntt::row_threads(LOGN),
                                                        smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_of[dev] = per_sm * sms;
  }
  const int grid = rows < grid_of[dev] ? rows : grid_of[dev];
  behz32_prep_rows_kernel<LOGN><<<grid, ntt::row_threads(LOGN), smem, stream>>>(
      p, rows, static_cast<const unsigned char*>(tw), static_cast<const uint32_t*>(q),
      static_cast<const uint32_t*>(post), static_cast<const uint32_t*>(posts));
  return static_cast<int>(cudaGetLastError());
}

__host__ __device__ inline int scale_back_consts(int L, int T) {
  const int Tb = T - 1;
  return 7 * L + 5 * T + 2 * L * T + 2 * Tb + 2 * Tb * (L + 1) + 3;
}

// The offsets of the scale-back's constant block (layout in the head
// comment), for L q limbs and T aux limbs.
struct FinishConsts {
  const uint32_t *q, *tq, *tqs, *qhi, *qhis, *bq, *bqs;        // 7L
  const uint32_t *d, *td, *tds, *qinv, *qinvs;                  // 5T
  const uint32_t *c1v, *c1s, *shi, *shis, *c2v, *c2s, *sc;
  __device__ __forceinline__ FinishConsts(const uint32_t* c, int L, int T) {
    const int Tb = T - 1;
    q = c, tq = c + L, tqs = c + 2 * L, qhi = c + 3 * L, qhis = c + 4 * L;
    bq = c + 5 * L, bqs = c + 6 * L;
    d = c + 7 * L, td = d + T, tds = d + 2 * T, qinv = d + 3 * T, qinvs = d + 4 * T;
    c1v = d + 5 * T, c1s = c1v + L * T, shi = c1s + L * T, shis = shi + Tb;
    c2v = shis + Tb, c2s = c2v + Tb * (L + 1), sc = c2s + Tb * (L + 1);
  }
};

// ---------------------------------------------------------------------------
// B4, steps 1 and 2: the ends of the q rows and the aux rows
// ---------------------------------------------------------------------------

// The end of a q row in kernel B1's loop over the dq rows: X_i, the inverse
// NTT with the from-Montgomery folded into n^-1, then y_i = [t X_i
// (Q/q_i)^-1]_{q_i}, [t X]_Q decomposed for the conversion to the aux
// basis, stored as 32-bit residues in the top window.
template <int LOGN>
struct DecomposeQ {
  uint32_t* y;
  const uint32_t* post;
  const uint32_t* posts;
  const uint32_t* consts;
  int L, T;

  __device__ __forceinline__ void operator()(uint32_t (&a)[1 << ntt::reg_bits(LOGN)], uint32_t*,
                                             int row, int i, uint32_t q) const {
    constexpr int K = ntt::reg_bits(LOGN), TOP = ntt::window_lo(LOGN, 0);
    ntt::epilogue<ntt::W32>(a, q, true, post[i], posts[i]);
    const FinishConsts c(consts, L, T);
    const uint32_t tq = c.tq[i], tqs = c.tqs[i], qhi = c.qhi[i], qhis = c.qhis[i];
    uint32_t* yr = y + (static_cast<size_t>(row) << LOGN);
    const int lane = ntt::lane_id();
#pragma unroll
    for (int e = 0; e < (1 << K); ++e)
      yr[ntt::element<TOP, K>(lane, e)] = shoup_mul(shoup_mul(a[e], tq, tqs, q), qhi, qhis, q);
  }
};

// The end of an aux row in B1's loop over the da rows: X_aux,k, the inverse
// NTT with the from-Montgomery folded into n^-1, stored as 32-bit residues.
template <int LOGN>
struct Store32 {
  uint32_t* x;
  const uint32_t* post;
  const uint32_t* posts;

  __device__ __forceinline__ void operator()(uint32_t (&a)[1 << ntt::reg_bits(LOGN)], uint32_t*,
                                             int row, int k, uint32_t q) const {
    constexpr int K = ntt::reg_bits(LOGN), TOP = ntt::window_lo(LOGN, 0);
    ntt::epilogue<ntt::W32>(a, q, true, post[k], posts[k]);
    uint32_t* xr = x + (static_cast<size_t>(row) << LOGN);
    const int lane = ntt::lane_id();
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) xr[ntt::element<TOP, K>(lane, e)] = a[e];
  }
};

// ---------------------------------------------------------------------------
// B4, step 3: the scale-back of one coefficient a thread
// ---------------------------------------------------------------------------

// w_k = (t X_aux,k - conv_k) * Q^-1 on aux row k, with conv_k the FastBConv
// of the y_i to d_k; a B row (k < T-1) then decomposed for
// Shenoy-Kumaresan, times (B/b_k)^-1.
template <int L>
__device__ __forceinline__ uint32_t aux_w(const FinishConsts& c, int T, int k, uint32_t xa,
                                          const uint32_t (&y)[L]) {
  const uint32_t dk = c.d[k];
  uint32_t conv = 0;
#pragma unroll
  for (int i = 0; i < L; ++i)
    conv = add_mod(conv, shoup_mul(y[i], c.c1v[i * T + k], c.c1s[i * T + k], dk), dk);
  const uint32_t tx = shoup_mul(xa, c.td[k], c.tds[k], dk);
  const uint32_t w = shoup_mul(sub_mod(tx, conv, dk), c.qinv[k], c.qinvs[k], dk);
  return k < T - 1 ? shoup_mul(w, c.shi[k], c.shis[k], dk) : w;
}

// From y (L rows) and X_aux (T rows), 32-bit, to out (L rows) over Q, for
// coefficient j of polynomial blockIdx.y. Each B row's w_k is folded into
// the outputs' and the m_sk channel's sums as soon as it is made, so only y
// and those sums are arrays, of the compile-time size L, in registers; the
// m_sk channel gives the overflow alpha of Shenoy-Kumaresan B -> Q, centred
// to allow slight negatives. Aux row k + 1 is read while row k is worked on.
template <int L>
__global__ void __launch_bounds__(kThreads) behz32_scale_back_kernel(
    const uint32_t* __restrict__ y, const uint32_t* __restrict__ xa, int64_t* __restrict__ out,
    int T, int n, const uint32_t* __restrict__ consts) {
  extern __shared__ uint32_t smem_consts[];
  const int total = scale_back_consts(L, T);
  for (int i = threadIdx.x; i < total; i += blockDim.x) smem_consts[i] = consts[i];
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t poly = blockIdx.y;
  const uint32_t* yp = y + poly * L * n + j;
  const uint32_t* ap = xa + poly * T * n + j;
  int64_t* op = out + poly * L * n + j;
  const FinishConsts c(smem_consts, L, T);
  const int Tb = T - 1;
  const uint32_t msk = c.d[Tb];
  uint32_t yv[L], acc[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    yv[i] = yp[static_cast<size_t>(i) * n];
    acc[i] = 0;
  }
  uint32_t conv_sk = 0, next = ap[0];
#pragma unroll 1
  for (int k = 0; k < Tb; ++k) {
    const uint32_t xk = next;
    next = ap[static_cast<size_t>(k + 1) * n];
    const uint32_t wd = aux_w<L>(c, T, k, xk, yv);
    const uint32_t* cv = c.c2v + k * (L + 1);
    const uint32_t* cs = c.c2s + k * (L + 1);
    conv_sk = add_mod(conv_sk, shoup_mul(wd, cv[L], cs[L], msk), msk);
#pragma unroll
    for (int i = 0; i < L; ++i) acc[i] = add_mod(acc[i], shoup_mul(wd, cv[i], cs[i], c.q[i]), c.q[i]);
  }
  const uint32_t w_sk = aux_w<L>(c, T, Tb, next, yv);
  const uint32_t alpha = shoup_mul(sub_mod(conv_sk, w_sk, msk), c.sc[0], c.sc[1], msk);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t qi = c.q[i];
    const uint32_t amod = alpha >= c.sc[2] ? qi - (msk - alpha) : alpha;
    op[static_cast<size_t>(i) * n] = sub_mod(acc[i], shoup_mul(amod, c.bq[i], c.bqs[i], qi), qi);
  }
}

// The extension kernel on its L instance.
int extend(const int64_t* x, uint32_t* ext, int polys, int L, int T, int n, const uint32_t* consts,
           cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(uint32_t)) * (6 * L + 5 * T + 2 * L * T + 1);
  return fused::by_value<kMaxL>(L, [&](auto size) -> int {
    constexpr int LL = decltype(size)::value;
    static int allowed[fused::kMaxDevices] = {};
    int e = fused::allow_smem(behz32_extend_kernel<LL>, smem, allowed);
    if (e != 0) return e;
    const int threads = n / 2 < kThreads ? n / 2 : kThreads;
    dim3 grid(polys, n / 2 / threads);
    behz32_extend_kernel<LL><<<grid, threads, smem, st>>>(x, ext, T, n, consts);
    return static_cast<int>(cudaGetLastError());
  });
}

// The scale-back kernel on its L instance.
int scale_back(const uint32_t* y, const uint32_t* xa, int64_t* out, int polys, int L, int T, int n,
               const uint32_t* consts, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(uint32_t)) * scale_back_consts(L, T);
  return fused::by_value<kMaxL>(L, [&](auto size) -> int {
    constexpr int LL = decltype(size)::value;
    auto kernel = behz32_scale_back_kernel<LL>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    dim3 grid((n + kThreads - 1) / kThreads, polys);
    kernel<<<grid, kThreads, smem, st>>>(y, xa, out, T, n, consts);
    return static_cast<int>(cudaGetLastError());
  });
}

// ---------------------------------------------------------------------------
// the cluster route (n = 2^15, 2^16): B2's and B4's rows of the cluster body
// ---------------------------------------------------------------------------

// B2's joint rows for `ntt::cluster_kernel`: row poly (L + T) + k on limb k
// of the joint ring, a q row (k < L) from x (int64) into fq, an aux row from
// the uint32 scratch into fa; each block reads the cells of its columns from
// its row's source and ends its sub-row with the to-Montgomery epilogue
// (`post`, `posts` per virtual limb) and 16-byte paired stores.
template <int LOGS, int K>
struct PrepCluster {
  static constexpr int LOGN = LOGS + K;
  static constexpr bool kTwoBlocks = true;
  const int64_t* x;
  const uint32_t* ext;
  int64_t* fq;
  int64_t* fa;
  int L, T;
  const uint32_t* post;
  const uint32_t* posts;

  __device__ __forceinline__ void load(uint32_t (&a)[1 << ntt::reg_bits(LOGS)], uint32_t*,
                                       size_t row, int k, int s) const {
    const size_t poly = row / static_cast<size_t>(L + T);
    if (k < L)
      ntt::read_cells<ntt::W32, LOGS, K>(a, x + ((poly * L + k) << LOGN), s);
    else
      ntt::read_cells<ntt::W32, LOGS, K>(a, ext + ((poly * T + (k - L)) << LOGN), s);
  }

  __device__ __forceinline__ void end(uint32_t (&a)[1 << ntt::reg_bits(LOGS)], uint32_t* xb,
                                      size_t row, int k, int s, uint32_t q) const {
    const int vlimb = (k << K) + s;
    ntt::epilogue<ntt::W32>(a, q, true, post[vlimb], posts[vlimb]);
    const size_t poly = row / static_cast<size_t>(L + T);
    int64_t* yr = k < L ? fq + ((poly * L + k) << LOGN) : fa + ((poly * T + (k - L)) << LOGN);
    store_row_pairs<LOGS>(a, yr + (static_cast<size_t>(s) << LOGS), xb);
  }
};

// B4's rows for the inverse `ntt::cluster_kernel`: row poly (L + T) + k on
// limb k of the joint ring, a dq row (k < L) or a da row, read as int64;
// after the cross stages each cell gets the epilogue (`post`, `posts`: n^-1
// with the from-Montgomery folded in, per virtual limb) and leaves as a
// 32-bit residue: a dq row's as y_i = [t X_i (Q/q_i)^-1]_{q_i} (DecomposeQ's
// end, from the scale-back's constant block) into y, a da row's as X_aux,k
// into xa.
template <int LOGS, int K>
struct FinishCluster {
  static constexpr int LOGN = LOGS + K;
  static constexpr bool kTwoBlocks = true;
  const int64_t* dq;
  const int64_t* da;
  uint32_t* y;
  uint32_t* xa;
  int L, T;
  const uint32_t* post;
  const uint32_t* posts;
  const uint32_t* consts;

  __device__ __forceinline__ void load(uint32_t (&a)[1 << ntt::reg_bits(LOGS)], uint32_t* xb,
                                       size_t row, int k, int s) const {
    const size_t poly = row / static_cast<size_t>(L + T);
    const int64_t* xr = k < L ? dq + ((poly * L + k) << LOGN) : da + ((poly * T + (k - L)) << LOGN);
    ntt::load_row<ntt::W32, LOGS, true>(a, xr + (static_cast<size_t>(s) << LOGS), xb);
  }

  __device__ __forceinline__ void end(uint32_t (&a)[1 << ntt::reg_bits(LOGS)], uint32_t*,
                                      size_t row, int k, int s, uint32_t q) const {
    constexpr int E = 1 << ntt::reg_bits(LOGS);
    const int vlimb = (k << K) + s;
    ntt::epilogue<ntt::W32>(a, q, true, post[vlimb], posts[vlimb]);
    const size_t poly = row / static_cast<size_t>(L + T);
    if (k < L) {
      const FinishConsts c(consts, L, T);
      const uint32_t tq = c.tq[k], tqs = c.tqs[k], qhi = c.qhi[k], qhis = c.qhis[k];
#pragma unroll
      for (int e = 0; e < E; ++e) a[e] = shoup_mul(shoup_mul(a[e], tq, tqs, q), qhi, qhis, q);
      ntt::write_cells<ntt::W32, LOGS, K>(a, y + ((poly * L + k) << LOGN), s);
    } else {
      ntt::write_cells<ntt::W32, LOGS, K>(a, xa + ((poly * T + (k - L)) << LOGN), s);
    }
  }
};

// One launch of the cluster kernel with B2's (INV false) or B4's rows over
// the polys (L + T) rows of the joint ring at n = 2^logn (15 or 16), over
// sub-rows of 2^logs (logs must be ntt::kSubLogn); `tw`, `ctw`, `q` are
// kernel B1's cluster tables of the joint ring (the direction's pass table
// over the virtual limbs, the column tables, the limbs' primes). rows == 0
// only asks how many clusters fit (into `fit`).
template <bool INV, class Make>
int cluster_rows(int logn, int logs, int rows, int limbs, const void* tw, const void* ctw,
                 const void* q, cudaStream_t st, int* fit, const Make& make) {
  return ntt::by_depth(logn, logs, [&](auto depth) -> int {
    constexpr int LOGS = ntt::kSubLogn, K = decltype(depth)::value;
    static int ready[ntt::kMaxClusterDevices] = {};
    return ntt::launch_rows_cluster<ntt::W32, LOGS, K, INV>(make(depth), rows, limbs, tw, ctw, q,
                                                            ready, st, fit);
  });
}

int prep_cluster(const int64_t* x, const uint32_t* ext, int64_t* fq, int64_t* fa, int polys,
                 int L, int T, int logn, int logs, const void* tw, const void* ctw, const void* q,
                 const void* post, const void* posts, cudaStream_t st, int* fit) {
  return cluster_rows<false>(logn, logs, polys * (L + T), L + T, tw, ctw, q, st, fit,
                             [&](auto depth) {
    return PrepCluster<ntt::kSubLogn, decltype(depth)::value>{
        x, ext, fq, fa, L, T, static_cast<const uint32_t*>(post),
        static_cast<const uint32_t*>(posts)};
  });
}

int finish_cluster(const int64_t* dq, const int64_t* da, uint32_t* y, uint32_t* xa, int polys,
                   int L, int T, int logn, int logs, const void* tw, const void* ctw,
                   const void* q, const void* post, const void* posts, const uint32_t* consts,
                   cudaStream_t st, int* fit) {
  return cluster_rows<true>(logn, logs, polys * (L + T), L + T, tw, ctw, q, st, fit,
                            [&](auto depth) {
    return FinishCluster<ntt::kSubLogn, decltype(depth)::value>{
        dq, da, y, xa, L, T, static_cast<const uint32_t*>(post),
        static_cast<const uint32_t*>(posts), consts};
  });
}

}  // namespace

extern "C" int behz32_max_limbs() { return kMaxL; }

extern "C" int behz32_max_aux() { return kMaxT; }

// The largest log2 n the row loops take (the host sends n above it, 2^15
// and 2^16, to the cluster route).
extern "C" int behz32_max_logn() { return kMaxLogn; }

// B4 on dq: (polys, L, n) and da: (polys, T, n), NTT + Montgomery int64
// residues starting on 16 bytes, into out: (polys, L, n) over Q, through
// the 32-bit scratch y: (polys, L, n) and xa: (polys, T, n). `tw_*`, `q_*`,
// `post_*`, `posts_*` are kernel B1's inverse pass table and per-limb
// constants of ring_q and ring_aux (post = n^-1 * 2^-32), `consts` the
// scale-back's block. Three launches on `stream`; n <= 2^kMaxLogn.
extern "C" int behz32_finish_launch(const int64_t* dq, const int64_t* da, int64_t* out,
                                    uint32_t* y, uint32_t* xa, int polys, int L, int T, int logn,
                                    const void* tw_q, const void* q_q, const void* post_q,
                                    const void* posts_q, const void* tw_a, const void* q_a,
                                    const void* post_a, const void* posts_a,
                                    const uint32_t* consts, void* stream) {
  if (L < 1 || L > kMaxL || T < 2 || T > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto u32 = [](const void* p) { return static_cast<const uint32_t*>(p); };
  int err = ntt::by_logn<kMaxLogn>(logn, [&](auto size) -> int {
    constexpr int LOGN = decltype(size)::value;
    int e = ntt::launch_rows<ntt::W32, LOGN, true, false>(
        dq, polys * L, L, tw_q, q_q, DecomposeQ<LOGN>{y, u32(post_q), u32(posts_q), consts, L, T},
        st);
    if (e != 0) return e;
    return ntt::launch_rows<ntt::W32, LOGN, true, false>(
        da, polys * T, T, tw_a, q_a, Store32<LOGN>{xa, u32(post_a), u32(posts_a)}, st);
  });
  if (err != 0) return err;
  return scale_back(y, xa, out, polys, L, T, 1 << logn, consts, st);
}

// B4 at n = 2^logn, 15 or 16, over sub-rows of 2^logs (logs must be
// ntt::kSubLogn, the host's SUB_LOGN): as behz32_finish_launch, with kernel
// B1's cluster tables of the joint ring (ring_q's L limbs, then ring_aux's
// T): `tw` the inverse pass table over the virtual limbs, `ctw` the column
// tables, `q` the limbs' primes, `post` / `posts` n^-1 * 2^-32 per virtual
// limb. Two launches on `stream`: the cluster kernel over the dq and da
// rows, the scale-back.
extern "C" int behz32_finish_cluster_launch(const int64_t* dq, const int64_t* da, int64_t* out,
                                            uint32_t* y, uint32_t* xa, int polys, int L, int T,
                                            int logn, int logs, const void* tw, const void* ctw,
                                            const void* q, const void* post, const void* posts,
                                            const uint32_t* consts, void* stream) {
  if (L < 1 || L > kMaxL || T < 2 || T > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  if (polys <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = finish_cluster(dq, da, y, xa, polys, L, T, logn, logs, tw, ctw, q, post, posts,
                                 consts, st, nullptr);
  if (err != 0) return err;
  return scale_back(y, xa, out, polys, L, T, 1 << logn, consts, st);
}

// B2 on x: (polys, L, n) int64 residues mod q starting on 16 bytes, into
// fq: (polys, L, n) and fa: (polys, T, n), through the uint32 scratch ext:
// (polys, T, n). `consts` is the extension's block; `tw`, `q`, `post`,
// `posts` are kernel B1's forward pass table and per-limb q and
// to-Montgomery constants (2^32 mod q) of the joint ring, ring_q's L limbs
// followed by ring_aux's T. Two launches on `stream`; n <= 2^kMaxLogn.
extern "C" int behz32_prep_launch(const int64_t* x, uint32_t* ext, int64_t* fq, int64_t* fa,
                                  int polys, int L, int T, int logn, const uint32_t* consts,
                                  const void* tw, const void* q, const void* post,
                                  const void* posts, void* stream) {
  if (L < 1 || L > kMaxL || T < 1 || logn > kMaxLogn)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = extend(x, ext, polys, L, T, 1 << logn, consts, st);
  if (err != 0) return err;
  const PrepRows p{x, ext, fq, fa, L, T};
  return ntt::by_logn<kMaxLogn>(logn, [&](auto size) -> int {
    return prep_rows_launch<decltype(size)::value>(p, polys * (L + T), tw, q, post, posts, st);
  });
}

// B2 at n = 2^logn, 15 or 16, over sub-rows of 2^logs (logs must be
// ntt::kSubLogn): as behz32_prep_launch, with kernel B1's cluster tables of
// the joint ring (`tw` the forward pass table over the virtual limbs, `ctw`
// the column tables, `q` the limbs' primes, `post` / `posts` 2^32 mod q per
// virtual limb). Two launches on `stream`: the extension, the cluster
// kernel over the joint rows.
extern "C" int behz32_prep_cluster_launch(const int64_t* x, uint32_t* ext, int64_t* fq,
                                          int64_t* fa, int polys, int L, int T, int logn,
                                          int logs, const uint32_t* consts, const void* tw,
                                          const void* ctw, const void* q, const void* post,
                                          const void* posts, void* stream) {
  if (L < 1 || L > kMaxL || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (logs != ntt::kSubLogn || logn <= kMaxLogn || logn > ntt::kMaxLognCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (polys <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = extend(x, ext, polys, L, T, 1 << logn, consts, st);
  if (err != 0) return err;
  return prep_cluster(x, ext, fq, fa, polys, L, T, logn, logs, tw, ctw, q, post, posts, st,
                      nullptr);
}

// Clusters of B2's (inverse == 0) or B4's (inverse != 0) cluster kernel at
// n = 2^logn over sub-rows of 2^logs that the current card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int behz32_cluster_fit(int logn, int logs, int inverse) {
  int fit = 0;
  const int err =
      inverse ? finish_cluster(nullptr, nullptr, nullptr, nullptr, 0, 1, 2, logn, logs, nullptr,
                               nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, &fit)
              : prep_cluster(nullptr, nullptr, nullptr, nullptr, 0, 1, 1, logn, logs, nullptr,
                             nullptr, nullptr, nullptr, nullptr, nullptr, &fit);
  return err != 0 ? -err : fit;
}
