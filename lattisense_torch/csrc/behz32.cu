// Kernel B2's per-coefficient half and kernel B4, the two ends of the BEHZ
// multiply at the 32-bit word.
//
// B2, first half: BEHZ exact extension Q -> B u {m_sk}, one thread per
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

#include "row_fusion.cuh"

namespace {

using fused::add_mod;
using fused::shoup_mul;
using fused::sub_mod;

constexpr int kMaxL = 32;
constexpr int kMaxT = 40;
constexpr int kMaxLogn = 15;
constexpr int kThreads = 256;
constexpr uint32_t kMtilde = 1u << 16;

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

}  // namespace

extern "C" int behz32_max_limbs() { return kMaxL; }

extern "C" int behz32_max_aux() { return kMaxT; }

// B4 on dq: (polys, L, n) and da: (polys, T, n), NTT + Montgomery int64
// residues starting on 16 bytes, into out: (polys, L, n) over Q, through
// the 32-bit scratch y: (polys, L, n) and xa: (polys, T, n). `tw_*`, `q_*`,
// `post_*`, `posts_*` are kernel B1's inverse pass table and per-limb
// constants of ring_q and ring_aux (post = n^-1 * 2^-32), `consts` the
// scale-back's block. Three launches on `stream`.
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
  const int n = 1 << logn;
  const int smem = static_cast<int>(sizeof(uint32_t)) * scale_back_consts(L, T);
  return fused::by_value<kMaxL>(L, [&](auto size) -> int {
    constexpr int LL = decltype(size)::value;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(behz32_scale_back_kernel<LL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    dim3 grid((n + kThreads - 1) / kThreads, polys);
    behz32_scale_back_kernel<LL><<<grid, kThreads, smem, st>>>(y, xa, out, T, n, consts);
    return static_cast<int>(cudaGetLastError());
  });
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
