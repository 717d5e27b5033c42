// The shared body of kernels B1 (csrc/ntt32.cu, 32-bit word) and B5
// (csrc/ntt64.cu, 64-bit word): the negacyclic NTT (Cooley-Tukey, natural ->
// bit-reversed order) and inverse NTT (Gentleman-Sande, bit-reversed ->
// natural, scaled by n^-1) of every row of an int64 (rows, n) stack, row r
// on limb r % limbs.
//
// Design, for n = 2^logn (ops/ntt_cuda.py builds the same schedule on the
// host; tests/test_torch_ntt_schedule.py walks it on the CPU):
//
// - Register-resident radix-2^K passes. A row is held by n / E threads, each
//   with E = 2^K residues in registers (K = 4 up to n = 2^14, K = 5 at
//   n = 2^15). A pass runs up to K butterfly stages on those registers; the
//   row is exchanged through shared memory between passes. At n = 2^14 the
//   14 stages are four passes.
// - The windows. In a pass, register i of thread `lane` holds element
//   (lane & (2^lo - 1)) | (i << lo) | ((lane >> lo) << (lo + K)): the
//   register index covers element bits [lo, lo + K) and the pass runs the
//   stages of the window's low kp bits. The full windows are [logn - K, logn)
//   (the top window), ..., [kr, kr + K) with kr = logn - K·(P - 1); the last,
//   the chunk window [0, K), has kp = kr. The forward runs them from the top
//   down, the inverse from the chunk window up.
// - Device memory is read and written in the top window, where a warp's
//   lanes hold consecutive elements (8-byte accesses, 256 bytes a warp). The
//   forward ends in the chunk window, so its output goes through one more
//   exchange; storing the chunk window straight (16 bytes a lane, 128 bytes
//   apart) measured 1.7x slower. The inverse starts in the chunk window: at
//   the 32-bit word it reads it from the staging buffer, at the 64-bit word
//   through one exchange.
// - Twiddles read once per row. The host lays out each pass's twiddles
//   (value, Shoup companion) in the order a thread uses them and interleaves
//   the threads' groups by 16-byte vector, so a warp's read of one vector is
//   one contiguous piece or one broadcast (ops/ntt_cuda.py `pass_indices`).
// - Shared memory. The exchange buffer holds the row in the word (32 or 64
//   bits) at a swizzled slot under which no exchange has a bank conflict.
//   Both swizzles are linear over GF(2), so a register's slot is its lane's
//   slot XOR a constant. At the 32-bit word up to n = 2^14 a 128 KB staging
//   buffer beside it receives the block's next row by cp.async, issued once
//   every thread has read its first window, behind the passes; blocks are
//   persistent and walk rows blockIdx.x, + gridDim.x, .... The 64-bit word
//   stages nothing: a staged 64-bit row leaves room only for an exchange in
//   32-bit halves, whose extra registers spilled and ran slower (0.99 against
//   0.73 ms forward at the main path's shapes).
// - Barriers. An element's slot is fixed and its reader in one exchange is
//   its writer in the next, so an exchange needs one barrier, between its
//   writes and reads, and only over the lanes that trade elements: aligned
//   groups of 2^max(lo_from, lo_to) lanes (a warp, a named barrier, or the
//   block). The next row's first write waits at the row loop's barrier.
// - Lazy butterflies (Harvey). Shoup products are left in [0, 2q); values
//   stay in [0, 4q) in the 64-bit forward (q < 2^62) and in [0, 2q)
//   otherwise (4q does not fit 32 bits at q < 2^31). One canonical reduction
//   runs in the epilogue, folded with the optional per-limb `post` product
//   (n^-1, to- or from-Montgomery), so outputs are canonical and bit-exact
//   with any correct NTT.
//
// The tensor cores are not the lever: the 32-bit transform is bound by bytes
// (its operations bound is a third of its bytes bound) and the 64-bit one by
// its integer multiplies (about 20 IMAD a butterfly), which run on the
// CUDA cores.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace ntt {

constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may use on sm_90

// ---------------------------------------------------------------------------
// the schedule (ops/ntt_cuda.py builds the same on the host)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int reg_bits(int logn) { return logn <= 4 ? logn : (logn <= 14 ? 4 : logn - 10); }
__host__ __device__ constexpr int num_passes(int logn) { return (logn + reg_bits(logn) - 1) / reg_bits(logn); }
__host__ __device__ constexpr int row_threads(int logn) { return 1 << (logn - reg_bits(logn)); }

// window f in forward order
__host__ __device__ constexpr int window_lo(int logn, int f) {
  return f == num_passes(logn) - 1 ? 0 : logn - reg_bits(logn) * (f + 1);
}
__host__ __device__ constexpr int window_kp(int logn, int f) {
  return f == num_passes(logn) - 1 ? logn - reg_bits(logn) * (num_passes(logn) - 1)
                                   : reg_bits(logn);
}
// the direction's tables, passes in execution order, 2^(logn - lo) entries each
__host__ __device__ constexpr int table_offset(int logn, bool inverse, int step) {
  int off = 0;
  for (int s = 0; s < step; ++s)
    off += 1 << (logn - window_lo(logn, inverse ? num_passes(logn) - 1 - s : s));
  return off;
}
__host__ __device__ constexpr int table_entries(int logn) { return table_offset(logn, false, num_passes(logn)); }

// The thread's index, read anew where it is used: an index the compiler may
// take as loop-invariant lets it hoist every exchange's addresses out of the
// row loop and keep them live across the passes, which spilled.
__device__ __forceinline__ int lane_id() {
  int lane;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(lane));
  return lane;
}

template <int LO, int K>
__device__ __forceinline__ int element(int lane, int i) {
  return (lane & ((1 << LO) - 1)) | (i << LO) | ((lane >> LO) << (LO + K));
}

// exchange-buffer slot of element idx, 32-bit words: XOR the bank bits with
// a linear map of element bits 5..9
__device__ __forceinline__ int xswz32(int idx) {
  const int h = (idx >> 5) & 31;
  return idx ^ (((h << 1) & 30) | (((h >> 3) ^ (h >> 4)) & 1));
}

// exchange-buffer slot of element idx, 64-bit words (16 to a 128-byte row of
// banks): XOR the slot bits with element bits 4..7
__device__ __forceinline__ int xswz64(int idx) { return idx ^ ((idx >> 4) & 15); }

// staging-buffer slot (int64) of element idx: 16-byte chunks permuted within
// each aligned group of eight
__device__ __forceinline__ int sswz(int idx) {
  const int c = idx >> 1;
  return ((c ^ ((c >> 3) & 7)) << 1) | (idx & 1);
}

// the perm layout: position b·(n/128) + a holds standard element a·128 + b
template <int LOGN>
__device__ __forceinline__ int perm_pos(int idx) {
  return (idx & 127) * (1 << (LOGN - 7)) + (idx >> 7);
}

template <int LOGN>
__device__ __forceinline__ int perm_element(int pos) {
  return ((pos & ((1 << (LOGN - 7)) - 1)) << 7) | (pos >> (LOGN - 7));
}

// ---------------------------------------------------------------------------
// the two words
// ---------------------------------------------------------------------------

struct W32 {
  using T = uint32_t;
  static constexpr int kEntryBytes = 8;            // (w, w') as two uint32
  // the next row is staged by cp.async where a block holds it beside the exchange buffer
  __host__ __device__ static constexpr bool stages(int logn) { return (12 << logn) <= kSmemLimit; }
  __host__ __device__ static constexpr int smem_bytes(int logn) {
    return (stages(logn) ? 8 << logn : 0) + (4 << logn);
  }
  __device__ static int xslot(int idx) { return xswz32(idx); }
  __device__ static T shoup_lazy(T a, T w, T ws, T q) { return a * w - __umulhi(a, ws) * q; }
  // x mod q for x < 2q: x - q wraps above x when x < q (q < 2^31)
  __device__ static T reduce(T x, T q) { return min(x, x - q); }
  // values in [0, 2q)
  __device__ static void fwd(T& x, T& y, T w, T ws, T q) {
    const T v = reduce(shoup_lazy(y, w, ws, q), q), u = reduce(x, q);
    x = u + v;
    y = u - v + q;
  }
  __device__ static void inv(T& x, T& y, T w, T ws, T q) {
    const T u = reduce(x, q), v = reduce(y, q);
    x = u + v;
    y = shoup_lazy(u - v + q, w, ws, q);
  }
  __device__ static T canon(T x, T q) { return reduce(x, q); }
};

struct W64 {
  using T = uint64_t;
  static constexpr int kEntryBytes = 16;           // (w, w') as two uint64
  // a staged 64-bit row would leave room only for an exchange in 32-bit
  // halves, whose extra registers spill: the row is read straight from
  // device memory and exchanged whole
  __host__ __device__ static constexpr bool stages(int) { return false; }
  __host__ __device__ static constexpr int smem_bytes(int logn) { return 8 << logn; }
  __device__ static int xslot(int idx) { return xswz64(idx); }
  __device__ static T shoup_lazy(T a, T w, T ws, T q) { return a * w - __umul64hi(a, ws) * q; }
  // forward values in [0, 4q)
  __device__ static void fwd(T& x, T& y, T w, T ws, T q) {
    const T q2 = q << 1;
    const T u = x >= q2 ? x - q2 : x;
    const T v = shoup_lazy(y, w, ws, q);
    x = u + v;
    y = u - v + q2;
  }
  // inverse values in [0, 2q)
  __device__ static void inv(T& x, T& y, T w, T ws, T q) {
    const T q2 = q << 1;
    const T s = x + y, d = x - y + q2;
    x = s >= q2 ? s - q2 : s;
    y = shoup_lazy(d, w, ws, q);
  }
  __device__ static T canon(T x, T q) {
    x = x >= (q << 1) ? x - (q << 1) : x;
    return x >= q ? x - q : x;
  }
};

// Entry k of a thread's twiddles. A pass table is laid out by 16-byte vector
// (V = 16 / kEntryBytes entries each) across the threads' groups: vector k / V
// of every group u = lane >> lo, then the next, so a warp's load of one
// vector is contiguous (or one broadcast). `tw` points at the thread's first
// vector; STRIDE is the bytes from one vector index to the next.
template <class W, int STRIDE>
__device__ __forceinline__ void load_entry(const unsigned char* tw, int k, typename W::T& w,
                                           typename W::T& ws) {
  if constexpr (W::kEntryBytes == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(tw + k * STRIDE));
    w = static_cast<uint64_t>(v.x) | (static_cast<uint64_t>(v.y) << 32);
    ws = static_cast<uint64_t>(v.z) | (static_cast<uint64_t>(v.w) << 32);
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(tw + (k >> 1) * STRIDE + 8 * (k & 1)));
    w = v.x;
    ws = v.y;
  }
}

// entries k, k + 1 (k even) of the 32-bit word: one 16-byte vector
template <int STRIDE>
__device__ __forceinline__ void load_pair32(const unsigned char* tw, int k, uint32_t (&w)[2],
                                            uint32_t (&ws)[2]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(tw + (k >> 1) * STRIDE));
  w[0] = v.x;
  ws[0] = v.y;
  w[1] = v.z;
  ws[1] = v.w;
}

// ---------------------------------------------------------------------------
// one pass: stages J = 0 .. KP-1 on the registers
// ---------------------------------------------------------------------------

// The butterflies of one twiddle h of group g at stage J (forward: register
// distance 2^(KP-1-J), pairs with r >> (KP-J) == h; inverse: distance 2^J,
// pairs with r >> (J+1) == h).
template <class W, int K, int KP, bool INV, int J>
__device__ __forceinline__ void twiddle_group(typename W::T (&a)[1 << K], int g, int h,
                                              typename W::T w, typename W::T ws,
                                              typename W::T q) {
  constexpr int GS = 1 << KP;
  constexpr int DIST = INV ? (1 << J) : (1 << (KP - 1 - J));
  constexpr int SPAN = INV ? (1 << (J + 1)) : (1 << (KP - J));
#pragma unroll
  for (int r = 0; r < SPAN; ++r) {
    if (r & DIST) continue;
    const int i0 = g * GS + h * SPAN + r;
    if constexpr (INV)
      W::inv(a[i0], a[i0 + DIST], w, ws, q);
    else
      W::fwd(a[i0], a[i0 + DIST], w, ws, q);
  }
}

template <class W, int K, int KP, bool INV, int STRIDE, int J = 0>
__device__ __forceinline__ void stages(typename W::T (&a)[1 << K], const unsigned char* tw,
                                       typename W::T q) {
  if constexpr (J < KP) {
    using T = typename W::T;
    constexpr int GS = 1 << KP, NG = (1 << K) / GS;
    constexpr int CNT = INV ? (1 << (KP - 1 - J)) : (1 << J);      // twiddles per group
    constexpr int OFF = INV ? (GS - (GS >> J)) : (1 << J);          // slot of the first
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if constexpr (W::kEntryBytes == 8 && CNT >= 2) {
#pragma unroll
        for (int h = 0; h < CNT; h += 2) {
          uint32_t w[2], ws[2];
          load_pair32<STRIDE>(tw, g * GS + OFF + h, w, ws);
          twiddle_group<W, K, KP, INV, J>(a, g, h, w[0], ws[0], q);
          twiddle_group<W, K, KP, INV, J>(a, g, h + 1, w[1], ws[1], q);
        }
      } else {
#pragma unroll
        for (int h = 0; h < CNT; ++h) {
          T w, ws;
          load_entry<W, STRIDE>(tw, g * GS + OFF + h, w, ws);
          twiddle_group<W, K, KP, INV, J>(a, g, h, w, ws, q);
        }
      }
    }
    stages<W, K, KP, INV, STRIDE, J + 1>(a, tw, q);
  }
}

// The barrier between an exchange's writes and reads. Lane bit m holds
// element bit m below a window's lo and m + K above it, so the two windows
// agree on every lane bit from max(lo_from, lo_to) up: elements move only
// within aligned groups of 2^max(lo) lanes. A group inside a warp syncs the
// warp; a smaller part of a large block a named barrier (ids 1..8, at least
// an eighth of the block each); otherwise the whole block.
template <int LOGN, int LO_FROM, int LO_TO>
__device__ __forceinline__ void group_sync() {
  constexpr int T = row_threads(LOGN);
  constexpr int G = 1 << (LO_FROM > LO_TO ? LO_FROM : LO_TO);
  if constexpr (G <= 32 && T >= 32) {
    __syncwarp();
  } else if constexpr (G >= T || T < 256) {
    __syncthreads();
  } else {
    constexpr int COUNT = G > T / 8 ? G : T / 8;
    asm volatile("bar.sync %0, %1;" ::"r"(1 + lane_id() / COUNT), "n"(COUNT) : "memory");
  }
}

struct Nothing {
  __device__ void operator()() const {}
};

// Registers of window LO_FROM -> registers of window LO_TO through the
// exchange buffer. An element's slot never moves, and its reader in one
// exchange is its writer in the next, so no barrier is needed after the
// reads (the next row's first write waits at the top of the row loop).
// Both swizzles are linear over GF(2) and a register's element is the
// lane's bits OR the register's, so its slot is the lane's slot XOR a
// constant: one instruction an element. `after_write` runs after the
// barrier, once every thread of the block has passed it.
template <class W, int LOGN, int LO_FROM, int LO_TO, class After = Nothing>
__device__ __forceinline__ void exchange(typename W::T (&a)[1 << reg_bits(LOGN)],
                                         typename W::T* xb, const After& after_write = After()) {
  constexpr int K = reg_bits(LOGN);
  const int from = W::xslot(element<LO_FROM, K>(lane_id(), 0));
#pragma unroll
  for (int i = 0; i < (1 << K); ++i) xb[from ^ W::xslot(i << LO_FROM)] = a[i];
  if constexpr (std::is_same_v<After, Nothing>) {
    group_sync<LOGN, LO_FROM, LO_TO>();
  } else {
    __syncthreads();
    after_write();
  }
  const int to = W::xslot(element<LO_TO, K>(lane_id(), 0));
#pragma unroll
  for (int i = 0; i < (1 << K); ++i) a[i] = xb[to ^ W::xslot(i << LO_TO)];
}

// `first_write` runs after the first exchange's barrier, when every thread
// has read its first window
template <class W, int LOGN, bool INV, int S = 0, class After = Nothing>
__device__ __forceinline__ void passes(typename W::T (&a)[1 << reg_bits(LOGN)],
                                       typename W::T* xb, const unsigned char* tl,
                                       typename W::T q, const After& first_write = After()) {
  constexpr int K = reg_bits(LOGN), P = num_passes(LOGN);
  constexpr int F = INV ? P - 1 - S : S;
  constexpr int LO = window_lo(LOGN, F), KP = window_kp(LOGN, F);
  constexpr int V = 16 / W::kEntryBytes;                       // entries per 16-byte vector
  constexpr int STRIDE = (row_threads(LOGN) >> LO) * 16;       // one vector of every group
  const unsigned char* tw = tl + static_cast<size_t>(table_offset(LOGN, INV, S)) *
                                     W::kEntryBytes + (lane_id() >> LO) * 16;
  static_assert(V == 1 || V == 2, "a vector holds one or two entries");
  stages<W, K, KP, INV, STRIDE>(a, tw, q);
  if constexpr (S + 1 < P) {
    constexpr int LO_NEXT = window_lo(LOGN, INV ? P - 2 - S : S + 1);
    exchange<W, LOGN, LO, LO_NEXT>(a, xb, first_write);
    passes<W, LOGN, INV, S + 1>(a, xb, tl, q);
  }
}

// ---------------------------------------------------------------------------
// a row in and out of the pass layout (B1, B5 and the fused kernels B3, B4)
// ---------------------------------------------------------------------------

// Row xr into the registers of the direction's first window, straight from
// device memory: read in the top window, where a warp's lanes hold
// consecutive elements (the inverse perm entry reads the perm layout); the
// inverse, which starts in the chunk window, goes there through one exchange
// of xb.
template <class W, int LOGN, bool INV, bool PERM = false>
__device__ __forceinline__ void load_row(typename W::T (&a)[1 << reg_bits(LOGN)],
                                         const int64_t* __restrict__ xr, typename W::T* xb) {
  constexpr int K = reg_bits(LOGN), TOP = window_lo(LOGN, 0);
  const int lane = lane_id();
#pragma unroll
  for (int i = 0; i < (1 << K); ++i) {
    int idx = element<TOP, K>(lane, i);
    if constexpr (PERM && INV) idx = perm_pos<LOGN>(idx);
    a[i] = static_cast<typename W::T>(xr[idx]);
  }
  if constexpr (INV && num_passes(LOGN) > 1) exchange<W, LOGN, TOP, 0>(a, xb);
}

// The epilogue: the canonical residue, times the per-limb post constant
// (pv, its Shoup companion pvs) where `post` is set.
template <class W, int E>
__device__ __forceinline__ void epilogue(typename W::T (&a)[E], typename W::T q, bool post,
                                         typename W::T pv, typename W::T pvs) {
  if (post) {
#pragma unroll
    for (int i = 0; i < E; ++i) a[i] = W::canon(W::shoup_lazy(a[i], pv, pvs, q), q);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) a[i] = W::canon(a[i], q);
  }
}

// The registers of the direction's last window to row yr in the top window;
// the forward, which ends in the chunk window, goes there through one
// exchange of xb.
template <class W, int LOGN, bool INV>
__device__ __forceinline__ void store_row(typename W::T (&a)[1 << reg_bits(LOGN)],
                                          int64_t* __restrict__ yr, typename W::T* xb) {
  constexpr int K = reg_bits(LOGN), TOP = window_lo(LOGN, 0);
  if constexpr (!INV && num_passes(LOGN) > 1) exchange<W, LOGN, 0, TOP>(a, xb);
  const int out_lane = lane_id();
#pragma unroll
  for (int i = 0; i < (1 << K); ++i) yr[element<TOP, K>(out_lane, i)] = static_cast<int64_t>(a[i]);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

template <int LOGN>
__device__ __forceinline__ void stage_row(int64_t* stage, const int64_t* src, int lane) {
  constexpr int CHUNKS = 1 << (LOGN - 1), T = row_threads(LOGN);
#pragma unroll
  for (int c = lane; c < CHUNKS; c += T) cp_async16(stage + sswz(2 * c), src + 2 * c);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// B1 and B5's end of a row: the canonical residue times the per-limb post
// constant (where `post` is set), stored as int64 in the top window, or in
// the perm layout (the forward perm entry).
template <class W, int LOGN, bool INV, bool PERM>
struct StoreRow {
  using T = typename W::T;
  int64_t* y;
  const T* post;
  const T* posts;

  __device__ __forceinline__ void operator()(T (&a)[1 << reg_bits(LOGN)], T* xb, int row,
                                             int limb, T q) const {
    constexpr int K = reg_bits(LOGN), E = 1 << K, TOP = window_lo(LOGN, 0);
    epilogue<W>(a, q, post != nullptr, post != nullptr ? post[limb] : T(0),
                post != nullptr ? posts[limb] : T(0));
    int64_t* yr = y + static_cast<size_t>(row) * (1 << LOGN);
    if constexpr (PERM && !INV) {
      // the perm layout: the chunk window goes to the exchange buffer and each
      // thread stores consecutive positions, fetching each one's element
      const int from = W::xslot(element<0, K>(lane_id(), 0));
#pragma unroll
      for (int i = 0; i < E; ++i) xb[from ^ W::xslot(i)] = a[i];
      __syncthreads();
      const int out_lane = lane_id();
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int pos = element<TOP, K>(out_lane, i);
        yr[pos] = static_cast<int64_t>(xb[W::xslot(perm_element<LOGN>(pos))]);
      }
    } else {
      store_row<W, LOGN, INV>(a, yr, xb);
    }
  }
};

// Persistent blocks walk the rows of x; each row is transformed in registers
// and handed, in the direction's last window, to `end(a, xb, row, limb, q)`
// (B1 and B5: StoreRow; the fused kernels' row-local steps otherwise).
template <class W, int LOGN, bool INV, bool PERM, class End>
__global__ void __launch_bounds__(row_threads(LOGN))
ntt_kernel(const int64_t* __restrict__ x, int rows, int limbs,
           const unsigned char* __restrict__ tw, const typename W::T* __restrict__ qv, End end) {
  using T = typename W::T;
  constexpr int N = 1 << LOGN, K = reg_bits(LOGN), E = 1 << K, P = num_passes(LOGN);
  constexpr bool STAGE = W::stages(LOGN);
  // device memory is read in the top window, where a warp's lanes hold
  // consecutive elements; the inverse starts in the chunk window
  constexpr int TOP = window_lo(LOGN, 0);
  constexpr int LO_IN = INV ? 0 : TOP;
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* stage = reinterpret_cast<int64_t*>(smem);
  T* xb = reinterpret_cast<T*>(smem + (STAGE ? 8 * N : 0));
  int row = blockIdx.x;
  if (STAGE && row < rows) stage_row<LOGN>(stage, x + static_cast<size_t>(row) * N, lane_id());
  for (; row < rows; row += gridDim.x) {
    const int limb = row % limbs;
    const T q = qv[limb];
    T a[E];
    if constexpr (STAGE) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // the staged row has landed; the last row's exchange is read

    // the first window (the inverse perm entry reads the perm layout)
    const int lane = lane_id();
    if constexpr (STAGE) {
      if constexpr (PERM && INV) {
#pragma unroll
        for (int i = 0; i < E; ++i)
          a[i] = static_cast<T>(stage[sswz(perm_pos<LOGN>(element<0, K>(lane, i)))]);
      } else if constexpr (LO_IN == 0) {
        const int base = sswz(element<0, K>(lane, 0));    // sswz is linear too
#pragma unroll
        for (int i = 0; i < E; i += 2) {       // consecutive pairs, 16 bytes a read
          const longlong2 v = *reinterpret_cast<const longlong2*>(stage + (base ^ sswz(i)));
          a[i] = static_cast<T>(v.x);
          a[i + 1] = static_cast<T>(v.y);
        }
      } else {
        const int base = sswz(element<LO_IN, K>(lane, 0));
#pragma unroll
        for (int i = 0; i < E; ++i) a[i] = static_cast<T>(stage[base ^ sswz(i << LO_IN)]);
      }
    } else {
      load_row<W, LOGN, INV, PERM>(a, x + static_cast<size_t>(row) * N, xb);
    }

    const unsigned char* tl = tw + static_cast<size_t>(limb) * table_entries(LOGN) *
                                       W::kEntryBytes;
    if constexpr (STAGE) {
      // the staging buffer is free once every thread has read its first
      // window: fetch the next row behind the passes
      const auto fetch_next = [&] {
        if (row + static_cast<int>(gridDim.x) < rows)
          stage_row<LOGN>(stage, x + static_cast<size_t>(row + gridDim.x) * N, lane_id());
      };
      // it is issued after the first exchange's barrier, which serves both
      if constexpr (P == 1) {
        __syncthreads();
        fetch_next();
        passes<W, LOGN, INV>(a, xb, tl, q);
      } else {
        passes<W, LOGN, INV>(a, xb, tl, q, fetch_next);
      }
    } else {
      passes<W, LOGN, INV>(a, xb, tl, q);
    }
    end(a, xb, row, limb, q);
  }
}

// Set the kernel's shared-memory attribute and ask the occupancy calculator
// how many of its blocks an SM holds.
template <class W, int LOGN, bool INV, bool PERM, class End = StoreRow<W, LOGN, INV, PERM>>
int blocks_per_sm(int* per_sm) {
  auto kernel = ntt_kernel<W, LOGN, INV, PERM, End>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         W::smem_bytes(LOGN));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, row_threads(LOGN),
                                                        W::smem_bytes(LOGN));
  return static_cast<int>(err);
}

// Launch the rows of x with `end` on `stream`. The attribute and the
// persistent grid (blocks per SM times the SMs) are set up once per kernel
// and device.
template <class W, int LOGN, bool INV, bool PERM, class End>
int launch_rows(const int64_t* x, int rows, int limbs, const void* tw, const void* q,
                const End& end, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static int grid_of[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid_of[dev] == 0) {
    int per_sm = 0, sms = 0;
    int e = blocks_per_sm<W, LOGN, INV, PERM, End>(&per_sm);
    if (e != 0) return e;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_of[dev] = per_sm * sms;
  }
  const int grid = rows < grid_of[dev] ? rows : grid_of[dev];
  ntt_kernel<W, LOGN, INV, PERM, End><<<grid, row_threads(LOGN), W::smem_bytes(LOGN), stream>>>(
      x, rows, limbs, static_cast<const unsigned char*>(tw),
      static_cast<const typename W::T*>(q), end);
  return static_cast<int>(cudaGetLastError());
}

// B1 and B5: x -> y, int64 rows.
template <class W, int LOGN, bool INV, bool PERM>
int launch(const int64_t* x, int64_t* y, int rows, int limbs, const void* tw, const void* q,
           const void* post, const void* posts, cudaStream_t stream) {
  using T = typename W::T;
  return launch_rows<W, LOGN, INV, PERM>(
      x, rows, limbs, tw, q,
      StoreRow<W, LOGN, INV, PERM>{y, static_cast<const T*>(post), static_cast<const T*>(posts)},
      stream);
}

// f(std::integral_constant<int, logn>) for logn known at run time, 1 <= logn <= MAX_LOGN
template <int MAX_LOGN, int LOGN = 1, class F>
int by_logn(int logn, const F& f) {
  if constexpr (LOGN > MAX_LOGN) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (logn == LOGN) return f(std::integral_constant<int, LOGN>{});
    return by_logn<MAX_LOGN, LOGN + 1>(logn, f);
  }
}

template <class W, int MAX_LOGN, bool INV, bool PERM>
int dispatch(int logn, const int64_t* x, int64_t* y, int rows, int limbs, const void* tw,
             const void* q, const void* post, const void* posts, cudaStream_t stream) {
  return by_logn<MAX_LOGN>(logn, [&](auto size) -> int {
    constexpr int LOGN = decltype(size)::value;
    if constexpr (PERM && LOGN < 7)
      return static_cast<int>(cudaErrorInvalidValue);   // the perm layout needs 128 | n
    else
      return launch<W, LOGN, INV, PERM>(x, y, rows, limbs, tw, q, post, posts, stream);
  });
}

// Blocks per SM of the direction's kernel at 2^logn, or minus a cudaError_t.
template <class W, int MAX_LOGN, bool INV>
int occupancy(int logn) {
  return by_logn<MAX_LOGN>(logn, [](auto size) -> int {
    int per_sm = 0;
    const int err = blocks_per_sm<W, decltype(size)::value, INV, false>(&per_sm);
    return err != 0 ? -err : per_sm;
  });
}

}  // namespace ntt
