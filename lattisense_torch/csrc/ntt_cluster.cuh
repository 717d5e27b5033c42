// Kernels B1 and B5 above their row kernel's cap: the negacyclic NTT and
// inverse NTT of long rows in one launch, each row held by the blocks of one
// thread-block cluster; written for either word (B5: 64-bit rows of 2^15
// and 2^16, B1: 32-bit rows of 2^15 and 2^16). The cluster body is shared:
// kernels B2 and B4 (csrc/behz32.cu) run `cluster_kernel` with rows of their
// own (the load and the end of a row are the `Io` policy the kernel takes,
// as `ntt_kernel`'s row end is for the row loop), and kernel B3's cluster
// route (csrc/ksw32.cu) calls its forward and inverse trips between steps
// of its own.
//
// Replaces the phase split of lattisense_tpu/ops/ntt_pallas.py (`_launch` with
// `_phase1_kernel` / `_phase2_kernel`, `_ilaunch` with `_iphase_a_kernel` /
// `_iphase_b_kernel`, `_claunch` with `_cinv1_kernel` / `_cinv2_kernel`: a
// first pallas_call over the stages whose butterflies span more than one
// on-chip block, a second over the rest) for B5, and for B1 the rows of
// lattisense_tpu/ops/ntt_pallas32.py `_run` that one block does not hold.
// For n = 2^logn, sub-rows of 2^LOGS and K = logn - LOGS, a cluster of
// C = 2^K blocks holds one row, block s (its rank in the cluster) owning
// sub-row s, elements [s 2^LOGS, (s+1) 2^LOGS), in its exchange buffer, at
// the row kernel's swizzled slots:
//
// - Forward (Cooley-Tukey, natural -> bit-reversed; `forward_trip`). The K
//   stages that pair elements n/2 .. n/2^K apart span the sub-rows. Block s
//   runs them for its 1/C of the columns: thread `lane` takes columns
//   c = s 2^LOGS / C + j T + lane (j < E / C, T threads a block, E residues
//   a thread), reads the C cells c + r 2^LOGS of each straight from device
//   memory (`read_cells`, a warp's lanes on consecutive addresses, from an
//   int64 or a 32-bit row), runs the K stages in registers with the word's
//   lazy Shoup butterflies and psi_rev[1 .. C - 1], and writes cell r to
//   block r's exchange buffer through distributed shared memory (once every
//   block of the cluster has started: the barrier's arrival at the kernel's
//   start, its wait before the first write). After a cluster barrier each
//   block runs the row kernel's passes on its sub-row, taking its first
//   window from its own buffer (the slots a thread reads there are the ones
//   its first exchange writes, so no barrier is needed between), with the
//   virtual-limb tables of ops/ntt_cuda.py `split_pass_tables`, and hands the
//   sub-row, in the chunk window, to the row's end (B1 and B5: `StoreRow`
//   with the canonical or to-Montgomery epilogue).
// - Inverse (Gentleman-Sande, bit-reversed -> natural; `inverse_rows`,
//   `inverse_cells`). Each block runs the row kernel's passes on its sub-row
//   first (`load_row`, `passes`) and parks its last window in its own
//   buffer; after a cluster barrier block s reads the C cells of its columns
//   from the C buffers and runs stages m = C/2 .. 1 with
//   psi_inv_rev[1 .. C - 1]; the row's end applies the epilogue once (B1
//   and B5: n^-1, or n^-1 times the inverse Montgomery factor, the
//   from-Montgomery folded in) and stores the cells straight to device
//   memory (`write_cells`). A last cluster barrier keeps every buffer alive
//   until its readers are done.
//
// So a row crosses device memory once each way in one launch. The cross
// stages' values stay lazy (the word's ranges: [0, 4q) forward at 64
// bits, [0, 2q) otherwise), which the row body's butterflies take as they
// are; an end sees canonical residues only after its epilogue.
//
// What bounds it: at the 64-bit word the integer multiplies (about 20 IMAD
// a butterfly) more than the 16 bytes a residue; at the 32-bit word the
// bytes (a row in and out as int64, ~12 32-bit operations a butterfly).
// The cross stages add the distributed-shared-memory traffic of one row
// each way. One cluster a row (no persistent loop): a row's blocks start
// together and leave after their last barrier.

#pragma once

#include <cooperative_groups.h>

#include "ntt_passes.cuh"

namespace ntt {

namespace cg = cooperative_groups;

// The cluster kernels' sub-rows, for either word and for B3's cluster route
// (the host's SUB_LOGN, ops/ntt_cuda.py): 2^13 residues, 512 threads of 16
// and up to 128 registers. Sub-rows of 2^14 (1024 threads of at most 64
// registers) measured no faster for B1 and B3 and slower for B5 (PERF.md
// §6). Rows of 2^15 and 2^16, clusters of 4 and 8 blocks.
constexpr int kSubLogn = 13;
constexpr int kMaxLognCluster = 16;

// f(std::integral_constant<int, K>) for the cross stages K = logn - kSubLogn
// of a row of 2^logn, 2^15 or 2^16, over sub-rows of 2^logs; any other logs
// or logn is refused (cudaErrorInvalidValue).
template <class F>
int by_depth(int logn, int logs, const F& f) {
  if (logs != kSubLogn || logn <= 14 || logn > kMaxLognCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  return logn == 15 ? f(std::integral_constant<int, 15 - kSubLogn>{})
                    : f(std::integral_constant<int, 16 - kSubLogn>{});
}

// The K column stages on the registers of COLS columns, a[col * 2^K + r]
// holding cell r of column col; `ct` is the limb's column table, 2^K
// (value, Shoup companion) pairs, entry h at 2h: forward stage m = 2^j pairs
// registers 2^(K-1-j) apart, block r >> (K-j); inverse stage m = 2^(K-1-j)
// pairs them 2^j apart, block r >> (j+1).
template <class W, int K, int COLS, bool INV>
__device__ __forceinline__ void column_stages(typename W::T (&a)[COLS << K],
                                              const typename W::T* __restrict__ ct,
                                              typename W::T q) {
  using T = typename W::T;
  constexpr int C = 1 << K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int dist = INV ? (1 << j) : (1 << (K - 1 - j));
    const int m = INV ? (1 << (K - 1 - j)) : (1 << j);
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (r & dist) continue;
      const int h = m + (INV ? (r >> (j + 1)) : (r >> (K - j)));
      const T w = __ldg(ct + 2 * h), ws = __ldg(ct + 2 * h + 1);
#pragma unroll
      for (int col = 0; col < COLS; ++col) {
        if constexpr (INV)
          W::inv(a[col * C + r], a[col * C + r + dist], w, ws, q);
        else
          W::fwd(a[col * C + r], a[col * C + r + dist], w, ws, q);
      }
    }
  }
}

// The cluster barrier in halves, for a block's first access of another
// block's shared memory: each block arrives as it starts (no ordering) and
// waits before that access, so every block of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The thread's j-th column within block s's share of the sub-row.
template <int LOGS, int K>
__device__ __forceinline__ int cluster_column(int s, int j) {
  return s * ((1 << LOGS) >> K) + j * row_threads(LOGS) + lane_id();
}

// Forward: cell r of each of the thread's columns (a[j * C + r]) to its slot
// in block r's exchange buffer, through distributed shared memory.
template <class W, int LOGS, int K>
__device__ __forceinline__ void scatter_cells(cg::cluster_group& cluster,
                                              typename W::T (&a)[1 << reg_bits(LOGS)],
                                              typename W::T* xb, int s) {
  constexpr int C = 1 << K, COLS = (1 << reg_bits(LOGS)) / C;
#pragma unroll
  for (int r = 0; r < C; ++r) {
    typename W::T* dst = cluster.map_shared_rank(xb, r);
#pragma unroll
    for (int j = 0; j < COLS; ++j) dst[W::xslot(cluster_column<LOGS, K>(s, j))] = a[j * C + r];
  }
}

// Inverse: the C cells of the thread's columns from the C buffers.
template <class W, int LOGS, int K>
__device__ __forceinline__ void gather_cells(cg::cluster_group& cluster,
                                             typename W::T (&a)[1 << reg_bits(LOGS)],
                                             typename W::T* xb, int s) {
  constexpr int C = 1 << K, COLS = (1 << reg_bits(LOGS)) / C;
#pragma unroll
  for (int r = 0; r < C; ++r) {
    const typename W::T* src = cluster.map_shared_rank(xb, r);
#pragma unroll
    for (int j = 0; j < COLS; ++j) a[j * C + r] = src[W::xslot(cluster_column<LOGS, K>(s, j))];
  }
}

// The top window of a sub-row from (take) or to (park) the slots of its
// buffer: the slots a thread's first forward exchange writes, and the ones
// its last inverse exchange read.
template <class W, int LOGS>
__device__ __forceinline__ void take_top(typename W::T (&a)[1 << reg_bits(LOGS)],
                                         const typename W::T* xb) {
  constexpr int KR = reg_bits(LOGS), TOP = window_lo(LOGS, 0);
  const int top = W::xslot(element<TOP, KR>(lane_id(), 0));
#pragma unroll
  for (int i = 0; i < (1 << KR); ++i) a[i] = xb[top ^ W::xslot(i << TOP)];
}

template <class W, int LOGS>
__device__ __forceinline__ void park_top(typename W::T (&a)[1 << reg_bits(LOGS)],
                                         typename W::T* xb) {
  constexpr int KR = reg_bits(LOGS), TOP = window_lo(LOGS, 0);
  const int top = W::xslot(element<TOP, KR>(lane_id(), 0));
#pragma unroll
  for (int i = 0; i < (1 << KR); ++i) xb[top ^ W::xslot(i << TOP)] = a[i];
}

// The C cells c + r 2^LOGS of each of block s's columns (a[j C + r]) from
// row xr of device memory, whose words (int64, or a 32-bit scratch) are
// cast to the word's; a warp's lanes read consecutive addresses.
template <class W, int LOGS, int K, class In>
__device__ __forceinline__ void read_cells(typename W::T (&a)[1 << reg_bits(LOGS)],
                                           const In* __restrict__ xr, int s) {
  constexpr int C = 1 << K, SUB = 1 << LOGS, COLS = (1 << reg_bits(LOGS)) / C;
#pragma unroll
  for (int j = 0; j < COLS; ++j)
#pragma unroll
    for (int r = 0; r < C; ++r)
      a[j * C + r] = static_cast<typename W::T>(
          xr[static_cast<size_t>(r) * SUB + cluster_column<LOGS, K>(s, j)]);
}

// The cells of block s's columns to row yr of device memory, as words Out.
template <class W, int LOGS, int K, class Out>
__device__ __forceinline__ void write_cells(const typename W::T (&a)[1 << reg_bits(LOGS)],
                                            Out* __restrict__ yr, int s) {
  constexpr int C = 1 << K, SUB = 1 << LOGS, COLS = (1 << reg_bits(LOGS)) / C;
#pragma unroll
  for (int j = 0; j < COLS; ++j)
#pragma unroll
    for (int r = 0; r < C; ++r)
      yr[static_cast<size_t>(r) * SUB + cluster_column<LOGS, K>(s, j)] =
          static_cast<Out>(a[j * C + r]);
}

// The forward trip of block s on the cells of its columns (a[j C + r], as
// `read_cells` leaves them): the K cross stages with the limb's column
// table `ct`, cell r scattered to block r's buffer, and after a cluster
// barrier the row passes on sub-row s with its virtual limb's pass table
// `tl`; a ends in the chunk window. The cluster's first trip (`first`)
// waits on the arrival each block made as it started
// (`cluster_arrive_relaxed`); a later one syncs, so that no block scatters
// into a buffer its owner still reads.
template <class W, int LOGS, int K>
__device__ __forceinline__ void forward_trip(cg::cluster_group& cluster,
                                             typename W::T (&a)[1 << reg_bits(LOGS)],
                                             typename W::T* xb, int s,
                                             const typename W::T* __restrict__ ct,
                                             const unsigned char* __restrict__ tl,
                                             typename W::T q, bool first) {
  column_stages<W, K, (1 << reg_bits(LOGS)) / (1 << K), false>(a, ct, q);
  if (first)
    cluster_wait();   // every block of the cluster has started
  else
    cluster.sync();   // every block has read its buffer for the last trip
  scatter_cells<W, LOGS, K>(cluster, a, xb, s);
  cluster.sync();     // every cell has landed in its owner's buffer
  take_top<W, LOGS>(a, xb);
  passes<W, LOGS, false>(a, xb, tl, q);
}

// The inverse trip's first half: the row passes on sub-row s (a in the
// inverse's first window) and the last window parked in xb.
template <class W, int LOGS>
__device__ __forceinline__ void inverse_rows(typename W::T (&a)[1 << reg_bits(LOGS)],
                                             typename W::T* xb,
                                             const unsigned char* __restrict__ tl,
                                             typename W::T q) {
  passes<W, LOGS, true>(a, xb, tl, q);
  park_top<W, LOGS>(a, xb);
}

// Its second half, after a cluster barrier: the C cells of block s's
// columns from the buffers at xb's offset, and the K cross stages with the
// limb's column table `ct` (values lazy, in [0, 2q)).
template <class W, int LOGS, int K>
__device__ __forceinline__ void inverse_cells(cg::cluster_group& cluster,
                                              typename W::T (&a)[1 << reg_bits(LOGS)],
                                              typename W::T* xb, int s,
                                              const typename W::T* __restrict__ ct,
                                              typename W::T q) {
  gather_cells<W, LOGS, K>(cluster, a, xb, s);
  column_stages<W, K, (1 << reg_bits(LOGS)) / (1 << K), true>(a, ct, q);
}

// B1's and B5's rows: int64 rows of 2^(LOGS + K), row r at x + r n, into y.
// The forward ends in `StoreRow` (the canonical, or to-Montgomery,
// epilogue); the inverse in the epilogue with `post` (n^-1, or n^-1 times
// the inverse Montgomery factor), per virtual limb, and int64 cells.
template <class W, int LOGS, int K, bool INV>
struct Int64Rows {
  using T = typename W::T;
  static constexpr size_t N = static_cast<size_t>(1) << (LOGS + K);
  static constexpr bool kTwoBlocks = false;
  const int64_t* x;
  int64_t* y;
  const T* post;
  const T* posts;

  __device__ __forceinline__ void load(T (&a)[1 << reg_bits(LOGS)], T* xb, size_t row, int,
                                       int s) const {
    if constexpr (INV)
      load_row<W, LOGS, true>(a, x + row * N + (static_cast<size_t>(s) << LOGS), xb);
    else
      read_cells<W, LOGS, K>(a, x + row * N, s);
  }

  __device__ __forceinline__ void end(T (&a)[1 << reg_bits(LOGS)], T* xb, size_t row, int limb,
                                      int s, T q) const {
    const int vlimb = (limb << K) + s;
    if constexpr (INV) {
      const bool scale = post != nullptr;
      epilogue<W>(a, q, scale, scale ? post[vlimb] : T(0), scale ? posts[vlimb] : T(0));
      write_cells<W, LOGS, K>(a, y + row * N, s);
    } else {
      StoreRow<W, LOGS, false, false>{y, post, posts}(a, xb, static_cast<int>(row << K) + s,
                                                      vlimb, q);
    }
  }
};

// Row blockIdx.x / 2^K of `rows`, limb row % limbs, held by one cluster:
// `io.load(a, xb, row, limb, s)` brings block s its part of the row (the
// forward: the cells of its columns; the inverse: sub-row s in the
// inverse's first window) and `io.end(a, xb, row, limb, s, q)` takes it
// after the transform (the forward: sub-row s in the chunk window, values
// lazy; the inverse: the cells of its columns after the cross stages,
// lazy). `tw` is the virtual limbs' pass table (limbs 2^K,
// table_entries(LOGS), 2), `ctw` the limbs' column tables (limbs, 2^K, 2),
// `qv` the limbs' primes.
template <class W, int LOGS, int K, bool INV, class Io>
__device__ __forceinline__ void cluster_rows(const Io& io, int limbs,
                                             const unsigned char* __restrict__ tw,
                                             const typename W::T* __restrict__ ctw,
                                             const typename W::T* __restrict__ qv) {
  using T = typename W::T;
  constexpr int C = 1 << K, E = 1 << reg_bits(LOGS);
  static_assert(K >= 1 && C <= E, "a thread takes whole columns");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  T* xb = reinterpret_cast<T*>(smem);

  const int s = static_cast<int>(cluster.block_rank());
  const size_t row = blockIdx.x / C;
  const int limb = static_cast<int>(row % static_cast<size_t>(limbs));
  const T q = qv[limb];
  const T* ct = ctw + static_cast<size_t>(limb) * 2 * C;
  const unsigned char* tl =
      tw + static_cast<size_t>(limb * C + s) * table_entries(LOGS) * W::kEntryBytes;
  T a[E];

  if constexpr (!INV) {
    cluster_arrive_relaxed();
    io.load(a, xb, row, limb, s);
    forward_trip<W, LOGS, K>(cluster, a, xb, s, ct, tl, q, true);
    io.end(a, xb, row, limb, s, q);
  } else {
    io.load(a, xb, row, limb, s);
    inverse_rows<W, LOGS>(a, xb, tl, q);
    cluster.sync();   // every sub-row's last window is parked
    inverse_cells<W, LOGS, K>(cluster, a, xb, s, ct, q);
    io.end(a, xb, row, limb, s, q);
    cluster.sync();   // no block leaves while another still reads its buffer
  }
}

// The cluster kernel: `cluster_rows` with the registers the compiler picks
// (B1's instances take 48-63, B5's up to 128)...
template <class W, int LOGS, int K, bool INV, class Io>
__global__ void __launch_bounds__(row_threads(LOGS))
cluster_kernel(Io io, int limbs, const unsigned char* __restrict__ tw,
               const typename W::T* __restrict__ ctw, const typename W::T* __restrict__ qv) {
  cluster_rows<W, LOGS, K, INV>(io, limbs, tw, ctw, qv);
}

// ... or held to two blocks an SM (64 registers a thread at 512 threads),
// for rows whose ends carry more than B1's (`Io::kTwoBlocks`: B2's and
// B4's, which took up to 74 registers and one block an SM without it).
template <class W, int LOGS, int K, bool INV, class Io>
__global__ void __launch_bounds__(row_threads(LOGS), 2)
cluster_kernel_two_blocks(Io io, int limbs, const unsigned char* __restrict__ tw,
                          const typename W::T* __restrict__ ctw,
                          const typename W::T* __restrict__ qv) {
  cluster_rows<W, LOGS, K, INV>(io, limbs, tw, ctw, qv);
}

constexpr int kMaxClusterDevices = 64;

// Launch `clusters` clusters of C blocks of `kernel` (`threads` a block,
// `smem` bytes of dynamic shared memory) on `stream` with `args`. The
// shared-memory attribute is set and the occupancy calculator asked once per
// device (`ready`, the caller's record: 0 not asked, > 0 the clusters that
// fit, < 0 an error); a card on which no such cluster fits gets
// cudaErrorInvalidConfiguration before any launch. `fit` (if set) receives
// the clusters that fit. clusters == 0 only asks.
template <class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), int clusters, int C, int threads, int smem,
                    int (&ready)[kMaxClusterDevices], cudaStream_t stream, int* fit,
                    Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxClusterDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (ready[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int got = 0;
    if (err == cudaSuccess) {
      cfg.gridDim = dim3(C, 1, 1);
      err = cudaOccupancyMaxActiveClusters(&got, kernel, &cfg);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = got > 0 ? got : -static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (fit != nullptr) *fit = ready[dev];
  if (ready[dev] < 0) return -ready[dev];
  if (clusters <= 0) return 0;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters) * C, 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch the cluster kernel over `rows` rows of 2^(LOGS + K) with `io` on
// `stream`: grid rows * 2^K blocks, clusters of 2^K along x, sizeof(T) *
// 2^LOGS bytes of dynamic shared memory (see `launch_clusters`; `ready` is
// the caller's record, one per kernel instance).
template <class W, int LOGS, int K, bool INV, class Io>
int launch_rows_cluster(const Io& io, int rows, int limbs, const void* tw, const void* ctw,
                        const void* q, int (&ready)[kMaxClusterDevices], cudaStream_t stream,
                        int* active_clusters = nullptr) {
  using T = typename W::T;
  const auto go = [&](auto kernel) {
    return launch_clusters(kernel, rows, 1 << K, row_threads(LOGS),
                           static_cast<int>(sizeof(T)) << LOGS, ready, stream, active_clusters,
                           io, limbs, static_cast<const unsigned char*>(tw),
                           static_cast<const T*>(ctw), static_cast<const T*>(q));
  };
  if constexpr (Io::kTwoBlocks)
    return go(cluster_kernel_two_blocks<W, LOGS, K, INV, Io>);
  else
    return go(cluster_kernel<W, LOGS, K, INV, Io>);
}

// B1's and B5's rows x -> y (`Int64Rows`); `post`/`posts` per virtual limb
// (value, Shoup companion) multiplied into every output, or null (forward
// only).
template <class W, int LOGS, int K, bool INV>
int launch_cluster(const int64_t* x, int64_t* y, int rows, int limbs, const void* tw,
                   const void* ctw, const void* q, const void* post, const void* posts,
                   cudaStream_t stream, int* active_clusters = nullptr) {
  using T = typename W::T;
  static int ready[kMaxClusterDevices] = {};
  return launch_rows_cluster<W, LOGS, K, INV>(
      Int64Rows<W, LOGS, K, INV>{x, y, static_cast<const T*>(post), static_cast<const T*>(posts)},
      rows, limbs, tw, ctw, q, ready, stream, active_clusters);
}

// launch_cluster for rows of 2^logn over sub-rows of 2^logs (`by_depth`).
template <class W, bool INV>
int launch_cluster_at(int logn, int logs, const int64_t* x, int64_t* y, int rows, int limbs,
                      const void* tw, const void* ctw, const void* q, const void* post,
                      const void* posts, void* stream, int* active_clusters) {
  return by_depth(logn, logs, [&](auto depth) -> int {
    return launch_cluster<W, kSubLogn, decltype(depth)::value, INV>(
        x, y, rows, limbs, tw, ctw, q, post, posts, static_cast<cudaStream_t>(stream),
        active_clusters);
  });
}

}  // namespace ntt
