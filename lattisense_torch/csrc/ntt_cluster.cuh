// Kernel B5 above its row kernel's cap: the 64-bit negacyclic NTT and inverse
// NTT of rows of 2^15 and 2^16 residues in one launch, each row held by the
// blocks of one thread-block cluster.
//
// Replaces the phase split of lattisense_tpu/ops/ntt_pallas.py (`_launch` with
// `_phase1_kernel` / `_phase2_kernel`, `_ilaunch` with `_iphase_a_kernel` /
// `_iphase_b_kernel`, `_claunch` with `_cinv1_kernel` / `_cinv2_kernel`: a
// first pallas_call over the stages whose butterflies span more than one
// on-chip block, a second over the rest). For n = 2^logn, sub-rows of 2^LOGS
// and K = logn - LOGS, a cluster of C = 2^K blocks holds one row, block s
// (its rank in the cluster) owning sub-row s, elements [s 2^LOGS, (s+1) 2^LOGS),
// in its exchange buffer, at the row kernel's swizzled slots:
//
// - Forward (Cooley-Tukey, natural -> bit-reversed). The K stages that pair
//   elements n/2 .. n/2^K apart span the sub-rows. Block s runs them for its
//   1/C of the columns: thread `lane` takes columns c = s 2^LOGS / C +
//   j T + lane (j < 16 / C, T threads a block), reads the C cells
//   c + r 2^LOGS of each straight from device memory (a warp's lanes on
//   consecutive addresses), runs the K stages in registers with the word's
//   lazy Shoup butterflies and psi_rev[1 .. C - 1] (as csrc/ntt_columns.cuh
//   does), and writes cell r to block r's exchange buffer through distributed
//   shared memory. After a cluster barrier each block runs the row kernel's
//   passes on its sub-row, taking its first window from its own buffer (the
//   slots a thread reads there are the ones its first exchange writes, so no
//   barrier is needed between), with the virtual-limb tables of
//   ops/ntt_cuda.py `split_pass_tables`, and stores through `StoreRow`
//   with the canonical (or to-Montgomery) epilogue.
// - Inverse (Gentleman-Sande, bit-reversed -> natural). Each block runs the
//   row kernel's passes on its sub-row first (`load_row`, `passes`) and parks
//   its last window in its own buffer; after a cluster barrier block s reads
//   the C cells of its columns from the C buffers, runs stages
//   m = C/2 .. 1 with psi_inv_rev[1 .. C - 1], applies the n^-1 (or
//   n^-1 2^-64, the from-Montgomery folded in) epilogue once, and stores the
//   canonical residues straight to device memory. A last cluster barrier
//   keeps every buffer alive until its readers are done.
//
// So a row crosses device memory once each way in one launch, against the
// two launches meeting in device memory of the columns-then-rows split. The
// cross stages' values stay lazy ([0, 4q) forward, [0, 2q) inverse), which
// the row body's butterflies take as they are.
//
// What bounds it: as B5 at 2^14, the 64-bit integer multiplies (about 20
// IMAD a butterfly) more than the 16 bytes a residue; the cross stages add
// the distributed-shared-memory traffic of one row each way. One cluster a
// row (no persistent loop): a row's blocks start together and leave after
// their last barrier.

#pragma once

#include <cooperative_groups.h>

#include "ntt_passes.cuh"

namespace ntt {

// The K column stages on the registers of COLS columns, a[col * 2^K + r]
// holding cell r of column col; `ct` is the limb's column table, 2^K
// (value, Shoup companion) pairs, entry h at 2h: forward stage m = 2^j pairs
// registers 2^(K-1-j) apart, block r >> (K-j); inverse stage m = 2^(K-1-j)
// pairs them 2^j apart, block r >> (j+1).
template <int K, int COLS, bool INV>
__device__ __forceinline__ void column_stages(uint64_t (&a)[COLS << K],
                                              const uint64_t* __restrict__ ct, uint64_t q) {
  constexpr int C = 1 << K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int dist = INV ? (1 << j) : (1 << (K - 1 - j));
    const int m = INV ? (1 << (K - 1 - j)) : (1 << j);
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (r & dist) continue;
      const int h = m + (INV ? (r >> (j + 1)) : (r >> (K - j)));
      const uint64_t w = __ldg(ct + 2 * h), ws = __ldg(ct + 2 * h + 1);
#pragma unroll
      for (int col = 0; col < COLS; ++col) {
        if constexpr (INV)
          W64::inv(a[col * C + r], a[col * C + r + dist], w, ws, q);
        else
          W64::fwd(a[col * C + r], a[col * C + r + dist], w, ws, q);
      }
    }
  }
}

// Row blockIdx.x / 2^K of x -> y (int64 rows of 2^(LOGS + K)), limb
// row % limbs. `tw` is the virtual limbs' pass table (limbs 2^K,
// table_entries(LOGS), 2), `ctw` the limbs' column tables (limbs, 2^K, 2),
// `qv` the limbs' primes; `post`/`posts` per virtual limb (value, Shoup
// companion) multiplied into every output, or null (forward only).
template <int LOGS, int K, bool INV>
__global__ void __launch_bounds__(row_threads(LOGS))
cluster_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ y, int limbs,
               const unsigned char* __restrict__ tw, const uint64_t* __restrict__ ctw,
               const uint64_t* __restrict__ qv, const uint64_t* __restrict__ post,
               const uint64_t* __restrict__ posts) {
  using W = W64;
  using T = uint64_t;
  constexpr int C = 1 << K, SUB = 1 << LOGS, KR = reg_bits(LOGS), E = 1 << KR;
  constexpr int THREADS = row_threads(LOGS), TOP = window_lo(LOGS, 0), COLS = E / C;
  static_assert(K >= 1 && C <= E, "a thread takes whole columns");
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  T* xb = reinterpret_cast<T*>(smem);

  const int s = static_cast<int>(cluster.block_rank());
  const size_t row = blockIdx.x / C;
  const int limb = static_cast<int>(row % static_cast<size_t>(limbs));
  const int vlimb = limb * C + s;
  const T q = qv[limb];
  const T* ct = ctw + static_cast<size_t>(limb) * 2 * C;
  const unsigned char* tl = tw + static_cast<size_t>(vlimb) * table_entries(LOGS) * W::kEntryBytes;
  const int64_t* xr = x + row * (static_cast<size_t>(SUB) << K);
  T a[E];

  if constexpr (!INV) {
    const int col0 = s * (SUB / C) + lane_id();
#pragma unroll
    for (int j = 0; j < COLS; ++j)
#pragma unroll
      for (int r = 0; r < C; ++r)
        a[j * C + r] = static_cast<T>(xr[static_cast<size_t>(r) * SUB + col0 + j * THREADS]);
    column_stages<K, COLS, false>(a, ct, q);
#pragma unroll
    for (int r = 0; r < C; ++r) {
      T* dst = cluster.map_shared_rank(xb, r);
#pragma unroll
      for (int j = 0; j < COLS; ++j) dst[W::xslot(col0 + j * THREADS)] = a[j * C + r];
    }
    cluster.sync();   // every cell has landed in its owner's buffer
    const int top = W::xslot(element<TOP, KR>(lane_id(), 0));
#pragma unroll
    for (int i = 0; i < E; ++i) a[i] = xb[top ^ W::xslot(i << TOP)];
    passes<W, LOGS, false>(a, xb, tl, q);
    StoreRow<W, LOGS, false, false>{y, post, posts}(a, xb, static_cast<int>(row) * C + s, vlimb,
                                                    q);
  } else {
    load_row<W, LOGS, true>(a, xr + static_cast<size_t>(s) * SUB, xb);
    passes<W, LOGS, true>(a, xb, tl, q);
    // the last window to the slots the thread read it from
    const int top = W::xslot(element<TOP, KR>(lane_id(), 0));
#pragma unroll
    for (int i = 0; i < E; ++i) xb[top ^ W::xslot(i << TOP)] = a[i];
    cluster.sync();   // every sub-row's last window is parked
    const int col0 = s * (SUB / C) + lane_id();
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const T* src = cluster.map_shared_rank(xb, r);
#pragma unroll
      for (int j = 0; j < COLS; ++j) a[j * C + r] = src[W::xslot(col0 + j * THREADS)];
    }
    column_stages<K, COLS, true>(a, ct, q);
    const bool scale = post != nullptr;
    epilogue<W>(a, q, scale, scale ? post[vlimb] : T(0), scale ? posts[vlimb] : T(0));
    int64_t* yr = y + row * (static_cast<size_t>(SUB) << K);
#pragma unroll
    for (int j = 0; j < COLS; ++j)
#pragma unroll
      for (int r = 0; r < C; ++r)
        yr[static_cast<size_t>(r) * SUB + col0 + j * THREADS] = static_cast<int64_t>(a[j * C + r]);
    cluster.sync();   // no block leaves while another still reads its buffer
  }
}

// Launch the cluster kernel over `rows` rows of 2^(LOGS + K) on `stream`:
// grid rows * 2^K blocks, clusters of 2^K along x, 8 * 2^LOGS bytes of
// dynamic shared memory. The attribute is set and the occupancy calculator
// asked once per device; a card on which no such cluster fits gets
// cudaErrorInvalidConfiguration before any launch.
template <int LOGS, int K, bool INV>
int launch_cluster(const int64_t* x, int64_t* y, int rows, int limbs, const void* tw,
                   const void* ctw, const void* q, const void* post, const void* posts,
                   cudaStream_t stream, int* active_clusters = nullptr) {
  constexpr int kMaxDevices = 64, SMEM = 8 << LOGS;
  static int ready[kMaxDevices] = {};   // 0: not asked, > 0: clusters that fit, < 0: error
  auto kernel = cluster_kernel<LOGS, K, INV>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(row_threads(LOGS), 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (ready[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    int fit = 0;
    if (err == cudaSuccess) {
      cfg.gridDim = dim3(1 << K, 1, 1);
      err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = fit > 0 ? fit : -static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (active_clusters != nullptr) *active_clusters = ready[dev];
  if (ready[dev] < 0) return -ready[dev];
  if (rows <= 0) return 0;
  cfg.gridDim = dim3(static_cast<unsigned>(rows) << K, 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, x, y, limbs, static_cast<const unsigned char*>(tw),
                           static_cast<const uint64_t*>(ctw), static_cast<const uint64_t*>(q),
                           static_cast<const uint64_t*>(post), static_cast<const uint64_t*>(posts));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ntt
