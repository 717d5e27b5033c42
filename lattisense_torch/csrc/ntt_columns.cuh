// The split of kernel B1 (csrc/ntt32.cu) for rows longer than the row kernel
// of csrc/ntt_passes.cuh holds in shared memory (2^15 32-bit words): the
// columns kernel. It is written for either word; B5 (csrc/ntt64.cu) takes
// its rows of 2^15 and 2^16 in one launch instead (csrc/ntt_cluster.cuh).
//
// Replaces the phase split of lattisense_tpu/ops/ntt_pallas.py (`_launch`,
// `_ilaunch`, `_claunch`: a first pallas_call over the stages whose
// butterflies span more than one on-chip block, a second over the rest),
// which serves the u64 transforms at every n. For n = 2^logn, row cap 2^R
// and k = logn - R:
//
// - Forward (Cooley-Tukey, natural -> bit-reversed). Stages m = 1 .. 2^(k-1)
//   pair elements n/2 .. n/2^k apart. The columns kernel runs them: thread
//   (row, c) holds the 2^k elements c + s * n_sub of column c
//   (n_sub = n / 2^k, s < 2^k) in registers, at stride n_sub, runs the k
//   stages with the word's lazy Shoup butterflies and the table entries
//   psi_rev[1 .. 2^k - 1], and stores canonical residues. Each sub-row s
//   (elements [s * n_sub, (s + 1) * n_sub)) then needs only its own stages,
//   which the row kernel runs at log2 n_sub with sub-row s as a limb of its
//   own: the twiddle of local stage m' and block i' is
//   psi_rev[2^k * m' + s * m' + i'] (ops/ntt_cuda.py `split_indices`).
// - Inverse (Gentleman-Sande, bit-reversed -> natural). The row kernel runs
//   first on the sub-rows with tables re-indexed the same way from
//   psi_inv_rev and the full n^-1 as its epilogue (the transform is linear,
//   so scaling before the last k stages is exact); then the columns kernel
//   runs stages m = 2^(k-1) .. 1 with psi_inv_rev[1 .. 2^k - 1].
//
// What bounds it: the split moves the stack through device memory twice
// (once per launch) against B1's once, so it can reach at most half of its
// byte bound. The columns kernel does k butterflies an element pair and is
// bound by bytes: a warp reads and writes 256 contiguous bytes per
// register; its twiddles (2^k - 1 per limb) are broadcast loads.

#pragma once

#include "ntt_passes.cuh"

namespace ntt {

constexpr int kColumnThreads = 256;

// The k column stages of every (row, column) cell: x -> y, int64 rows of
// 2^(logsub + K) residues, row r on limb r % limbs. `tw` holds per limb 2^K
// (value, Shoup companion) pairs of the word, entry h at 2h (entry 0 unused):
// psi_rev[h] forward, psi_inv_rev[h] inverse. In place (x == y) is safe:
// each thread reads and writes only its own cells.
template <class W, int K, bool INV>
__global__ void __launch_bounds__(kColumnThreads)
columns_kernel(const int64_t* x, int64_t* y, size_t cells, int logsub, int limbs,
               const typename W::T* __restrict__ tw, const typename W::T* __restrict__ qv) {
  using T = typename W::T;
  constexpr int E = 1 << K;
  const size_t cell = static_cast<size_t>(blockIdx.x) * kColumnThreads + threadIdx.x;
  if (cell >= cells) return;
  const size_t row = cell >> logsub;
  const size_t base = (row << (logsub + K)) | (cell & ((static_cast<size_t>(1) << logsub) - 1));
  const int limb = static_cast<int>(row % static_cast<size_t>(limbs));
  const T q = qv[limb];
  const T* t = tw + static_cast<size_t>(limb) * 2 * E;
  T a[E];
#pragma unroll
  for (int s = 0; s < E; ++s) a[s] = static_cast<T>(x[base + (static_cast<size_t>(s) << logsub)]);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    // forward stage m = 2^j: pairs 2^(K-1-j) registers apart, block r >> (K-j);
    // inverse stage m = 2^(K-1-j): pairs 2^j apart, block r >> (j+1)
    const int dist = INV ? (1 << j) : (1 << (K - 1 - j));
    const int m = INV ? (1 << (K - 1 - j)) : (1 << j);
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (r & dist) continue;
      const int h = m + (INV ? (r >> (j + 1)) : (r >> (K - j)));
      if constexpr (INV)
        W::inv(a[r], a[r + dist], t[2 * h], t[2 * h + 1], q);
      else
        W::fwd(a[r], a[r + dist], t[2 * h], t[2 * h + 1], q);
    }
  }
#pragma unroll
  for (int s = 0; s < E; ++s)
    y[base + (static_cast<size_t>(s) << logsub)] = static_cast<int64_t>(W::canon(a[s], q));
}

// Launch the column stages of a split at depth k (1 <= k <= MAX_K) over
// `rows` rows of 2^logn residues on `stream`; `tw` is the direction's
// (limbs, 2^k, 2) column table, `q` the limbs' primes.
template <class W, int MAX_K, bool INV>
int launch_columns(const int64_t* x, int64_t* y, int rows, int limbs, int logn, int k,
                   const void* tw, const void* q, cudaStream_t stream) {
  if (rows < 0 || limbs < 1 || k < 1 || k > MAX_K || logn <= k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int logsub = logn - k;
  const size_t cells = static_cast<size_t>(rows) << logsub;
  if (cells == 0) return 0;
  const unsigned grid = static_cast<unsigned>((cells + kColumnThreads - 1) / kColumnThreads);
  // by_logn serves any run-time value 1 .. MAX_K
  return by_logn<MAX_K>(k, [&](auto depth) -> int {
    constexpr int K = decltype(depth)::value;
    columns_kernel<W, K, INV><<<grid, kColumnThreads, 0, stream>>>(
        x, y, cells, logsub, limbs, static_cast<const typename W::T*>(tw),
        static_cast<const typename W::T*>(q));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace ntt
