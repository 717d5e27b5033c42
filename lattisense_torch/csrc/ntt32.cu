// Kernel B1: negacyclic NTT / inverse NTT over 31-bit primes.
//
// Replaces lattisense_tpu/ops/ntt_pallas32.py `ntt_fused32` / `intt_fused32`
// (kernels `_fwd_kernel` and `_inv_kernel`): forward Cooley-Tukey, natural ->
// bit-reversed order; inverse Gentleman-Sande, bit-reversed -> natural with the
// n^-1 scale. Butterflies are lazy Shoup multiplications (R = 2^32) by the
// ring's bit-reversed twiddles, rearranged per pass on the host
// (ops/ntt_cuda.py `pass_tables`); every output is the canonical residue in
// [0, q) and equal to any correct reference NTT.
//
// What bounds it: a row of n residues moves twice through device memory
// (int64 in, int64 out) against ~12 32-bit operations per butterfly and
// n/2 * log2(n) butterflies; at n = 2^14 the operations bound is a third of
// the bytes bound, so the kernel is bound by bytes and the tensor cores are
// no lever. The design (csrc/ntt_passes.cuh) touches device memory once per
// element each way and keeps the memory busy behind the arithmetic: the next
// row streams into a 128 KB staging buffer by cp.async while the current one,
// held in registers (16 residues a thread, 1024 threads a row at n = 2^14),
// runs four register passes of up to four stages joined by conflict-free
// exchanges through a 64 KB buffer; rows leave in coalesced 8-byte stores,
// and twiddles are read once per row, in pass order. 192 KB of shared memory
// hold one block per SM (64 registers a thread at 1024 threads). At
// n = 2^15 (32 residues a thread) the staging buffer does not fit: rows are
// read straight from device memory. n = 2^16 takes the split of
// csrc/ntt_columns.cuh: the columns kernel runs the top stage (forward) or
// the last one (inverse), this row kernel the rest on the two sub-rows of
// 2^15, each a limb of its own. Above 2^16 is refused.
//
// Rows are laid out (rows, n) contiguous; row r uses limb r % limbs of the
// tables, so any (..., L, n) stack is one launch.
//
// The perm entries (lattisense_tpu/ops/ntt_pallas32.py `ntt_fused32_perm` /
// `intt_fused32_perm`) are the same transform with the forward output stored,
// or the inverse input loaded, in the transposed tile layout: position
// b * (n / 128) + a of a perm-layout row holds standard-order element a * 128 + b.
// Only the row's load or store changes (scattered, off the main path). At
// n = 2^16 the split's row kernel sees sub-rows, not the whole row, so the
// perm entries run the split as it is and one more pass, `perm_kernel`,
// transposes each row's (n / 128, 128) tile matrix in shared memory: after
// the forward, or before the inverse (the layout's inverse is the transpose
// of the (128, n / 128) matrix). It moves the stack through device memory
// once more each way.

#include "ntt_passes.cuh"
#include "ntt_columns.cuh"

namespace {

constexpr int kMaxLogn = 15;       // the row kernel: 1024 threads of 32 residues
constexpr int kMaxSplit = 1;       // columns stages: n up to 2^16

template <bool kInverse, bool kPerm>
int run(const int64_t* x, int64_t* y, int rows, int limbs, int logn, const void* tab,
        const void* q, const void* post, const void* posts, void* stream) {
  return ntt::dispatch<ntt::W32, kMaxLogn, kInverse, kPerm>(
      logn, x, y, rows, limbs, tab, q, post, posts, static_cast<cudaStream_t>(stream));
}

constexpr int kTile = 32;          // perm_kernel: 32 x 32 tiles, 8 rows of threads
constexpr int kTileRows = 8;

// y = x^T for each of `rows` (R, C) matrices of int64, R and C multiples of
// kTile: y[c * R + r] = x[r * C + c]. A block moves one tile of every matrix
// in turn, read and written in rows of 32 consecutive residues.
__global__ void __launch_bounds__(kTile * kTileRows) perm_kernel(
    const int64_t* __restrict__ x, int64_t* __restrict__ y, int rows, int R, int C) {
  __shared__ int64_t tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  const size_t plane = static_cast<size_t>(R) * C;
  for (int m = blockIdx.z; m < rows; m += gridDim.z) {
    const int64_t* xm = x + m * plane;
    int64_t* ym = y + m * plane;
    for (int i = threadIdx.y; i < kTile; i += kTileRows)
      tile[i][threadIdx.x] = xm[static_cast<size_t>(r0 + i) * C + c0 + threadIdx.x];
    __syncthreads();
    for (int i = threadIdx.y; i < kTile; i += kTileRows)
      ym[static_cast<size_t>(c0 + i) * R + r0 + threadIdx.x] = tile[threadIdx.x][i];
    __syncthreads();
  }
}

}  // namespace

// The perm layout of `rows` rows of n = 2^logn residues, x -> y (not in
// place): the (n / 128, 128) transpose (inverse == 0, perm_layout) or the
// (128, n / 128) one (unperm_layout). n >= 4096.
extern "C" int ntt32_perm_launch(const int64_t* x, int64_t* y, int rows, int logn, int inverse,
                                 void* stream) {
  if (logn < 12 || logn > 16 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int R = inverse ? 128 : (1 << logn) / 128, C = (1 << logn) / R;
  const dim3 grid(C / kTile, R / kTile, rows < 65535 ? rows : 65535);
  perm_kernel<<<grid, dim3(kTile, kTileRows), 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, rows, R, C);
  return static_cast<int>(cudaGetLastError());
}

// Forward transform of `rows` rows; `tab` is the forward pass table
// (limbs, entries, 2) of uint32 (value, Shoup companion); `post`/`posts` may
// be null (no epilogue) or per-limb (value, Shoup companion) multiplied into
// every output.
extern "C" int ntt32_fwd_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                const void* tab, const void* q, const void* post,
                                const void* posts, void* stream) {
  return run<false, false>(x, y, rows, limbs, logn, tab, q, post, posts, stream);
}

// Inverse transform with the inverse pass table; `ninv`/`ninvs` are the
// per-limb n^-1 (or n^-1 * 2^-32) and its companion.
extern "C" int ntt32_inv_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                const void* tab, const void* q, const void* ninv,
                                const void* ninvs, void* stream) {
  return run<true, false>(x, y, rows, limbs, logn, tab, q, ninv, ninvs, stream);
}

// The forward transform with its output stored in the perm layout (n % 128 == 0).
extern "C" int ntt32_fwd_perm_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                     const void* tab, const void* q, const void* post,
                                     const void* posts, void* stream) {
  return run<false, true>(x, y, rows, limbs, logn, tab, q, post, posts, stream);
}

// The inverse transform with its input loaded from the perm layout (n % 128 == 0).
extern "C" int ntt32_inv_perm_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                     const void* tab, const void* q, const void* ninv,
                                     const void* ninvs, void* stream) {
  return run<true, true>(x, y, rows, limbs, logn, tab, q, ninv, ninvs, stream);
}

// Blocks of the forward (inverse != 0: inverse) kernel an SM holds at
// n = 2^logn, from the occupancy calculator, or minus a cudaError_t.
extern "C" int ntt32_blocks_per_sm(int logn, int inverse) {
  return inverse ? ntt::occupancy<ntt::W32, kMaxLogn, true>(logn)
                 : ntt::occupancy<ntt::W32, kMaxLogn, false>(logn);
}

// The column stage of the split at depth k (n = 2^logn, rows of 2^(logn-k)
// for the row kernel): forward before the row kernel, inverse after it
// (inverse != 0). `tab` is the (limbs, 2^k, 2) column table of uint32
// (value, Shoup companion), `q` the limbs' primes as uint32.
extern "C" int ntt32_cols_launch(const int64_t* x, int64_t* y, int rows, int limbs, int logn,
                                 int k, int inverse, const void* tab, const void* q,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return inverse
      ? ntt::launch_columns<ntt::W32, kMaxSplit, true>(x, y, rows, limbs, logn, k, tab, q, s)
      : ntt::launch_columns<ntt::W32, kMaxSplit, false>(x, y, rows, limbs, logn, k, tab, q, s);
}
