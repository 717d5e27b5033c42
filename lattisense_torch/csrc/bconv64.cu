// Kernel B6: the 64-bit-word fast base conversion sum (FastBConv).
//
// Replaces lattisense_tpu/ops/bconv_pallas.py `bconv_convert_fused` and
// `bconv_raw_fused` (kernel `_bconv_kernel`, launch `_launch`):
//
//   out[r, t, i] = sum_l mont_mul(y[r, l, i], C[g, t, l]) mod d_t,  g = r % groups,
//
// with mont_mul(a, b) = a * b * 2^-64 mod d_t (REDC, pinv_t = -d_t^-1 mod 2^64),
// every output the canonical residue, bit-identical to
// lattisense_tpu/core/rns.py `BasisConv.convert`. One constant group
// (groups = 1) is a BasisConv; `groups` = beta is the key switch's grouped
// mod-up of all beta digits in one launch, row r of the (..., beta, alpha, n)
// digit stack taking digit r % beta's constants.
//
// What bounds it: each source residue is read once and each output written
// once, 8 (L + T) bytes a coefficient, against L 64 x 64 -> 128-bit
// products an output; at the path's shapes (L <= 5, T <= 6) the bytes and
// the integer multiplies are near balance on this card, the multiplies
// being the ones the 64-bit word pays most for (64-bit products are built
// from 32-bit IMADs). The design:
//
// - Lazy accumulation. Sum the L 128-bit products V = sum_l y_l C_l and do
//   one Montgomery reduction an output: REDC(V) = V * 2^-64 mod d_t is the
//   canonical residue the sum of L reductions gives. REDC is exact when
//   V < d_t * 2^64 (then (V + m d_t) / 2^64 < 2 d_t, one conditional
//   subtraction); with canonical constants C < d_t that holds when
//   L * ymax <= 2^64, ymax the largest source residue. Where the caller
//   cannot prove that for all L terms, it passes `fold`, the most terms that
//   meet it: after the first `fold` terms each further term is followed by a
//   fold, d_t subtracted from the high word when it reaches d_t (V - d_t 2^64
//   is the same residue times 2^64), which keeps V < d_t 2^64 for any
//   y < 2^64. Half the multiplies of a reduction per product, and no
//   modular add between terms.
// - Compile-time (L, T) instances for the path's shapes (L, T) = (4, 6),
//   (5, 5), (2, 4), (2, 6), where the wrapper has proven the lazy sum exact;
//   every other shape (L <= kMaxSrc) takes the instance of its L with a
//   run-time T and fold. Either way the L digits of a thread sit in
//   registers; a run-time L had put them in a 256-byte local-memory frame.
// - Layout. A 2-D grid of (row, chunk of coefficients), the constant group
//   in the grid's third dimension, so no thread divides; two coefficients a
//   thread, each source residue read and each output written in 16-byte
//   pieces. The group's constants are read by every thread from the same
//   addresses (broadcast, L1).
//
// Residues and constants are int64 tensors on the Python side, read here as
// the same 64-bit patterns.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "word64.cuh"

namespace {

using word64::mac128;
using word64::redc128;

constexpr int kThreads = 256;
constexpr int kMaxSrc = 32;           // L: source limbs held per thread
constexpr int kMaxConstWords = 6144;  // groups * T * L + 2 * T, as the first design's 48 KB

// Output t of the two coefficients whose L digits are v0, v1, into o[t n],
// o[t n + 1]: the lazy sum, folded after term `fold` on (FOLD), and one REDC.
template <int L, bool FOLD>
__device__ __forceinline__ void output(const uint64_t (&v0)[L], const uint64_t (&v1)[L],
                                       const uint64_t* __restrict__ ct, uint64_t q, uint64_t pinv,
                                       int fold, uint64_t* __restrict__ o) {
  uint64_t h0 = 0, l0 = 0, h1 = 0, l1 = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint64_t c = ct[l];
    mac128(h0, l0, v0[l], c);
    mac128(h1, l1, v1[l], c);
    if (FOLD && l >= fold) {
      h0 = h0 >= q ? h0 - q : h0;
      h1 = h1 >= q ? h1 - q : h1;
    }
  }
  *reinterpret_cast<ulonglong2*>(o) = make_ulonglong2(redc128(h0, l0, q, pinv),
                                                      redc128(h1, l1, q, pinv));
}

// out rows (rows, T, n) from y rows (rows, L, n), row = blockIdx.x * groups +
// blockIdx.z taking constant group blockIdx.z; coefficients i, i + 1 with
// i = 2 * (blockIdx.y * blockDim.x + threadIdx.x). TT > 0: T fixed at
// compile time and the lazy sum proven exact (no fold); TT = 0: run-time T
// and fold.
template <int L, int TT>
__global__ void __launch_bounds__(kThreads) bconv64_kernel(
    const uint64_t* __restrict__ y, uint64_t* __restrict__ out, int T_rt, int n, int fold,
    const uint64_t* __restrict__ C, const uint64_t* __restrict__ dq,
    const uint64_t* __restrict__ dpinv) {
  const int T = TT > 0 ? TT : T_rt;
  const size_t row = static_cast<size_t>(blockIdx.x) * gridDim.z + blockIdx.z;
  const size_t i = 2 * (static_cast<size_t>(blockIdx.y) * blockDim.x + threadIdx.x);
  const uint64_t* cg = C + static_cast<size_t>(blockIdx.z) * T * L;
  const uint64_t* yr = y + row * L * n + i;
  uint64_t v0[L], v1[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(yr + static_cast<size_t>(l) * n);
    v0[l] = v.x;
    v1[l] = v.y;
  }
  uint64_t* o = out + row * T * n + i;
  if constexpr (TT > 0) {
#pragma unroll
    for (int t = 0; t < TT; ++t)
      output<L, false>(v0, v1, cg + t * L, dq[t], dpinv[t], L, o + static_cast<size_t>(t) * n);
  } else {
#pragma unroll 1
    for (int t = 0; t < T; ++t)
      output<L, true>(v0, v1, cg + t * L, dq[t], dpinv[t], fold, o + static_cast<size_t>(t) * n);
  }
}

template <int L, int TT>
int launch(const uint64_t* y, uint64_t* out, int rows, int groups, int T, int n, int fold,
           const uint64_t* C, const uint64_t* dq, const uint64_t* dpinv, cudaStream_t stream) {
  const int threads = n / 2 < kThreads ? n / 2 : kThreads;
  dim3 grid(rows / groups, n / 2 / threads, groups);
  bconv64_kernel<L, TT><<<grid, threads, 0, stream>>>(y, out, T, n, fold, C, dq, dpinv);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, v>) for v known at run time, 1 <= v <= HI
template <int HI, int V = 1, class F>
int by_value(int v, const F& f) {
  if constexpr (V > HI) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (v == V) return f(std::integral_constant<int, V>{});
    return by_value<HI, V + 1>(v, f);
  }
}

template <int L_, int T_>
struct Shape {
  static constexpr int L = L_, T = T_;
};

constexpr int kNoShape = -1;

// f(Shape<L, T>{}) for the path's shapes, which have compile-time
// instances; kNoShape for any other.
template <class F>
int by_shape(int L, int T, const F& f) {
  if (L == 4 && T == 6) return f(Shape<4, 6>{});   // BEHZ extension, scale_and_back's Q -> aux
  if (L == 5 && T == 5) return f(Shape<5, 5>{});   // Shenoy's B -> Q u m_sk
  if (L == 2 && T == 4) return f(Shape<2, 4>{});   // RoundDivP's P -> Q
  if (L == 2 && T == 6) return f(Shape<2, 6>{});   // the key switch's mod-up
  return kNoShape;
}

}  // namespace

extern "C" int bconv64_max_src() { return kMaxSrc; }
extern "C" int bconv64_max_const_words() { return kMaxConstWords; }

// out (rows, T, n) from y (rows, L, n), both starting on 16 bytes, rows a
// multiple of `groups`, n even; C (groups, T, L) Montgomery constants below
// their moduli, dq / dpinv the T destination moduli and -d^-1 mod 2^64;
// `fold` the most terms whose lazy sum the caller has proven exact
// (fold >= L: all of them).
extern "C" int bconv64_launch(const uint64_t* y, uint64_t* out, int rows, int groups, int L,
                              int T, int n, int fold, const uint64_t* C, const uint64_t* dq,
                              const uint64_t* dpinv, void* stream) {
  if (L < 1 || L > kMaxSrc || T < 1 || groups < 1 || groups * T * L + 2 * T > kMaxConstWords ||
      rows % groups != 0 || n < 2 || n % 2 != 0 || fold < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fold >= L) {
    const int err = by_shape(L, T, [&](auto shape) -> int {
      using S = decltype(shape);
      return launch<S::L, S::T>(y, out, rows, groups, T, n, L, C, dq, dpinv, st);
    });
    if (err != kNoShape) return err;
  }
  return by_value<kMaxSrc>(L, [&](auto size) -> int {
    return launch<decltype(size)::value, 0>(y, out, rows, groups, T, n, fold, C, dq, dpinv, st);
  });
}

// Which instance bconv64_launch takes for (L, T, fold): 1 for a
// compile-time (L, T) one, 0 for the run-time-T instance of L.
extern "C" int bconv64_specific(int L, int T, int fold) {
  return fold >= L && by_shape(L, T, [](auto) { return 0; }) != kNoShape;
}
