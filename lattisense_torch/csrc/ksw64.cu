// Kernel B7: the 64-bit-word gadget inner product of hybrid key switching.
//
// Replaces lattisense_tpu/ops/ksw_pallas.py `ksw_inner_fused` (kernel
// `_ksw_kernel`, launch `_launch`):
//
//   out[g, c, t, i] = sum_b mont_mul(d[g, b, t, i], k[b, c, t, i]) mod q_t,  c in {0, 1},
//
// over the T = L + alpha limbs of Q_l u P in the NTT domain, with the key in
// NTT + Montgomery form (R = 2^64), the sum over the beta digits folded with
// modular adds: the canonical residue, bit-identical to
// lattisense_tpu/schemes/keyswitch.py `KeySwitcher.inner_product`.
//
// The key is read in place: limb t < L of component c of digit b is
// key_q[b, c, t], limb t >= L is key_p[b, c, t - L], from the full-level
// (beta_key, 2, Lq, n) and (beta_key, 2, alpha, n) tensors, so no per-call
// concatenation of the key slice is needed at any level.
//
// What bounds it: the bytes. Per output residue beta Montgomery products
// (about 20 IMAD each) against beta digit reads shared by two outputs and one
// write; the key, beta * 2 * T * n residues, is read by every polynomial. So
// the design makes the key cross device memory once:
//
// - A thread owns a limb t and a pair of coefficients (i, i + 1). It loads the
//   key's beta * 2 values for both coefficients into registers once (16-byte
//   loads; 32 registers at beta = 4) and walks a chunk of kChunk
//   polynomials, reading each one's beta digit pairs and writing its two
//   output pairs in 16-byte pieces.
// - The grid is (chunks of polynomials, coefficient blocks, limbs), chunks
//   fastest: the blocks that share a key slice are dispatched together, so
//   the L2 serves all but the first read of it (with the chunks outermost a
//   31.5 MB key, against 503 MB of streaming digits at n = 32768, would be
//   swept from device memory once a chunk).
// - Compile-time beta (1 .. kMaxBeta, every chain of the parameter tables)
//   keeps the key in registers; a larger beta reads it per polynomial.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "word64.cuh"

namespace {

using word64::add_mod;
using word64::load2;
using word64::mont_mul;

constexpr int kThreads = 128;
constexpr int kChunk = 4;              // polynomials a thread walks
constexpr int kMaxBeta = 8;            // digits held in registers
constexpr int kMaxGridYZ = 65535;
constexpr int kMaxPolys = 1 << 30;

// acc (+)= d * k for both coefficients of a pair
__device__ __forceinline__ void mac2(ulonglong2& acc, ulonglong2 d, ulonglong2 k, uint64_t q,
                                     uint64_t pinv, bool first) {
  const uint64_t p0 = mont_mul(d.x, k.x, q, pinv), p1 = mont_mul(d.y, k.y, q, pinv);
  acc.x = first ? p0 : add_mod(acc.x, p0, q);
  acc.y = first ? p1 : add_mod(acc.y, p1, q);
}

// Polynomials kChunk * blockIdx.x .. + kChunk - 1 (below G), limb
// t = blockIdx.z, coefficients i, i + 1 with i = 2 (blockIdx.y blockDim.x +
// threadIdx.x). BETA > 0: beta fixed at compile time, the key in registers;
// BETA = 0: run-time beta, the key read per polynomial.
template <int BETA>
__global__ void __launch_bounds__(kThreads) ksw64_inner_kernel(
    const uint64_t* __restrict__ d, const uint64_t* __restrict__ kq,
    const uint64_t* __restrict__ kp, uint64_t* __restrict__ out, int G, int L, int Lq, int alpha,
    int beta_rt, int T, int n, const uint64_t* __restrict__ qv, const uint64_t* __restrict__ pv) {
  const int beta = BETA > 0 ? BETA : beta_rt;
  const size_t i = 2 * (static_cast<size_t>(blockIdx.y) * blockDim.x + threadIdx.x);
  if (i >= static_cast<size_t>(n)) return;
  const int t = blockIdx.z;
  const uint64_t q = qv[t], pinv = pv[t];
  // component c of digit b at kt + (2 b + c) * comp
  const uint64_t* kt = (t < L ? kq + static_cast<size_t>(t) * n
                              : kp + static_cast<size_t>(t - L) * n) + i;
  const size_t comp = static_cast<size_t>(t < L ? Lq : alpha) * n;
  const size_t tn = static_cast<size_t>(T) * n;
  const int g0 = blockIdx.x * kChunk;
  const int g1 = g0 + kChunk < G ? g0 + kChunk : G;
  if constexpr (BETA > 0) {
    ulonglong2 k0[BETA], k1[BETA];
#pragma unroll
    for (int b = 0; b < BETA; ++b) {
      k0[b] = load2(kt + (2 * b) * comp);
      k1[b] = load2(kt + (2 * b + 1) * comp);
    }
    for (int g = g0; g < g1; ++g) {
      const uint64_t* dg = d + static_cast<size_t>(g) * BETA * tn + t * static_cast<size_t>(n) + i;
      ulonglong2 x[BETA];
#pragma unroll
      for (int b = 0; b < BETA; ++b) x[b] = load2(dg + b * tn);
      ulonglong2 a0, a1;
#pragma unroll
      for (int b = 0; b < BETA; ++b) {
        mac2(a0, x[b], k0[b], q, pinv, b == 0);
        mac2(a1, x[b], k1[b], q, pinv, b == 0);
      }
      uint64_t* o = out + static_cast<size_t>(g) * 2 * tn + t * static_cast<size_t>(n) + i;
      *reinterpret_cast<ulonglong2*>(o) = a0;
      *reinterpret_cast<ulonglong2*>(o + tn) = a1;
    }
  } else {
    for (int g = g0; g < g1; ++g) {
      const uint64_t* dg = d + static_cast<size_t>(g) * beta * tn + t * static_cast<size_t>(n) + i;
      ulonglong2 a0, a1;
      for (int b = 0; b < beta; ++b) {
        const ulonglong2 x = load2(dg + b * tn);
        mac2(a0, x, load2(kt + (2 * b) * comp), q, pinv, b == 0);
        mac2(a1, x, load2(kt + (2 * b + 1) * comp), q, pinv, b == 0);
      }
      uint64_t* o = out + static_cast<size_t>(g) * 2 * tn + t * static_cast<size_t>(n) + i;
      *reinterpret_cast<ulonglong2*>(o) = a0;
      *reinterpret_cast<ulonglong2*>(o + tn) = a1;
    }
  }
}

// f(std::integral_constant<int, beta>) for 1 <= beta <= kMaxBeta, else f of 0
template <int V = 1, class F>
int by_beta(int beta, const F& f) {
  if constexpr (V > kMaxBeta) {
    return f(std::integral_constant<int, 0>{});
  } else {
    if (beta == V) return f(std::integral_constant<int, V>{});
    return by_beta<V + 1>(beta, f);
  }
}

}  // namespace

extern "C" int ksw64_max_polys() { return kMaxPolys; }
extern "C" int ksw64_chunk() { return kChunk; }
extern "C" int ksw64_threads() { return kThreads; }
extern "C" int ksw64_max_beta() { return kMaxBeta; }

// digits d (G, beta, T, n) NTT domain; key_q (beta_key, 2, Lq, n), key_p
// (beta_key, 2, alpha, n) NTT + Montgomery; out (G, 2, T, n); q / pinv the T
// moduli of Q_l u P and -q^-1 mod 2^64. d, key_q, key_p and out start on 16
// bytes; n is even.
extern "C" int ksw64_inner_launch(const uint64_t* d, const uint64_t* key_q,
                                  const uint64_t* key_p, uint64_t* out, int G, int L, int Lq,
                                  int alpha, int beta, int T, int n, const uint64_t* q,
                                  const uint64_t* pinv, void* stream) {
  const int threads = n / 2 < kThreads ? n / 2 : kThreads;
  if (G < 0 || G > kMaxPolys || T > kMaxGridYZ || beta < 1 || T != L + alpha || n < 2 ||
      n % 2 || (n / 2 + threads - 1) / threads > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  const dim3 grid((G + kChunk - 1) / kChunk, (n / 2 + threads - 1) / threads, T);
  return by_beta(beta, [&](auto b) -> int {
    ksw64_inner_kernel<decltype(b)::value><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        d, key_q, key_p, out, G, L, Lq, alpha, beta, T, n, q, pinv);
    return static_cast<int>(cudaGetLastError());
  });
}
