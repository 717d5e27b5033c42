// Kernel B8: the NTT-domain tensor product of two ciphertexts, both words.
//
//   (d0, d1, d2) = (a0 b0, a0 b1 + a1 b0, a1 b1) * R^-1 mod q_t
//
// for a = (a0, a1) and b = (b0, b1) over the L limbs of a ring in the NTT
// domain, a in Montgomery form (or brought into it here, a_to_mont: a * r2
// * R^-1 = a R), R = 2^32 or 2^64 by the word. Every output is the canonical
// residue, bit-identical to lattisense_tpu/schemes/bfv.py's and ckks.py's
// products (four Montgomery products and a modular add a coefficient).
//
// It replaces no Pallas kernel: the JAX package leaves the product to XLA,
// which fuses its elementwise chain into one pass on the TPU. In plain
// PyTorch the same chain over int64 tensors is some twenty launches at the
// 32-bit word and many more at the 64-bit word, where every 64 x 64 -> 128
// bit product is built from 32-bit halves, each reading and writing whole
// operands.
//
// What bounds it: the bytes. A coefficient reads four residues and writes
// three (56 bytes), against at most 4 + 2 Montgomery products (about 20 IMAD
// each at the 64-bit word): 0.35 ms of bytes and 0.13 ms of multiplies at
// the CKKS product's (32, 10, 2^16). So the design reads each input once
// and writes each output once, every intermediate in registers:
//
// - A thread owns a limb t and a pair of coefficients (i, i + 1); the limb's
//   q, pinv (and r2) sit in registers. It reads the four input pairs and
//   writes the three output pairs as 16-byte vectors (residues travel as
//   64-bit words at both words).
// - The grid is (coefficient blocks, limbs, polynomials), coefficient blocks
//   fastest, so a warp reads 512 contiguous bytes of each input row. The
//   polynomials past the grid's third dimension (65535) are walked by a
//   loop.
// - a and b are read in place through their own polynomial and component
//   strides, so a stack's halves (BFV's (a0, a1, b0, b1) after kernel B2)
//   or two ciphertexts (CKKS) need no concatenation or copy first.
// - d1 at the 64-bit word sums the two 128-bit products and reduces once:
//   a0 b1 + a1 b0 < 2 q^2 < q 2^64 for q < 2^62, so one REDC gives the
//   canonical residue the two reductions and the modular add give.

#include <cstdint>

#include <cuda_runtime.h>

#include "row_fusion.cuh"
#include "word64.cuh"

namespace {

// The launch's block and grid come from the wrapper (ops/tensor_cuda.py
// thread_map); the kernel is compiled for blocks of at most kMaxThreads.
constexpr int kMaxThreads = 256;
constexpr int kMaxGridYZ = 65535;

template <int W>
struct Word;

template <>
struct Word<32> {
  __device__ static uint64_t mul(uint64_t a, uint64_t b, uint64_t q, uint64_t pinv) {
    return fused::mont_mul(static_cast<uint32_t>(a), static_cast<uint32_t>(b),
                           static_cast<uint32_t>(q), static_cast<uint32_t>(pinv));
  }
  // (a b + c d) R^-1 mod q
  __device__ static uint64_t mul_add(uint64_t a, uint64_t b, uint64_t c, uint64_t d, uint64_t q,
                                     uint64_t pinv) {
    return fused::add_mod(static_cast<uint32_t>(mul(a, b, q, pinv)),
                          static_cast<uint32_t>(mul(c, d, q, pinv)), static_cast<uint32_t>(q));
  }
};

template <>
struct Word<64> {
  __device__ static uint64_t mul(uint64_t a, uint64_t b, uint64_t q, uint64_t pinv) {
    return word64::mont_mul(a, b, q, pinv);
  }
  __device__ static uint64_t mul_add(uint64_t a, uint64_t b, uint64_t c, uint64_t d, uint64_t q,
                                     uint64_t pinv) {
    uint64_t hi = 0, lo = 0;
    word64::mac128(hi, lo, a, b);
    word64::mac128(hi, lo, c, d);
    return word64::redc128(hi, lo, q, pinv);
  }
};

// Polynomials blockIdx.z, + gridDim.z, ... below G; limb t = blockIdx.y;
// coefficients i, i + 1 with i = 2 (blockIdx.x blockDim.x + threadIdx.x).
// a / b: component c of polynomial g, limb t at a + g a_poly + c a_comp + t n;
// out (G, 3, L, n).
template <int W, bool TO_MONT>
__global__ void __launch_bounds__(kMaxThreads) tensor_kernel(
    const uint64_t* __restrict__ a, const uint64_t* __restrict__ b, uint64_t* __restrict__ out,
    int64_t a_poly, int64_t a_comp, int64_t b_poly, int64_t b_comp, int G, int L, int n,
    const uint64_t* __restrict__ qv, const uint64_t* __restrict__ pv,
    const uint64_t* __restrict__ rv) {
  using Wd = Word<W>;
  const int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const int t = blockIdx.y;
  const uint64_t q = qv[t], pinv = pv[t];
  const uint64_t r2 = TO_MONT ? rv[t] : 0;
  const int64_t row = static_cast<int64_t>(t) * n + i;
  const int64_t ln = static_cast<int64_t>(L) * n;
  for (int g = blockIdx.z; g < G; g += gridDim.z) {
    const uint64_t* ag = a + g * a_poly + row;
    const uint64_t* bg = b + g * b_poly + row;
    ulonglong2 a0 = word64::load2(ag), a1 = word64::load2(ag + a_comp);
    const ulonglong2 b0 = word64::load2(bg), b1 = word64::load2(bg + b_comp);
    if (TO_MONT) {
      a0 = make_ulonglong2(Wd::mul(a0.x, r2, q, pinv), Wd::mul(a0.y, r2, q, pinv));
      a1 = make_ulonglong2(Wd::mul(a1.x, r2, q, pinv), Wd::mul(a1.y, r2, q, pinv));
    }
    uint64_t* o = out + g * 3 * ln + row;
    *reinterpret_cast<ulonglong2*>(o) =
        make_ulonglong2(Wd::mul(a0.x, b0.x, q, pinv), Wd::mul(a0.y, b0.y, q, pinv));
    *reinterpret_cast<ulonglong2*>(o + ln) =
        make_ulonglong2(Wd::mul_add(a0.x, b1.x, a1.x, b0.x, q, pinv),
                        Wd::mul_add(a0.y, b1.y, a1.y, b0.y, q, pinv));
    *reinterpret_cast<ulonglong2*>(o + 2 * ln) =
        make_ulonglong2(Wd::mul(a1.x, b1.x, q, pinv), Wd::mul(a1.y, b1.y, q, pinv));
  }
}

template <int W>
int launch(const uint64_t* a, const uint64_t* b, uint64_t* out, int64_t a_poly, int64_t a_comp,
           int64_t b_poly, int64_t b_comp, int G, int L, int n, bool to_mont,
           const uint64_t* q, const uint64_t* pinv, const uint64_t* r2, int threads, int grid_z,
           cudaStream_t stream) {
  const dim3 grid((n / 2 + threads - 1) / threads, L, grid_z);
  if (to_mont)
    tensor_kernel<W, true><<<grid, threads, 0, stream>>>(a, b, out, a_poly, a_comp, b_poly,
                                                         b_comp, G, L, n, q, pinv, r2);
  else
    tensor_kernel<W, false><<<grid, threads, 0, stream>>>(a, b, out, a_poly, a_comp, b_poly,
                                                          b_comp, G, L, n, q, pinv, r2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b: G polynomial pairs, component c of pair g and limb t at
// x + g x_poly + c x_comp + t n (strides in residues); out (G, 3, L, n)
// contiguous; q / pinv / r2 the L limbs' moduli, -q^-1 mod R and R^2 mod q
// (read only with a_to_mont) as 64-bit words. Every pointer starts on 16
// bytes, every stride and n are even. Blocks of `threads` threads (at most
// kMaxThreads) over the n / 2 coefficient pairs, grid_z polynomials at once.
extern "C" int tensor_launch(const uint64_t* a, const uint64_t* b, uint64_t* out,
                             long long a_poly, long long a_comp, long long b_poly,
                             long long b_comp, int G, int L, int n, int word_bits, int a_to_mont,
                             const uint64_t* q, const uint64_t* pinv, const uint64_t* r2,
                             int threads, int grid_z, void* stream) {
  const long long strides[] = {a_poly, a_comp, b_poly, b_comp};
  bool bad = G < 0 || L < 1 || L > kMaxGridYZ || n < 2 || n % 2 ||
             (word_bits != 32 && word_bits != 64) || threads < 1 || threads > kMaxThreads ||
             grid_z < 1 || grid_z > kMaxGridYZ ||
             (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
              reinterpret_cast<uintptr_t>(out)) % 16;
  for (long long st : strides) bad = bad || st < 0 || st % 2;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return word_bits == 32 ? launch<32>(a, b, out, a_poly, a_comp, b_poly, b_comp, G, L, n,
                                      a_to_mont != 0, q, pinv, r2, threads, grid_z, s)
                         : launch<64>(a, b, out, a_poly, a_comp, b_poly, b_comp, G, L, n,
                                      a_to_mont != 0, q, pinv, r2, threads, grid_z, s);
}
