// The 64-bit word's modular arithmetic, shared by kernels B6
// (csrc/bconv64.cu), B7 (csrc/ksw64.cu) and B8 (csrc/tensor.cu).
//
// Residues lie in [0, q) for primes q < 2^62; Montgomery products carry
// R = 2^64 with pinv = -q^-1 mod 2^64. Every function returns the canonical
// residue, so results are bit-identical to lattisense_tpu/core/u64.py's.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace word64 {

// (hi, lo) += a * b
__device__ __forceinline__ void mac128(uint64_t& hi, uint64_t& lo, uint64_t a, uint64_t b) {
  const uint64_t pl = a * b;
  lo += pl;
  hi += __umul64hi(a, b) + (lo < pl ? 1 : 0);
}

// (hi, lo) * 2^-64 mod q for (hi, lo) < q * 2^64: t = hi + (m q + lo) / 2^64
// with m = lo * pinv; the low word m q + lo is 0 mod 2^64, so it carries
// exactly when lo != 0, and t < 2q.
__device__ __forceinline__ uint64_t redc128(uint64_t hi, uint64_t lo, uint64_t q, uint64_t pinv) {
  const uint64_t m = lo * pinv;
  const uint64_t t = hi + __umul64hi(m, q) + (lo != 0 ? 1 : 0);
  return t >= q ? t - q : t;
}

// a * b * 2^-64 mod q for a, b < q
__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b, uint64_t q, uint64_t pinv) {
  return redc128(__umul64hi(a, b), a * b, q, pinv);
}

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b, uint64_t q) {
  const uint64_t s = a + b;
  return s >= q ? s - q : s;
}

// two neighbouring residues as one 16-byte load (p on 16 bytes)
__device__ __forceinline__ ulonglong2 load2(const uint64_t* p) {
  return *reinterpret_cast<const ulonglong2*>(p);
}

}  // namespace word64
