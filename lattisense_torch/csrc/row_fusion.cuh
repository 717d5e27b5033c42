// Shared code of kernels B3 (csrc/ksw32.cu) and B4 (csrc/behz32.cu), which
// run their NTTs with the passes of csrc/ntt_passes.cuh and work on the
// transformed rows where they are, without relaunching kernel B1.
//
// - 32-bit word arithmetic: Shoup and Montgomery products, modular add and
//   sub, each giving the canonical residue (reductions as min(x, x - q)).
// - Parking. A row kept in shared memory between two steps holds canonical
//   32-bit residues at the exchange-buffer slot of each element
//   (ntt::xswz32), so it can serve as the exchange buffer of the next
//   transform: a thread that wrote the elements of its chunk window reads
//   them back without a barrier (`unpark`), and the transform's first
//   exchange writes the same slots.
// - Compile-time sizes. Register arrays indexed by a limb count stay in
//   registers only when the count is a compile-time constant, so the
//   launches dispatch run-time counts to template instances (`by_value`,
//   in the manner of ntt::by_logn).

#pragma once

#include <cstdint>
#include <type_traits>

#include "ntt_passes.cuh"

namespace fused {

// ---------------------------------------------------------------------------
// the 32-bit word
// ---------------------------------------------------------------------------

// x mod q for x < 2q: x - q wraps above x when x < q (q < 2^31)
__device__ __forceinline__ uint32_t reduce(uint32_t x, uint32_t q) { return min(x, x - q); }

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w, uint32_t ws, uint32_t q) {
  return reduce(a * w - __umulhi(a, ws) * q, q);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  return reduce(a + b, q);
}

// a - b mod q: a - b wraps above a - b + q when a < b
__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return min(a - b, a - b + q);
}

// a*b*2^-32 mod q (Montgomery, pinv = -q^-1 mod 2^32), for a*b < q*2^32.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t q, uint32_t pinv) {
  const uint64_t prod = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(prod);
  const uint32_t m = lo * pinv;
  return reduce(static_cast<uint32_t>(prod >> 32) + __umulhi(m, q) + (lo != 0), q);
}

// ---------------------------------------------------------------------------
// parking
// ---------------------------------------------------------------------------

// the slot of element j in a parked row
__device__ __forceinline__ int parked_slot(int j) { return ntt::xswz32(j); }

// A parked row into the registers of window LO.
template <int LOGN, int LO>
__device__ __forceinline__ void unpark(uint32_t (&a)[1 << ntt::reg_bits(LOGN)],
                                       const uint32_t* slot) {
  constexpr int K = ntt::reg_bits(LOGN);
  const int from = ntt::xswz32(ntt::element<LO, K>(ntt::lane_id(), 0));
#pragma unroll
  for (int i = 0; i < (1 << K); ++i) a[i] = slot[from ^ ntt::xswz32(i << LO)];
}

// ---------------------------------------------------------------------------
// compile-time sizes
// ---------------------------------------------------------------------------

// f(std::integral_constant<int, v>) for v known at run time, returning f's
// int, or cudaErrorInvalidValue for v outside [V, HI].
template <int HI, int V = 1, class F>
int by_value(int v, const F& f) {
  if constexpr (V > HI) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (v == V) return f(std::integral_constant<int, V>{});
    return by_value<HI, V + 1>(v, f);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Allow `bytes` of dynamic shared memory to `kernel` on the current device.
// `allowed` is the caller's record of what each device allows already (a
// static of the launch function's template instance, one per kernel), so
// the attribute is set once per kernel, device and larger size.
template <class Kernel>
int allow_smem(Kernel kernel, int bytes, int (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = bytes;
  }
  return 0;
}

}  // namespace fused
