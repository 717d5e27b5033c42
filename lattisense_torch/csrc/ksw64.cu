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
// What bounds it: per output residue beta Montgomery products against
// beta digit reads shared by two outputs, beta * 2 key reads and one write:
// about 12 32-bit operations per byte, bound by bytes. One thread per
// (polynomial, limb, coefficient) reads each digit residue once and
// accumulates both key components; neighbouring threads take neighbouring
// coefficients (coalesced).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridYZ = 65535;

__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b, uint64_t q, uint64_t pinv) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t m = lo * pinv;
  const uint64_t t = hi + __umul64hi(m, q) + (lo != 0 ? 1 : 0);
  return t >= q ? t - q : t;
}

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b, uint64_t q) {
  const uint64_t s = a + b;
  return s >= q ? s - q : s;
}

__global__ void __launch_bounds__(kThreads) ksw64_inner_kernel(
    const uint64_t* __restrict__ d, const uint64_t* __restrict__ kq,
    const uint64_t* __restrict__ kp, uint64_t* __restrict__ out, int L, int Lq, int alpha,
    int beta, int T, int n, const uint64_t* __restrict__ qv, const uint64_t* __restrict__ pv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = blockIdx.y;
  const size_t g = blockIdx.z;
  const uint64_t q = qv[t], pinv = pv[t];
  const uint64_t* dg = d + (g * beta * T + t) * n + i;
  uint64_t acc0 = 0, acc1 = 0;
  for (int b = 0; b < beta; ++b) {
    const uint64_t x = dg[static_cast<size_t>(b) * T * n];
    const uint64_t* k0 = t < L ? kq + ((static_cast<size_t>(b) * 2) * Lq + t) * n
                               : kp + ((static_cast<size_t>(b) * 2) * alpha + (t - L)) * n;
    const size_t comp = static_cast<size_t>(t < L ? Lq : alpha) * n;
    const uint64_t p0 = mont_mul(x, k0[i], q, pinv);
    const uint64_t p1 = mont_mul(x, k0[comp + i], q, pinv);
    acc0 = b == 0 ? p0 : add_mod(acc0, p0, q);
    acc1 = b == 0 ? p1 : add_mod(acc1, p1, q);
  }
  uint64_t* o = out + (g * 2 * T + t) * n + i;
  o[0] = acc0;
  o[static_cast<size_t>(T) * n] = acc1;
}

}  // namespace

extern "C" int ksw64_max_polys() { return kMaxGridYZ; }

// digits d (G, beta, T, n) NTT domain; key_q (beta_key, 2, Lq, n), key_p
// (beta_key, 2, alpha, n) NTT + Montgomery; out (G, 2, T, n); q / pinv the T
// moduli of Q_l u P and -q^-1 mod 2^64.
extern "C" int ksw64_inner_launch(const uint64_t* d, const uint64_t* key_q,
                                  const uint64_t* key_p, uint64_t* out, int G, int L, int Lq,
                                  int alpha, int beta, int T, int n, const uint64_t* q,
                                  const uint64_t* pinv, void* stream) {
  if (G > kMaxGridYZ || T > kMaxGridYZ || beta < 1 || T != L + alpha)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  dim3 grid((n + kThreads - 1) / kThreads, T, G);
  ksw64_inner_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d, key_q, key_p, out, L, Lq, alpha, beta, T, n, q, pinv);
  return static_cast<int>(cudaGetLastError());
}
