"""Four-step negacyclic NTT/INTT of the 64-bit word as matrix products.

Port of ``lattisense_tpu/ops/ntt_mxu.py`` (not a Pallas kernel: the JAX
package leaves it to XLA's ``einsum``, and here it is ``torch.bmm`` /
``torch._int_mm``). An n-point NTT becomes two modular matrix products
(R×C decomposition, R = 2^ceil(log2 n / 2), C = n/R) around one pointwise
twiddle, and each modular product runs on the tensor cores through a
digit-plane decomposition:

    value = Σ_d 2^(7·d) · digit_d,   digit_d ∈ [-64, 64)   (balanced, 7 bits)

so X·A mod q = Σ_s (2^(7·s) mod q) · S_s with S_s = Σ_{d+e=s} X_d·A_e. The
digit axis is folded into the contraction against a diagonally banded
constant (D planes, S = 2D - 1 diagonals; D = 9, S = 17 for primes up to 61
bits), so each step is one batched matrix product per limb whose sums are
exact, then three 64-bit chunk folds and three Montgomery products per
element bring the diagonals back mod q (``_recombine``).

Exactness: the digits are at most 2^6 in magnitude and a sum has D·C ≤ 1152
products below 2^12, so every sum stays below 2^24 and every partial sum is
an integer that float32 holds exactly. Three routes compute the same sums:

- the card, by default: bf16 planes and ``torch.bmm(..., out_dtype=
  torch.float32)`` (bf16 holds the 7-bit digits exactly, the tensor cores
  accumulate in float32);
- the card or the CPU with ``I8DOT``: int8 planes and ``torch._int_mm``
  (int8 × int8 → int32), one product per limb, padded to the shapes it takes
  (more than 16 rows, depth and width multiples of 8);
- the CPU otherwise: float32 planes and ``torch.bmm``.

Output convention is ``core/ntt.py``'s exactly (bit-reversed evaluation
order; the inverse natural and scaled by n^-1): the tests hold it bit for bit
against the JAX module and the card holds it against B5.

Gates, as in the JAX package: ``LATTISENSE_MXU_NTT`` (``ENABLED``) routes
``core/ntt.py``'s transforms of the 64-bit word at n ≥ 4096 here, on either
device; ``LATTISENSE_MXU_I8DOT`` (``I8DOT``) picks the int8 route. Both are
read once into these module attributes, which callers may set. Off by
default.

Work: 2·D·S·R²·C multiply-adds a limb-row (``macs``), 0.64 GMAC at
n=16384. Bound on the card by the tensor cores' operations (dense int8 or
bf16 peak), well above B5's butterflies; ``launches`` counts the matrix
products issued on the card.
"""

import os

import numpy as np
import torch

from ..core import u64 as _u
from ..utils import observability

_DIGIT_BITS = 7
_BASE = 1 << _DIGIT_BITS
_HALF = _BASE // 2
_MASK = _BASE - 1
_OFF = 1 << 59          # signed chunk offset (see _recombine): |chunk| < 2^58

ENABLED = os.environ.get('LATTISENSE_MXU_NTT', '0') not in ('', '0')
I8DOT = os.environ.get('LATTISENSE_MXU_I8DOT', '0') not in ('', '0')
MIN_N = 4096

#: matrix products issued on the card since the last reset
launches = {'mxu_bmm': 0, 'mxu_int_mm': 0}
observability.register('ntt_mxu', launches, launches=launches)


def enabled(n: int, word_bits: int) -> bool:
    """Whether ``core/ntt.py`` takes this route: the gate is on, the word is
    64 bits (the digit planes are the 64-bit word's) and n ≥ 4096."""
    return ENABLED and word_bits == 64 and n >= MIN_N


def shape(n: int) -> tuple[int, int]:
    """(R, C) of the four-step split of n."""
    logn = n.bit_length() - 1
    R = 1 << ((logn + 1) // 2)
    return R, n // R


def planes_of(moduli) -> int:
    """Digit planes D for a chain: +2 bits of headroom for the balanced
    top digit's carry."""
    return -(-(max(int(m).bit_length() for m in moduli) + 2) // _DIGIT_BITS)


def macs(rows: int, n: int, D: int = 9) -> int:
    """Multiply-adds of one transform of ``rows`` limb-rows."""
    R, C = shape(n)
    return rows * 2 * D * (2 * D - 1) * R * R * C


def _brv(x: int, bits: int) -> int:
    r = 0
    for i in range(bits):
        r |= ((x >> i) & 1) << (bits - 1 - i)
    return r


def _digits_balanced(mat: np.ndarray, planes: int) -> np.ndarray:
    """Python-int object array (…) → balanced signed digit planes
    (planes, …) int8, value = Σ_d b_d·2^(7·d)."""
    out = np.empty((planes,) + mat.shape, dtype=np.int8)
    carry = np.zeros(mat.shape, dtype=np.int64)
    for d in range(planes):
        u = ((mat >> (_DIGIT_BITS * d)) & _MASK).astype(np.int64) + carry
        high = u >= _HALF
        out[d] = (u - _BASE * high).astype(np.int8)
        carry = high.astype(np.int64)
    if carry.any():
        raise ValueError('top digit overflow: modulus too wide for the digit planes')
    return out


def _banded(mat: np.ndarray, planes: int) -> np.ndarray:
    """Constant matrix (K, M) → banded (D·K, S·M) int8, the contraction
    (d, k) against the output (s, m): band[d, k, s, m] = digit_{s-d}(mat)[k, m]."""
    S = 2 * planes - 1
    dig = _digits_balanced(mat, planes)           # (D, K, M)
    out = np.zeros((planes, mat.shape[0], S, mat.shape[1]), dtype=np.int8)
    for d in range(planes):
        for e in range(planes):
            out[d, :, d + e, :] = dig[e]
    return out.reshape(planes * mat.shape[0], S * mat.shape[1])


def _limb_tables(q: int, psi: int, psi_inv: int, R: int, C: int, planes: int) -> dict:
    """One prime's four-step tables (the JAX module's ``_LimbPlan``)."""
    n = R * C
    omega = psi * psi % q
    omega_inv = pow(omega, -1, q)
    logR, logC = R.bit_length() - 1, C.bit_length() - 1
    brvR = [_brv(a, logR) for a in range(R)]
    brvC = [_brv(b, logC) for b in range(C)]

    def grid(rows, cols, f):
        return np.array([[f(i, j) for j in range(cols)] for i in range(rows)], dtype=object)

    # forward: y[a·C+b] = Σ_j x[j]·ψ^j·ω^{e(a,b)·j}, e = brvC(b)·R + brvR(a),
    # j = j1 + R·j2
    A = grid(C, R, lambda j2, a: pow(psi, R * j2, q) * pow(pow(omega, (R * j2) % n, q),
                                                           brvR[a] % C, q) % q)
    T = grid(R, R, lambda j1, a: pow(psi, j1, q) * pow(omega, (brvR[a] * j1) % n, q) % q)
    B = grid(R, C, lambda j1, b: pow(omega, (R * brvC[b] * j1) % n, q))
    # inverse: x[C·j1'+j2'] = n^-1 Σ_pos y[pos]·ψ^{-j·(2·brv(pos)+1)}
    W1 = grid(C, C, lambda b, j2p: pow(omega_inv, (R * brvC[b] * j2p) % n, q))
    Ti = grid(R, C, lambda a, j2p: pow(psi_inv, (j2p * (2 * brvR[a] + 1)) % (2 * n), q))
    ninv = pow(n, -1, q)
    psiC_inv = pow(psi_inv, C, q)
    W2 = grid(R, R, lambda a, j1p: ninv * pow(psiC_inv, (j1p * (2 * brvR[a] + 1)) % (2 * n),
                                              q) % q)

    def s64(mat):
        return np.array([[_u.to_s64(v) for v in row] for row in mat], dtype=np.int64)

    def shoup(mat):
        return s64(np.array([[(int(v) << 64) // q for v in row] for row in mat], dtype=object))

    return {
        'q': q, 'pinv': _u.to_s64((-pow(q, -1, 1 << 64)) % (1 << 64)),
        # chunk Montgomery constants M_k = 2^{42k}·2^64 mod q: each exact
        # chunk goes straight to its mod-q contribution
        'M': [(1 << (64 + 6 * _DIGIT_BITS * k)) % q for k in range(3)],
        # the signed chunks' offset, corrected once: Σ_k OFF·2^{42k} mod q
        # over the chunks that exist, ceil(S/6) of them (the JAX module sums
        # three, which is wrong below 43-bit primes, where S < 13)
        'offadj': sum((_OFF << (6 * _DIGIT_BITS * k)) % q
                      for k in range(-(-(2 * planes - 1) // 6))) % q,
        'A': _banded(A, planes), 'B': _banded(B, planes),
        'W1': _banded(W1, planes), 'W2': _banded(W2, planes),
        'T': s64(T), 'T_sh': shoup(T), 'Ti': s64(Ti), 'Ti_sh': shoup(Ti),
    }


class _Plan:
    """A ring's stacked four-step tables on one device: banded constants in
    the route's dot type, (L, D·K, S·M); twiddles and Montgomery constants as
    int64 (64-bit patterns)."""

    def __init__(self, ring, dot_dtype):
        self.R, self.C = shape(ring.n)
        self.D = planes_of(ring.moduli)
        self.S = 2 * self.D - 1
        limbs = [_limb_tables(r.q, r.psi, r.psi_inv, self.R, self.C, self.D) for r in ring.rings]
        dev = ring.device

        def col(key, shape=(-1, 1, 1, 1)):
            return torch.tensor([_u.to_s64(t[key]) for t in limbs], dtype=torch.int64,
                                device=dev).reshape(shape)

        def stack(key, dtype=None):
            t = torch.from_numpy(np.stack([lt[key] for lt in limbs]))
            return t.to(device=dev, dtype=dtype or t.dtype)

        self.q, self.pinv, self.offadj = col('q'), col('pinv'), col('offadj')
        self.M = torch.tensor([[_u.to_s64(m) for m in t['M']] for t in limbs],
                              dtype=torch.int64, device=dev)                     # (L, 3)
        self.band = {k: stack(k, dot_dtype) for k in ('A', 'B', 'W1', 'W2')}
        self.tw = {k: stack(k)[:, None] for k in ('T', 'T_sh', 'Ti', 'Ti_sh')}   # (L, 1, ., .)


_PLANS: dict = {}


def _dot_dtype(device: torch.device):
    if I8DOT:
        return torch.int8
    return torch.bfloat16 if device.type == 'cuda' else torch.float32


def _plan(ring, dot_dtype) -> _Plan:
    key = (ring.moduli, ring.n, ring.device, dot_dtype)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _Plan(ring, dot_dtype)
    return plan


def _split_planes(x, D: int, dtype):
    """int64 (L, G, P, Q) residues → balanced digit planes (L, G, P, D, Q)
    in the dot type: the contraction axis (d, P) made adjacent."""
    planes, carry = [], None
    for d in range(D):
        u = (x >> (_DIGIT_BITS * d)) & _MASK
        if carry is not None:
            u = u + carry
        high = u >= _HALF
        planes.append(torch.where(high, u - _BASE, u).to(dtype))
        carry = high.long()
    return torch.stack(planes, dim=-2)


def _pad_to(t, dim: int, size: int):
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, size - t.shape[dim]]
    return torch.nn.functional.pad(t, pad)


def _matmul(a, b):
    """(L, M, K) × (L, K, N) digit-plane products with exact sums → int64."""
    if a.dtype == torch.int8:
        L, M, K = a.shape
        N = b.shape[-1]
        Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
        out = []
        for i in range(L):
            ai = _pad_to(_pad_to(a[i], 0, Mp), 1, Kp)
            bi = _pad_to(_pad_to(b[i], 0, Kp), 1, Np)
            out.append(torch._int_mm(ai.contiguous(), bi.contiguous())[:M, :N])
            if a.is_cuda:
                launches['mxu_int_mm'] += 1
        return torch.stack(out).long()
    if a.is_cuda:
        launches['mxu_bmm'] += 1
        return torch.bmm(a, b, out_dtype=torch.float32).long()
    return torch.bmm(a, b).long()


def _recombine(s, plan: _Plan):
    """Signed diagonal sums (L, G, P, S, Q) int64 → (L, G, P, Q) mod q.

    Exact: chunk k sums diagonals [6k, 6k+6) as Σ S_s·2^{7(s-6k)}
    (|chunk| < 2^58); the +2^59 offset makes it a positive 64-bit word for
    the Montgomery product with M_k, corrected once by ``offadj``."""
    S = s.shape[-2]
    q, pinv = plan.q, plan.pinv                                  # (L, 1, 1, 1)
    out = None
    for k in range(3):
        lo, hi = 6 * k, min(6 * k + 6, S)
        if lo >= S:
            break
        chunk = s[..., lo, :]
        for t in range(lo + 1, hi):
            chunk = chunk + (s[..., t, :] << (_DIGIT_BITS * (t - lo)))
        term = _u.mont_mul64(chunk + _OFF, plan.M[:, k].reshape(-1, 1, 1, 1), q, pinv)
        out = term if out is None else _u.addmod(out, term, q)
    return _u.submod(out, plan.offadj, q)


def _mod_dot(x, band, plan: _Plan, dtype):
    """x (L, G, P, Q) int64 contracted over P against the banded constant
    (L, D·P, S·W) → (L, G, Q, W) mod q."""
    L, G, P, Q = x.shape
    xp = _split_planes(x, plan.D, dtype)                 # (L, G, P, D, Q)
    a = xp.permute(0, 1, 4, 3, 2).reshape(L, G * Q, plan.D * P)
    s = _matmul(a, band)                                 # (L, G·Q, S·W)
    s = s.reshape(L, G, Q, plan.S, -1)
    return _recombine(s, plan)


class _Sub:
    """The first L limbs of a plan's per-limb constants."""

    def __init__(self, plan: _Plan, L: int):
        self.D, self.S = plan.D, plan.S
        self.q, self.pinv = plan.q[:L], plan.pinv[:L]
        self.M, self.offadj = plan.M[:L], plan.offadj[:L]


def _limb_major(x, ring):
    _u.require_word(ring, 64, 'ntt_mxu')
    if x.dtype != torch.int64:
        raise TypeError(f'expected an int64 tensor, got {x.dtype}')
    L, n = x.shape[-2], x.shape[-1]
    if n != ring.n or L > len(ring.moduli):
        raise ValueError(f'expected (..., L <= {len(ring.moduli)}, {ring.n}), '
                         f'got {tuple(x.shape)}')
    if x.device != ring.device:
        raise ValueError(f'tensor on {x.device}, ring on {ring.device}')
    return x.reshape(-1, L, n).transpose(0, 1)           # (L, G, n)


def ntt(x, ring):
    """Forward negacyclic NTT of int64 (..., L, n) in [0, q) over the first
    L limbs of ``ring``; output bit-reversed (``core/ntt.py``'s order)."""
    lead, (L, n) = x.shape[:-2], x.shape[-2:]
    xl = _limb_major(x, ring)
    dtype = _dot_dtype(x.device)
    pl = _plan(ring, dtype)
    R, C = pl.R, pl.C
    sub = _Sub(pl, L)
    # X[j1, j2] = x[j1 + R·j2]: rows j2 (contracted first), columns j1
    z = _mod_dot(xl.reshape(L, -1, C, R), pl.band['A'][:L], sub, dtype)    # (L, G, j1, a)
    z = _u.shoup_mul64(z, pl.tw['T'][:L], pl.tw['T_sh'][:L], sub.q)
    y = _mod_dot(z, pl.band['B'][:L], sub, dtype)                          # (L, G, a, b)
    return y.reshape(L, -1, n).transpose(0, 1).reshape(*lead, L, n)


def intt(x, ring):
    """Inverse of ``ntt``: bit-reversed input, natural output scaled by n^-1."""
    lead, (L, n) = x.shape[:-2], x.shape[-2:]
    xl = _limb_major(x, ring)
    dtype = _dot_dtype(x.device)
    pl = _plan(ring, dtype)
    R, C = pl.R, pl.C
    sub = _Sub(pl, L)
    # Y[a, b] = y[a·C + b]: contract b first
    y = xl.reshape(L, -1, R, C).transpose(-1, -2)                          # (L, G, b, a)
    z = _mod_dot(y, pl.band['W1'][:L], sub, dtype)                         # (L, G, a, j2')
    z = _u.shoup_mul64(z, pl.tw['Ti'][:L], pl.tw['Ti_sh'][:L], sub.q)
    out = _mod_dot(z, pl.band['W2'][:L], sub, dtype)                       # (L, G, j2', j1')
    # x[C·j1' + j2'] = out[j2', j1']
    return out.transpose(-1, -2).reshape(L, -1, n).transpose(0, 1).reshape(*lead, L, n)
