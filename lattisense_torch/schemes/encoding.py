"""Slot encoding (host side): BFV slot batching and the CKKS canonical embedding.

Port of ``lattisense_tpu/schemes/encoding.py``. BFV messages are
vectors over Z_t laid out as a 2×(n/2) matrix; slot (r, c) is the evaluation
of the plaintext polynomial at ζ^((2n-1)^r · 5^c mod 2n). The slot → NTT
position permutation is derived from the NTT tables themselves (discrete log
of the transform of x), so it holds for the port's bit-reversal convention.
The transforms over Z_t run on the CPU with the plain NTT (t < 2^31 is a
32-bit-word prime; the values do not depend on the word).

CKKS slots are the evaluations of the real plaintext polynomial at ζ^(5^c)
(ζ = e^{iπ/n}), computed with NumPy's FFT in float64 exactly as the
reference computes them; encoding rounds the scaled coefficients to Python
integers (exact at any scale).
"""

import functools

import numpy as np
import torch

from ..core import ntt as ntt_mod
from ..core.modring import get_rns_ring

_CPU = torch.device('cpu')


def _ring_t(t: int, n: int):
    return get_rns_ring((t,), n, _CPU)


@functools.lru_cache(maxsize=None)
def _ntt_exponent_map(t: int, n: int) -> np.ndarray:
    """exp_of_pos[i] = e such that NTT output position i is the evaluation
    at ψ^e, derived by transforming the monomial x."""
    ring = _ring_t(t, n)
    x = torch.zeros((1, n), dtype=torch.int64)
    x[0, 1] = 1
    evals = ntt_mod.ntt(x, ring)[0].numpy()
    psi = ring.rings[0].psi
    dlog = {}
    cur = 1
    for k in range(2 * n):
        dlog[cur] = k
        cur = cur * psi % t
    return np.array([dlog[int(v)] for v in evals], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _bfv_slot_perm(t: int, n: int) -> np.ndarray:
    """perm[s] = NTT position of slot s (s = r*(n/2) + c)."""
    exp_of_pos = _ntt_exponent_map(t, n)
    pos_of_exp = np.full(2 * n, -1, dtype=np.int64)
    pos_of_exp[exp_of_pos] = np.arange(n)
    half = n // 2
    perm = np.empty(n, dtype=np.int64)
    e = 1
    for c in range(half):
        perm[c] = pos_of_exp[e]
        perm[half + c] = pos_of_exp[(2 * n - 1) * e % (2 * n)]
        e = e * 5 % (2 * n)
    if (perm < 0).any():
        raise RuntimeError(f'slot permutation incomplete for t={t}, n={n}')
    return perm


def bfv_encode_slots(values, t: int, n: int) -> np.ndarray:
    """Z_t slot vector (≤ n entries, zero-padded) → plaintext polynomial
    mod t, (n,) int64."""
    perm = _bfv_slot_perm(t, n)
    v = np.zeros(n, dtype=np.int64)
    vals = np.asarray(values, dtype=np.uint64) % np.uint64(t)
    v[:len(vals)] = vals.astype(np.int64)
    evals = np.zeros((1, n), dtype=np.int64)
    evals[0, perm] = v
    return ntt_mod.intt(torch.from_numpy(evals), _ring_t(t, n))[0].numpy()


def bfv_decode_slots(poly_mod_t: np.ndarray, t: int, n: int) -> np.ndarray:
    """Plaintext polynomial mod t (n,) → slot vector (n,) over Z_t."""
    perm = _bfv_slot_perm(t, n)
    poly = torch.from_numpy(np.asarray(poly_mod_t, dtype=np.int64).reshape(1, n).copy())
    return ntt_mod.ntt(poly, _ring_t(t, n))[0].numpy()[perm]


# ---------------------------------------------------------------------------
# CKKS canonical embedding (host float64)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ckks_tables(n: int):
    half = n // 2
    j = np.arange(n)
    twist = np.exp(1j * np.pi * j / n)              # ζ^j, ζ = e^{iπ/n}
    # slot c ↔ evaluation at ζ^(5^c); exponent 2k+1 ↔ FFT bin k
    e = np.empty(half, dtype=np.int64)
    cur = 1
    for c in range(half):
        e[c] = cur
        cur = cur * 5 % (2 * n)
    k_pos = (e - 1) // 2
    k_neg = (2 * n - e - 1) // 2
    return twist, k_pos, k_neg


def ckks_embed_inv(values: np.ndarray, n: int) -> np.ndarray:
    """Complex slot vector (n/2, replicated if sparse) → real coeffs (n,) float."""
    twist, k_pos, k_neg = _ckks_tables(n)
    evals = np.zeros(n, dtype=np.complex128)
    v = np.asarray(values, dtype=np.complex128)
    evals[k_pos] = v
    evals[k_neg] = np.conj(v)
    # evals[k] = m(ζ^{2k+1}) = Σ_j (m_j ζ^j) e^{2πi jk / n} = n·ifft(twisted)
    tw = np.fft.fft(evals) / n
    return np.real(tw * np.conj(twist))


def ckks_embed(coeffs: np.ndarray, n: int) -> np.ndarray:
    """Real coeffs (n,) → complex slot vector (n/2,)."""
    twist, k_pos, k_neg = _ckks_tables(n)
    evals = n * np.fft.ifft(np.asarray(coeffs, dtype=np.float64) * twist)
    return evals[k_pos]


def ckks_encode_values(values, n: int, slots: int, scale: float) -> np.ndarray:
    """Complex/real message (≤ slots entries) → scaled integer coeffs (n,),
    each the float rounded half to even as Python's ``round``: int64 when
    every coefficient lies below 2^62 in magnitude (``np.rint`` gives the same
    integers there), else exact Python ints (large scales)."""
    half = n // 2
    v = np.zeros(slots, dtype=np.complex128)
    vals = np.asarray(values, dtype=np.complex128)
    v[:len(vals)] = vals
    dense = np.tile(v, half // slots)
    coeffs = ckks_embed_inv(dense, n) * scale
    if np.all(np.abs(coeffs) < 2.0 ** 62):
        return np.rint(coeffs).astype(np.int64)
    return np.array([int(round(c)) for c in coeffs], dtype=object)


def ckks_decode_values(coeffs_signed, n: int, slots: int, scale: float) -> np.ndarray:
    """Signed integer coeffs (n,) → complex message (slots,)."""
    c = np.array([float(x) for x in coeffs_signed], dtype=np.float64) / scale
    dense = ckks_embed(c, n)
    return dense[:slots]
