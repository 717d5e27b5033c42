"""Galois automorphisms σ_g: m(x) → m(x^g) on R = Z[x]/(x^n+1), on tensors.

Port of ``lattisense_tpu/schemes/galois.py``. Column rotation by ``step``
uses g = 5^step mod 2n; the row swap uses g = 2n-1. Two index maps per
(n, g):

- coefficient domain: a gather with a sign flip (x^n = -1 wraps),
- NTT (bit-reversed evaluation) domain: a permutation of the evaluation
  points, the same for every RNS limb.

Both are plain gathers: the maps are built once on the host and cached as
int64 (or bool) tensors per (n, g, device). Also here: the NAF split of a
column rotation into power-of-two sub-rotations (``get_glk_col``), a copy
of the reference frontend's helper.
"""

import functools

import numpy as np
import torch

from ..core.modring import bit_reverse_indices

GALOIS_GEN = 5


def galois_elt_col(step: int, n: int, gen: int = GALOIS_GEN) -> int:
    """Galois element of a column rotation by ``step``."""
    mask = (n << 1) - 1
    return pow(gen, step & mask, n << 1)


def galois_elt_row(n: int) -> int:
    """Galois element of the row swap."""
    return (n << 1) - 1


def naf_decompose(x: int):
    """Signed-binary (NAF) digits of x: x = Σ 2^i (i ∈ pos) − Σ 2^i (i ∈ neg),
    each list in descending order."""
    pos, neg = [], []
    i = 0
    while x != 0:
        if x & 1:
            if (x & 3) == 1:
                pos.append(i)
                x -= 1
            else:
                neg.append(i)
                x += 1
        x >>= 1
        i += 1
    return sorted(pos, reverse=True), sorted(neg, reverse=True)


def get_glk_col(steps: int, poly_degree: int):
    """NAF split of a column rotation into power-of-two sub-rotations:
    (exponents of +2^i, exponents of -2^i)."""
    mask = (poly_degree >> 1) - 1
    pos, neg = naf_decompose(steps)
    pos = [i for i in pos if (2 ** i & mask) != 0]
    return pos, neg


def col_sub_steps(steps: int, n: int) -> list[int]:
    """The ±2^i sub-rotations a column rotation by ``steps`` is composed of,
    in the order they are applied (identities mod n/2 dropped)."""
    pos, neg = get_glk_col(steps, n)
    return [s for s in [2 ** i for i in pos] + [-(2 ** i) for i in neg] if abs(s) % (n // 2)]


@functools.lru_cache(maxsize=None)
def coeff_automorphism_maps(n: int, g: int):
    """(src, sign_neg) as numpy arrays: out[k] = ± in[src[k]], negated where
    sign_neg[k] is 1."""
    two_n = 2 * n
    g_inv = pow(g, -1, two_n)
    j = (np.arange(n, dtype=np.int64) * g_inv) % two_n
    sign_neg = (j >= n).astype(np.int64)
    src = np.where(j >= n, j - n, j)
    return src, sign_neg


@functools.lru_cache(maxsize=None)
def ntt_automorphism_perm(n: int, g: int) -> np.ndarray:
    """perm with out[..., i] = in[..., perm[i]]: σ_g in the NTT domain, where
    position i holds the evaluation at ψ^(2·brv(i)+1)."""
    two_n = 2 * n
    exp_of_pos = 2 * bit_reverse_indices(n.bit_length() - 1) + 1
    pos_of_exp = np.full(two_n, -1, dtype=np.int64)
    pos_of_exp[exp_of_pos] = np.arange(n)
    perm = pos_of_exp[(exp_of_pos * g) % two_n]
    if (perm < 0).any():
        raise ValueError(f'{g} is not a Galois element of degree {n}')
    return perm


@functools.lru_cache(maxsize=None)
def _coeff_maps_on(n: int, g: int, device: torch.device):
    src, sign_neg = coeff_automorphism_maps(n, g)
    return torch.from_numpy(src).to(device), torch.from_numpy(sign_neg.astype(bool)).to(device)


@functools.lru_cache(maxsize=None)
def _perm_on(n: int, g: int, device: torch.device):
    return torch.from_numpy(ntt_automorphism_perm(n, g)).to(device)


def apply_automorphism_coeff(x, q, n: int, g: int):
    """σ_g on coefficient-domain limbs x (..., L, n); q the (L, 1) moduli."""
    src, neg_mask = _coeff_maps_on(n, g, x.device)
    vals = x.index_select(-1, src)
    neg = torch.where(vals == 0, vals, q - vals)
    return torch.where(neg_mask, neg, vals)


def apply_automorphism_ntt(x, n: int, g: int):
    """σ_g on NTT-domain limbs x (..., L, n)."""
    return x.index_select(-1, _perm_on(n, g, x.device))
