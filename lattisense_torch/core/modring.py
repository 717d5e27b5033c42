"""Per-prime ring constants and NTT twiddle tables (host precompute).

For each NTT-friendly 31-bit prime q (q ≡ 1 mod 2n) this builds, exactly
and with the reference's conventions (``lattisense_tpu/core/modring.py`` at
word_bits=32):

- Montgomery constants ``pinv`` = -q^-1 mod 2^32, ``r1`` = 2^32 mod q,
  ``r2`` = 2^64 mod q, and n^-1 mod q;
- the deterministic primitive 2n-th root ψ and the bit-reversed twiddle
  tables ``psi_rev[i] = ψ^brv(i)``, ``psi_inv_rev[i] = ψ^-brv(i)``, each with
  its Shoup companion floor(w·2^32/q).

Powers are computed in NumPy int64: every product of two residues below 2^31
fits. ``get_rns_ring`` stacks a chain's tables as int64 tensors on one device
and caches them per (moduli, n, device).
"""

import functools

import numpy as np
import torch

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(m: int) -> bool:
    """Deterministic Miller–Rabin; exact for m < 3.3·10^24 with these bases."""
    if m < 2:
        return False
    for b in _MR_BASES:
        if m % b == 0:
            return m == b
    d, s = m - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for b in _MR_BASES:
        x = pow(b, d, m)
        if x in (1, m - 1):
            continue
        for _ in range(s - 1):
            x = x * x % m
            if x == m - 1:
                break
        else:
            return False
    return True


def bit_reverse_indices(logn: int) -> np.ndarray:
    idx = np.arange(1 << logn, dtype=np.int64)
    out = np.zeros_like(idx)
    for bit in range(logn):
        out |= ((idx >> bit) & 1) << (logn - 1 - bit)
    return out


@functools.lru_cache(maxsize=None)
def find_primitive_2nth_root(q: int, n: int) -> int:
    """The reference's deterministic primitive 2n-th root of unity mod q."""
    if (q - 1) % (2 * n) != 0:
        raise ValueError(f'prime {q} is not NTT-friendly for n={n}')
    exp = (q - 1) // (2 * n)
    for x in range(2, 1 << 20):
        psi = pow(x, exp, q)
        if psi != 1 and pow(psi, n, q) == q - 1:
            return psi
    raise RuntimeError(f'no primitive 2n-th root found for q={q}, n={n}')


def gen_ntt_primes(n: int, bit_size: int, count: int, exclude=()) -> list[int]:
    """``count`` primes ≡ 1 mod 2n just below 2^bit_size, in descending
    order, skipping ``exclude`` (the reference's scan, same primes)."""
    step = 2 * n
    candidate = (1 << bit_size) - 1
    candidate -= (candidate - 1) % step
    found: list[int] = []
    excl = set(exclude)
    while len(found) < count and candidate > (1 << (bit_size - 1)):
        if candidate not in excl and is_prime(candidate):
            found.append(candidate)
        candidate -= step
    if len(found) < count:
        raise RuntimeError(f'not enough {bit_size}-bit NTT primes for n={n}')
    return found


def _powers(base: int, n: int, q: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod q by doubling (int64-exact, q < 2^31)."""
    out = np.ones(n, dtype=np.int64)
    k, step = 1, base % q
    while k < n:
        out[k:2 * k] = out[:k] * step % q
        step = step * step % q
        k *= 2
    return out


class PrimeRing:
    """Constants and tables for Z_q[x]/(x^n+1) with one 31-bit prime q."""

    def __init__(self, q: int, n: int):
        if q >= (1 << 31):
            raise ValueError(f'prime {q} too large for the 32-bit word')
        self.q = q
        self.n = n
        self.logn = n.bit_length() - 1
        if 1 << self.logn != n:
            raise ValueError(f'n must be a power of two, got {n}')
        R = 1 << 32
        self.pinv = (-pow(q, -1, R)) % R
        self.r1 = R % q
        self.r2 = (R * R) % q
        self.n_inv = pow(n, -1, q)
        self.psi = find_primitive_2nth_root(q, n)
        self.psi_inv = pow(self.psi, -1, q)
        brv = bit_reverse_indices(self.logn)
        self.psi_rev = _powers(self.psi, n, q)[brv]
        self.psi_inv_rev = _powers(self.psi_inv, n, q)[brv]
        self.psi_rev_shoup = (self.psi_rev << 32) // q
        self.psi_inv_rev_shoup = (self.psi_inv_rev << 32) // q
        self.n_inv_shoup = (self.n_inv << 32) // q


@functools.lru_cache(maxsize=None)
def get_prime_ring(q: int, n: int) -> PrimeRing:
    return PrimeRing(q, n)


class RnsRing:
    """Stacked per-limb constants of a modulus chain as int64 tensors on one
    device: columns (L, 1) and twiddle tables (L, n), broadcastable against
    (..., L, n) coefficient stacks."""

    def __init__(self, moduli: tuple[int, ...], n: int, device: torch.device):
        self.moduli = tuple(int(m) for m in moduli)
        self.n = n
        self.device = device
        rings = [get_prime_ring(q, n) for q in self.moduli]
        self.rings = rings

        def col(attr):
            return torch.tensor([getattr(r, attr) for r in rings],
                                dtype=torch.int64, device=device).reshape(-1, 1)

        def table(attr):
            return torch.from_numpy(np.stack([getattr(r, attr) for r in rings])).to(device)

        self.q = col('q')
        self.pinv = col('pinv')
        self.r1 = col('r1')
        self.r2 = col('r2')
        self.n_inv = col('n_inv')
        self.n_inv_shoup = col('n_inv_shoup')
        self.psi_rev = table('psi_rev')
        self.psi_rev_shoup = table('psi_rev_shoup')
        self.psi_inv_rev = table('psi_inv_rev')
        self.psi_inv_rev_shoup = table('psi_inv_rev_shoup')


def get_rns_ring(moduli, n: int, device) -> RnsRing:
    """The cached ring of ``moduli`` at degree ``n`` on ``device``."""
    return _rns_ring(tuple(int(m) for m in moduli), int(n), torch.device(device))


@functools.lru_cache(maxsize=None)
def _rns_ring(moduli: tuple[int, ...], n: int, device: torch.device) -> RnsRing:
    return RnsRing(moduli, n, device)
