"""Per-prime ring constants and NTT twiddle tables (host precompute).

For each NTT-friendly prime q (q ≡ 1 mod 2n) this builds, exactly and with
the reference's conventions (``lattisense_tpu/core/modring.py``), for the
machine word R = 2^word_bits (32 with q < 2^31, or 64 with q < 2^62):

- Montgomery constants ``pinv`` = -q^-1 mod R, ``r1`` = R mod q,
  ``r2`` = R^2 mod q, and n^-1 mod q;
- the deterministic primitive 2n-th root ψ and the bit-reversed twiddle
  tables ``psi_rev[i] = ψ^brv(i)``, ``psi_inv_rev[i] = ψ^-brv(i)``, each with
  its Shoup companion floor(w·R/q).

At the 32-bit word the powers are computed in NumPy int64 (every product of
two residues below 2^31 fits); at the 64-bit word with Python integers.
64-bit constants are kept as int64 bit patterns (``u64.to_s64``).
``get_rns_ring`` stacks a chain's tables as int64 tensors on one device and
caches them per (moduli, n, device, word_bits).
"""

import functools

import numpy as np
import torch

from ..utils import observability
from . import u64 as _u

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


def _powers_int(base: int, n: int, q: int) -> list[int]:
    """[base^0, ..., base^(n-1)] mod q with Python integers (any q)."""
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % q
    return out


def _s64_array(vals) -> np.ndarray:
    """Python integers in [0, 2^64) as an int64 array of the same bits."""
    return np.array(vals, dtype=np.uint64).view(np.int64)


class PrimeRing:
    """Constants and tables for Z_q[x]/(x^n+1) with one prime q on the
    ``word_bits`` machine word. Scalars are Python integers in [0, R);
    tables are int64 arrays (64-bit Shoup companions as bit patterns)."""

    def __init__(self, q: int, n: int, word_bits: int = 32):
        if word_bits not in (32, 64):
            raise ValueError(f'word_bits must be 32 or 64, got {word_bits}')
        if q >= (1 << (word_bits - 2 if word_bits == 64 else 31)):
            raise ValueError(f'prime {q} too large for the {word_bits}-bit word')
        self.q = q
        self.n = n
        self.word_bits = word_bits
        self.logn = n.bit_length() - 1
        if 1 << self.logn != n:
            raise ValueError(f'n must be a power of two, got {n}')
        R = 1 << word_bits
        self.pinv = (-pow(q, -1, R)) % R
        self.r1 = R % q
        self.r2 = (R * R) % q
        self.n_inv = pow(n, -1, q)
        self.psi = find_primitive_2nth_root(q, n)
        self.psi_inv = pow(self.psi, -1, q)
        brv = bit_reverse_indices(self.logn)
        if word_bits == 32:
            self.psi_rev = _powers(self.psi, n, q)[brv]
            self.psi_inv_rev = _powers(self.psi_inv, n, q)[brv]
            self.psi_rev_shoup = (self.psi_rev << 32) // q
            self.psi_inv_rev_shoup = (self.psi_inv_rev << 32) // q
        else:
            fwd = _powers_int(self.psi, n, q)
            inv = _powers_int(self.psi_inv, n, q)
            fwd = [fwd[i] for i in brv.tolist()]
            inv = [inv[i] for i in brv.tolist()]
            self.psi_rev = np.array(fwd, dtype=np.int64)
            self.psi_inv_rev = np.array(inv, dtype=np.int64)
            self.psi_rev_shoup = _s64_array([(w << 64) // q for w in fwd])
            self.psi_inv_rev_shoup = _s64_array([(w << 64) // q for w in inv])
        self.n_inv_shoup = (self.n_inv << word_bits) // q


@functools.lru_cache(maxsize=None)
def get_prime_ring(q: int, n: int, word_bits: int = 32) -> PrimeRing:
    return PrimeRing(q, n, word_bits)


class RnsRing:
    """Stacked per-limb constants of a modulus chain as int64 tensors on one
    device: columns (L, 1) and twiddle tables (L, n), broadcastable against
    (..., L, n) coefficient stacks. ``word`` is the arithmetic of the ring's
    machine word (``u64.word(word_bits)``)."""

    def __init__(self, moduli: tuple[int, ...], n: int, device: torch.device,
                 word_bits: int = 32):
        self.moduli = tuple(int(m) for m in moduli)
        self.n = n
        self.device = device
        self.word_bits = word_bits
        self.word = _u.word(word_bits)
        rings = [get_prime_ring(q, n, word_bits) for q in self.moduli]
        self.rings = rings

        def col(attr):
            return torch.tensor([_u.to_s64(getattr(r, attr)) for r in rings],
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


def get_rns_ring(moduli, n: int, device, word_bits: int = 32) -> RnsRing:
    """The cached ring of ``moduli`` at degree ``n`` on ``device`` for the
    ``word_bits`` machine word."""
    return _rns_ring(tuple(int(m) for m in moduli), int(n), torch.device(device),
                     int(word_bits))


@functools.lru_cache(maxsize=None)
def _rns_ring(moduli: tuple[int, ...], n: int, device: torch.device,
              word_bits: int) -> RnsRing:
    return RnsRing(moduli, n, device, word_bits)


observability.probe_table('get_rns_ring', lambda: _rns_ring.cache_info().misses)
