"""BFV parameter sets for both machine words.

The canonical table ``parameter.json`` (a byte-identical copy of
``lattisense_tpu/parameter.json``) gives the u64 chains (``BfvParams.create``,
primes up to 61 bits, ``word_bits=64``); the runtime also re-cuts their logQP
budgets into 31-bit NTT primes (``BfvParams.create_tpu_param``,
``word_bits=32``) and derives the auxiliary BEHZ basis for multiplication at
either word (``bfv_aux_basis``).
"""

import functools
import json
import math
import os

_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'parameter.json')
MTILDE_BITS = 16
MTILDE = 1 << MTILDE_BITS


@functools.lru_cache(maxsize=None)
def _load_table():
    with open(_TABLE_PATH) as f:
        return json.load(f)


def _recut31_capped(log_q: int, log_p: int) -> tuple[int, int]:
    """Split a logQP budget into 31-bit limb counts without exceeding it:
    total limbs are floored into the budget, and the q/p split keeps the
    source chain's proportion (at least one special prime)."""
    total = (log_q + log_p) // 31
    npr = max(1, min(total - 1, round(total * log_p / (log_q + log_p))))
    return total - npr, npr


class BfvParams:
    """BFV parameters: ring degree n, plaintext modulus t, q chain, special
    primes p, and the machine word: 64 (all primes < 2^62; the default, as in
    the reference) or ``word_bits=32`` (all primes < 2^31)."""

    def __init__(self, n: int, t: int, q: list[int], p: list[int],
                 word_bits: int = 64):
        self.n = int(n)
        if self.n < 2 or self.n & (self.n - 1):
            raise ValueError(f'n must be a power of two, got {n}')
        self.t = int(t)
        self.q = [int(x) for x in q]
        self.p = [int(x) for x in p]
        self.max_level = len(self.q) - 1
        self.word_bits = int(word_bits)
        if self.word_bits not in (32, 64):
            raise ValueError(f'word_bits must be 32 or 64, got {word_bits}')
        limit = 31 if self.word_bits == 32 else 62
        if any(x >= (1 << limit) for x in self.q + self.p):
            raise ValueError(f'word_bits={self.word_bits} requires all primes < 2^{limit}')

    @classmethod
    def create_custom(cls, n: int, t: int, q: list[int], p: list[int],
                      word_bits: int = 64) -> 'BfvParams':
        return cls(n, t, q, p, word_bits)

    @classmethod
    def create(cls, n: int, t: int | None = None) -> 'BfvParams':
        """The canonical chain of ``parameter.json`` on the 64-bit word: the
        same primes as ``lattisense_tpu.params.BfvParams.create``."""
        entry = _load_table()['BFV'][str(n)]
        return cls(n, t if t is not None else entry['t'], entry['q'], entry['p'], word_bits=64)

    @classmethod
    def create_tpu_param(cls, n: int, t: int | None = None) -> 'BfvParams':
        """The 31-bit profile: the default chain's logQP budget re-cut into
        31-bit NTT primes (limb counts floored into the budget), word_bits=32.
        The same primes as ``lattisense_tpu.params.BfvParams.create_tpu_param``."""
        from .core.modring import gen_ntt_primes
        entry = _load_table()['BFV'][str(n)]
        nq, npr = _recut31_capped(
            sum(int(x).bit_length() for x in entry['q']),
            sum(int(x).bit_length() for x in entry['p']))
        primes = gen_ntt_primes(n, 31, nq + npr)
        return cls(n, t if t is not None else entry['t'], primes[:nq], primes[nq:], word_bits=32)

    def q_prod(self, level: int) -> int:
        return math.prod(self.q[:level + 1])

    def delta(self, level: int) -> int:
        """Δ_ℓ = floor(Q_ℓ / t) — BFV plaintext scaling at level ℓ."""
        return self.q_prod(level) // self.t


@functools.lru_cache(maxsize=None)
def bfv_aux_basis(n: int, q: tuple[int, ...], p: tuple[int, ...],
                  word_bits: int = 64) -> tuple[tuple[int, ...], int]:
    """Auxiliary basis (B, m_sk) for BEHZ multiplication: NTT primes at the
    word's size (31 or 59 bits) distinct from q ∪ p, sized so every
    per-level prefix B_ℓ exceeds the scaled tensor-product bound 8·t·n·Q_ℓ,
    plus one m_sk (the reference's rule, ``lattisense_tpu/params.py``)."""
    from .core.modring import gen_ntt_primes
    if word_bits == 64:
        bit_size, count = 59, len(q) + 2
    else:
        bit_size, count = 31, (sum(x.bit_length() for x in q) + 34) // 30 + 2
    primes = gen_ntt_primes(n, bit_size, count, exclude=tuple(q) + tuple(p))
    return tuple(primes[:-1]), primes[-1]
