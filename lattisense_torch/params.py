"""BFV parameter sets for the 32-bit word engine.

The default logQP budgets come from the canonical table ``parameter.json``
(a byte-identical copy of ``lattisense_tpu/parameter.json``); the runtime
re-cuts them into 31-bit NTT primes (``BfvParams.create_tpu_param``) and
derives the auxiliary BEHZ basis for multiplication (``bfv_aux_basis``).
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
    primes p. Only ``word_bits=32`` (all primes < 2^31) is ported."""

    def __init__(self, n: int, t: int, q: list[int], p: list[int],
                 word_bits: int = 32):
        if int(word_bits) != 32:
            raise NotImplementedError(
                'lattisense_torch ports word_bits=32 only; the u64 word is the '
                '"u64 word size" item of ROADMAP.md, queue 1')
        self.n = int(n)
        if self.n < 2 or self.n & (self.n - 1):
            raise ValueError(f'n must be a power of two, got {n}')
        self.t = int(t)
        self.q = [int(x) for x in q]
        self.p = [int(x) for x in p]
        self.max_level = len(self.q) - 1
        self.word_bits = 32
        if any(x >= (1 << 31) for x in self.q + self.p):
            raise ValueError('word_bits=32 requires all primes < 2^31')

    @classmethod
    def create_custom(cls, n: int, t: int, q: list[int], p: list[int],
                      word_bits: int = 32) -> 'BfvParams':
        return cls(n, t, q, p, word_bits)

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
        return cls(n, t if t is not None else entry['t'], primes[:nq], primes[nq:])

    def q_prod(self, level: int) -> int:
        return math.prod(self.q[:level + 1])

    def delta(self, level: int) -> int:
        """Δ_ℓ = floor(Q_ℓ / t) — BFV plaintext scaling at level ℓ."""
        return self.q_prod(level) // self.t


@functools.lru_cache(maxsize=None)
def bfv_aux_basis(n: int, q: tuple[int, ...], p: tuple[int, ...]) -> tuple[tuple[int, ...], int]:
    """Auxiliary basis (B, m_sk) for BEHZ multiplication: 31-bit NTT primes
    distinct from q ∪ p, sized so every per-level prefix B_ℓ exceeds the
    scaled tensor-product bound 8·t·n·Q_ℓ, plus one m_sk."""
    from .core.modring import gen_ntt_primes
    count = (sum(x.bit_length() for x in q) + 34) // 30 + 2
    primes = gen_ntt_primes(n, 31, count, exclude=tuple(q) + tuple(p))
    return tuple(primes[:-1]), primes[-1]
