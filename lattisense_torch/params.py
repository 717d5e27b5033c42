"""FHE parameter sets (BFV, and CKKS as a parameter class) for both words.

The canonical table ``parameter.json`` (a byte-identical copy of
``lattisense_tpu/parameter.json``) gives the u64 chains (``BfvParams.create``,
``CkksParams.create``, primes up to 61 bits, ``word_bits=64``); the runtime
also re-cuts their logQP budgets into 31-bit NTT primes
(``create_tpu_param``, ``word_bits=32``), derives the auxiliary BEHZ basis
for multiplication at either word (``bfv_aux_basis``) and rebuilds the
parameters of a compiled task (``params_from_task_json``).
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


def _recut31_primes(n: int, entry: dict) -> tuple[list[int], list[int]]:
    """The (q, p) 31-bit chains of a table entry's logQP budget."""
    from .core.modring import gen_ntt_primes
    nq, npr = _recut31_capped(sum(int(x).bit_length() for x in entry['q']),
                              sum(int(x).bit_length() for x in entry['p']))
    primes = gen_ntt_primes(n, 31, nq + npr)
    return primes[:nq], primes[nq:]


class FheParams:
    """The parameter base of both schemes: ring degree n (a power of two),
    the q chain, the special primes p, and the machine word: 64 (all primes
    < 2^62; the default, as in the reference) or ``word_bits=32`` (all
    primes < 2^31)."""

    algo = ''

    def __init__(self, n: int, q: list[int], p: list[int], word_bits: int = 64):
        self.n = int(n)
        if self.n < 2 or self.n & (self.n - 1):
            raise ValueError(f'n must be a power of two, got {n}')
        self.logn = self.n.bit_length() - 1
        self.q = [int(x) for x in q]
        self.p = [int(x) for x in p]
        self.max_level = len(self.q) - 1
        self.word_bits = int(word_bits)
        if self.word_bits not in (32, 64):
            raise ValueError(f'word_bits must be 32 or 64, got {word_bits}')
        limit = 31 if self.word_bits == 32 else 62
        if any(x >= (1 << limit) for x in self.q + self.p):
            raise ValueError(f'word_bits={self.word_bits} requires all primes < 2^{limit}')

    @property
    def max_sp_level(self) -> int:
        return len(self.p) - 1

    def q_prod(self, level: int) -> int:
        return math.prod(self.q[:level + 1])

    @property
    def p_prod(self) -> int:
        return math.prod(self.p)

    def level_of(self, n_limbs: int) -> int:
        return n_limbs - 1

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((self.algo, self.n, tuple(self.q), tuple(self.p), self.word_bits))


class BfvParams(FheParams):
    """BFV parameters: the ``FheParams`` fields and the plaintext modulus t."""

    algo = 'BFV'

    def __init__(self, n: int, t: int, q: list[int], p: list[int],
                 word_bits: int = 64):
        super().__init__(n, q, p, word_bits)
        self.t = int(t)

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
        entry = _load_table()['BFV'][str(n)]
        q, p = _recut31_primes(n, entry)
        return cls(n, t if t is not None else entry['t'], q, p, word_bits=32)

    @classmethod
    def create_tpu_custom(cls, n: int, t: int, log_q: int, log_p: int) -> 'BfvParams':
        """A 31-bit chain meeting the requested budgets as minimums (limb
        counts are ceiled, so logQP may pass log_q + log_p by up to 60 bits);
        warns when that passes the ring's 128-bit table row."""
        from .core.modring import gen_ntt_primes
        from .utils.security import check_security
        nq = -(-log_q // 31)
        npr = max(1, -(-log_p // 31))
        primes = gen_ntt_primes(n, 31, nq + npr)
        out = cls(n, t, primes[:nq], primes[nq:], word_bits=32)
        check_security(out, stacklevel=3)
        return out

    def delta(self, level: int) -> int:
        """Δ_ℓ = floor(Q_ℓ / t) — BFV plaintext scaling at level ℓ."""
        return self.q_prod(level) // self.t


class CkksParams(FheParams):
    """CKKS parameters: the ``FheParams`` fields, the slot count (a power of
    two in (0, n/2]) and the default scale (the last q prime when not
    given). A parameter class only: the port has no CKKS engine yet."""

    algo = 'CKKS'

    def __init__(self, n: int, q: list[int], p: list[int], slots: int | None = None,
                 scale: float = 0.0, word_bits: int = 64):
        super().__init__(n, q, p, word_bits)
        self.slots = int(slots) if slots else n // 2
        if self.slots & (self.slots - 1) or not (0 < self.slots <= n // 2):
            raise ValueError(f'slots must be a power of two in (0, n/2], got {slots}')
        self.scale = float(scale) if scale else float(q[-1])

    @classmethod
    def create(cls, n: int) -> 'CkksParams':
        entry = _load_table()['CKKS'][str(n)]
        return cls(n, entry['q'], entry['p'], entry['slots'], entry['scale'])

    @classmethod
    def create_custom(cls, n: int, q: list[int], p: list[int], slots: int | None = None,
                      scale: float = 0.0, word_bits: int = 64) -> 'CkksParams':
        return cls(n, q, p, slots, scale, word_bits)

    @classmethod
    def create_tpu_param(cls, n: int, slots: int | None = None) -> 'CkksParams':
        """The 31-bit CKKS profile: the default chain's logQP budget re-cut
        into 31-bit NTT primes (limb counts floored into the budget),
        word_bits=32, scale 2^30."""
        entry = _load_table()['CKKS'][str(n)]
        q, p = _recut31_primes(n, entry)
        return cls(n, q, p, slots or entry.get('slots'), float(1 << 30), word_bits=32)

    @classmethod
    def create_tpu_btp_param(cls, n: int = 65536, slots: int | None = None) -> 'CkksParams':
        """The 31-bit bootstrap profile: 48 q and 4 p limbs (logQP about
        1612 at n=2^16), word_bits=32, scale 2^30; warns if the chain passes
        the ring's 128-bit table row."""
        from .core.modring import gen_ntt_primes
        from .utils.security import check_security
        nq, npr = 48, 4
        primes = gen_ntt_primes(n, 31, nq + npr)
        out = cls(n, primes[:nq], primes[nq:], slots, float(1 << 30), word_bits=32)
        check_security(out, stacklevel=3)
        return out

    def set_log_slots(self, log_slots: int):
        self.slots = 1 << log_slots

    @property
    def log_slots(self) -> int:
        return self.slots.bit_length() - 1


def params_from_task_json(parameter: dict, word_bits: int = 64) -> FheParams:
    """Runtime parameters from a ``mega_ag.json`` 'parameter' blob: BFV when
    it holds ``t``, else CKKS, with a bootstrap task's ``btp_*`` fields
    attached as ``params.btp``. The blob is word-agnostic: ``word_bits`` is
    the word the executing engine uses."""
    if 't' in parameter:
        return BfvParams(parameter['n'], parameter['t'], parameter['q'], parameter['p'],
                         word_bits=word_bits)
    p = CkksParams(parameter['n'], parameter['q'], parameter['p'], parameter.get('slots'),
                   parameter.get('scale', 0.0), word_bits=word_bits)
    if 'btp_cts_depth' in parameter:
        p.btp = {k: v for k, v in parameter.items() if k.startswith('btp_')}
    return p


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
