"""Exact word-modular arithmetic on int64 tensors, for both machine words.

The reference (``lattisense_tpu/core/u64.py``) computes on u32 or u64 arrays
with wrapping multiplies and picks the word from the array's dtype. PyTorch
implements only ``*`` and ``&`` for its unsigned types, so residues travel
here as ``torch.int64`` for both words and the word travels with the
constants instead: rings and constant holders carry ``word_bits``, and
``word(bits)`` gives the namespace of functions for that word.

32-bit word (R = 2^32, primes below 2^31; ``mulhi``, ``redc``, ...):

- the product of two values below 2^32 is below 2^64: int64 ``*`` wraps it
  modulo 2^64, so its low word is ``prod & MASK32`` and its high word
  ``(prod >> 32) & MASK32`` (``>>`` is arithmetic, hence the mask);
- products of two residues below 2^31 are below 2^62 and need no mask.

64-bit word (R = 2^64, primes below 2^62; ``mulhi64``, ``redc64``, ...):
an int64 holds the full 64-bit pattern of a u64, so constants such as
``pinv`` = -p^-1 mod 2^64 and Shoup companions floor(w·2^64/p) are stored
as their bit patterns and may read negative. That is exact as long as

- the high word of a 64×64 product is built from 32-bit halves
  (``mulhi64``, as the reference's u64 ``mulhi`` builds it); int64 ``*``
  and ``+`` wrap modulo 2^64 like the reference's u64 arithmetic;
- every ``>> 32`` is masked;
- only values known to lie below 2^63 are compared: residues, and the
  REDC and Shoup intermediates, which stay below 2p < 2^63.

Conventions match the reference bit for bit. Constants may be tensors
broadcastable against the data or Python ints inside the int64 range.
"""

from types import SimpleNamespace

import torch

MASK32 = (1 << 32) - 1
MASK16 = (1 << 16) - 1
_TWO64 = 1 << 64


def to_s64(v: int) -> int:
    """A word constant in [0, 2^64) as the int64 with the same bits."""
    v = int(v)
    return v - _TWO64 if v >= 1 << 63 else v


def mulhi(a, b):
    """High 32 bits of the 64-bit product a·b (a, b in [0, 2^32))."""
    return ((a * b) >> 32) & MASK32


def addmod(a, b, p):
    """(a + b) mod p for a, b in [0, p), p < 2^62."""
    s = a + b
    return torch.where(s >= p, s - p, s)


def submod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    d = a - b + p
    return torch.where(d >= p, d - p, d)


def negmod(a, p):
    """(-a) mod p for a in [0, p)."""
    return torch.where(a == 0, torch.zeros_like(a), p - a)


def redc(hi, lo, p, pinv):
    """Montgomery reduction (hi·2^32 + lo)·2^-32 mod p, result in [0, p).
    Requires hi·2^32 + lo < p·2^32; ``pinv`` = -p^-1 mod 2^32."""
    m = (lo * pinv) & MASK32
    t = hi + mulhi(m, p) + (lo != 0).long()
    return torch.where(t >= p, t - p, t)


def mont_mul(a, b, p, pinv):
    """a·b·2^-32 mod p (operands below 2^32, product below p·2^32)."""
    prod = a * b
    return redc((prod >> 32) & MASK32, prod & MASK32, p, pinv)


def mulmod(a, b, p, pinv, r2):
    """a·b mod p via two Montgomery reductions; ``r2`` = 2^64 mod p."""
    return mont_mul(mont_mul(a, b, p, pinv), r2, p, pinv)


def to_mont(a, p, pinv, r2):
    """a·2^32 mod p (enter the Montgomery domain)."""
    return mont_mul(a, r2, p, pinv)


def from_mont(a, p, pinv):
    """a·2^-32 mod p (leave the Montgomery domain)."""
    return redc(torch.zeros_like(a), a, p, pinv)


def modsum(x, p, dim: int):
    """Modular sum over ``dim`` of entries in [0, p).

    The reference folds with ``addmod`` (``modsum_tree``); modular addition
    is exactly associative, so the canonical result is the same. Here the
    int64 sum is exact (fewer than 2^32 terms below 2^31) and is reduced
    once; ``p`` broadcasts against the reduced shape.
    """
    return torch.remainder(x.sum(dim=dim), p)


def shoup_mul(a, w, w_shoup, p):
    """a·w mod p for a constant w with Shoup companion floor(w·2^32/p).
    Requires a < 2^32, w < p < 2^31: a·w - q·p is exact in int64 and lies
    in [0, 2p), the value the reference's wrapping u32 subtraction gives."""
    q = mulhi(a, w_shoup)
    r = a * w - q * p
    return torch.where(r >= p, r - p, r)


# ---------------------------------------------------------------------------
# the 64-bit word
# ---------------------------------------------------------------------------

def mulhi64(a, b):
    """High 64 bits of the 128-bit product of the u64 bit patterns a and b,
    from four 32×32 partial products (no carry is lost: each partial sum
    fits 64 bits)."""
    ah, al = (a >> 32) & MASK32, a & MASK32
    bh, bl = (b >> 32) & MASK32, b & MASK32
    t = al * bl
    mid1 = ah * bl + ((t >> 32) & MASK32)
    mid2 = al * bh + (mid1 & MASK32)
    return ah * bh + ((mid1 >> 32) & MASK32) + ((mid2 >> 32) & MASK32)


def redc64(hi, lo, p, pinv):
    """Montgomery reduction (hi·2^64 + lo)·2^-64 mod p, result in [0, p).
    Requires hi·2^64 + lo < p·2^64 and p < 2^62; ``pinv`` = -p^-1 mod 2^64."""
    m = lo * pinv
    t = hi + mulhi64(m, p) + (lo != 0).long()
    return torch.where(t >= p, t - p, t)


def mont_mul64(a, b, p, pinv):
    """a·b·2^-64 mod p (operands in [0, p))."""
    return redc64(mulhi64(a, b), a * b, p, pinv)


def mulmod64(a, b, p, pinv, r2):
    """a·b mod p via two Montgomery reductions; ``r2`` = 2^128 mod p."""
    return mont_mul64(mont_mul64(a, b, p, pinv), r2, p, pinv)


def to_mont64(a, p, pinv, r2):
    """a·2^64 mod p (enter the Montgomery domain)."""
    return mont_mul64(a, r2, p, pinv)


def from_mont64(a, p, pinv):
    """a·2^-64 mod p (leave the Montgomery domain)."""
    return redc64(torch.zeros_like(a), a, p, pinv)


def modsum64(x, p, dim: int):
    """Modular sum over ``dim`` of entries in [0, p), folded with ``addmod``
    in index order as the reference's ``modsum_tree`` folds short axes (an
    int64 sum of 61-bit terms would wrap); ``p`` broadcasts against the
    reduced shape."""
    acc = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        acc = addmod(acc, x.select(dim, k), p)
    return acc


def shoup_mul64(a, w, w_shoup, p):
    """a·w mod p for a constant w with Shoup companion floor(w·2^64/p).
    Requires a, w < p < 2^62: a·w - q·p wraps to its value in [0, 2p)."""
    q = mulhi64(a, w_shoup)
    r = a * w - q * p
    return torch.where(r >= p, r - p, r)


_SIGN64 = -(1 << 63)


def geu(a, b):
    """a >= b for the unsigned 64-bit words held in a and b (int64 bit
    patterns): a sum of several residues below 2^62, which may pass 2^63,
    compares right where a plain ``>=`` on int64 would not."""
    return (a ^ _SIGN64) >= (b ^ _SIGN64)


def fold_sum(acc, q, terms: int):
    """A sum of ``terms`` residues mod q (below terms·q, held as an unsigned
    64-bit word) brought below q: conditional subtractions of q·2^k, k from
    the top, then of q, as ``lattisense_tpu/parallel/keyswitch_sharded.py``
    folds the limb axis's psum_scatter; every compare is unsigned."""
    d = terms
    while d > 1:
        d //= 2
        step = q * d
        acc = torch.where(geu(acc, step), acc - step, acc)
    return torch.where(geu(acc, q), acc - q, acc)


W32 = SimpleNamespace(mulhi=mulhi, redc=redc, mont_mul=mont_mul, mulmod=mulmod,
                      to_mont=to_mont, from_mont=from_mont, shoup_mul=shoup_mul,
                      modsum=modsum, addmod=addmod, submod=submod, negmod=negmod)
W64 = SimpleNamespace(mulhi=mulhi64, redc=redc64, mont_mul=mont_mul64,
                      mulmod=mulmod64, to_mont=to_mont64, from_mont=from_mont64,
                      shoup_mul=shoup_mul64, modsum=modsum64, addmod=addmod, submod=submod,
                      negmod=negmod)


def word(bits: int) -> SimpleNamespace:
    """The arithmetic of the 32- or 64-bit word."""
    if bits == 32:
        return W32
    if bits == 64:
        return W64
    raise ValueError(f'word_bits must be 32 or 64, got {bits}')


def require_word(holder, bits: int, what: str):
    """Raise unless ``holder`` (a ring or constant holder) carries the
    ``bits``-bit word: a function of one word never computes on the other's
    constants."""
    got = getattr(holder, 'word_bits', None)
    if got != bits:
        raise ValueError(f'{what} takes the {bits}-bit word; it was handed a '
                         f'{type(holder).__name__} of word_bits={got}')
