"""Exact 32-bit word modular arithmetic on int64 tensors.

The reference (``lattisense_tpu/core/u64.py``, word_bits=32) computes on u32
arrays with wrapping multiplies. PyTorch implements only ``*`` and ``&`` for
its unsigned types, so residues travel here as ``torch.int64`` holding values
in ``[0, 2^32)``; masks replace the unsigned wrap:

- the product of two values below 2^32 is below 2^64: int64 ``*`` wraps it
  modulo 2^64, so its low word is ``prod & MASK32`` and its high word
  ``(prod >> 32) & MASK32`` (``>>`` is arithmetic, hence the mask);
- products of two residues below 2^31 are below 2^62 and need no mask.

Conventions match the reference bit for bit: Montgomery R = 2^32,
``pinv`` = -p^-1 mod 2^32, Shoup companions floor(w·2^32/p). Constants may be
tensors broadcastable against the data or Python ints.
"""

import torch

MASK32 = (1 << 32) - 1
MASK16 = (1 << 16) - 1


def mulhi(a, b):
    """High 32 bits of the 64-bit product a·b (a, b in [0, 2^32))."""
    return ((a * b) >> 32) & MASK32


def addmod(a, b, p):
    """(a + b) mod p for a, b in [0, p)."""
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
