"""The BFV reference: decryption to the plaintext polynomial mod t, and the
plaintext results that the cells' operations must give.

A BFV ciphertext (2, L, n) holds coefficient-domain residues of (c0, c1)
over the first L primes of the chain; with the secret s its phase is
x = [c0 + c1·s]_Q and its plaintext m = round(t·x / Q) mod t. Plain PyTorch
and NumPy only.
"""

import numpy as np
import torch

from . import rns


def phase_limbs(ct, s, moduli):
    """ct (..., 2, L, n) coefficient domain, s (n,) small integers → the
    residues of c0 + c1·s, one (..., n) array a limb."""
    out = []
    for i, q in enumerate(moduli):
        q = int(q)
        c0 = rns.as_limb(ct[..., 0, i, :], q)
        c1 = rns.as_limb(ct[..., 1, i, :], q)
        s_q = rns.as_limb(torch.as_tensor(np.asarray(s) % q).to(
            c1.device if isinstance(c1, torch.Tensor) else 'cpu'), q)
        prod = rns.intt(rns.ntt(c1, q) * rns.ntt(s_q, q) % q, q)
        out.append((c0 + prod) % q)
    return out


def decrypt(ct, s, moduli, t: int) -> np.ndarray:
    """ct (..., 2, L, n) → the plaintext polynomials mod t, int64 (..., n)."""
    x, Q = rns.crt(phase_limbs(ct, s, moduli), moduli)
    return (((2 * t) * x + Q) // (2 * Q) % t).astype(np.int64)


def negacyclic_mul(a, b, t: int) -> np.ndarray:
    """a·b in Z_t[X]/(X^n + 1) for a prime t ≡ 1 (mod 2n), int64 (..., n)."""
    a = torch.as_tensor(np.asarray(a) % t, dtype=torch.int64)
    b = torch.as_tensor(np.asarray(b) % t, dtype=torch.int64)
    return rns.intt(rns.ntt(a, t) * rns.ntt(b, t) % t, t).numpy()


def automorphism(m, g: int, t: int) -> np.ndarray:
    """m(X^g) in Z_t[X]/(X^n + 1) for odd g: coefficient i moves to i·g mod
    2n, negated where that passes n."""
    m = np.asarray(m, dtype=np.int64)
    n = m.shape[-1]
    e = np.arange(n) * g % (2 * n)
    out = np.zeros_like(m)
    out[..., e % n] = np.where(e >= n, (t - m) % t, m)
    return out
