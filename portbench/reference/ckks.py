"""The CKKS reference: decryption and decoding of NTT-domain ciphertexts.

A CKKS ciphertext (2, L, n) holds (c0, c1) in the NTT domain (``rns``'s
layout) over the first L primes; its phase c0 + c1·s, centred in
(-Q/2, Q/2] and divided by the scale Δ, is the real polynomial m whose
slots are m(ζ^(5^j mod 2n)), ζ = e^(iπ/n), j < slots (the canonical
embedding in the rotation group's order, as the reference SDK and Lattigo
lay the slots out). Plain PyTorch and NumPy only.
"""

import functools

import numpy as np
import torch

from . import rns


@functools.lru_cache(maxsize=64)
def _s_hat(q: int, s_bytes: bytes):
    """The NTT of the secret over q, kept for the next ciphertext."""
    return rns.ntt(rns.as_limb(np.frombuffer(s_bytes, dtype=np.int64) % q, q), q)


def phase(ct, s, moduli) -> np.ndarray:
    """ct (..., 2, L, n) NTT domain, s (n,) small integers → the centred
    phase as float64 (..., n)."""
    s_bytes = np.ascontiguousarray(s, dtype=np.int64).tobytes()
    limbs = []
    for i, q in enumerate(moduli):
        q = int(q)
        c0 = rns.as_limb(ct[..., 0, i, :], q)
        c1 = rns.as_limb(ct[..., 1, i, :], q)
        s_hat = _s_hat(q, s_bytes)
        if isinstance(c1, torch.Tensor):
            s_hat = s_hat.to(c1.device)
        limbs.append(rns.intt((c0 + rns.mulmod(c1, s_hat, q)) % q, q))
    return rns.centered_float(limbs, moduli)


@functools.lru_cache(maxsize=8)
def _slot_positions(n: int, slots: int) -> np.ndarray:
    """Slot j's evaluation in ``decode``'s order: (5^j mod 2n - 1) / 2."""
    e = np.empty(slots, dtype=np.int64)
    cur = 1
    for j in range(slots):
        e[j] = cur
        cur = cur * 5 % (2 * n)
    return (e - 1) // 2


def decode(coeffs, scale: float, slots: int) -> np.ndarray:
    """Real coefficients (..., n), Δ·m → the complex slots (..., slots)."""
    m = np.asarray(coeffs, dtype=np.float64) / scale
    n = m.shape[-1]
    # evals[k] = m(ζ^(2k+1)) = Σ_j m_j ζ^j e^(2πi jk/n)
    evals = n * np.fft.ifft(m * np.exp(1j * np.pi * np.arange(n) / n), axis=-1)
    return evals[..., _slot_positions(n, slots)]


def decrypt_decode(ct, s, moduli, scale: float, slots: int) -> np.ndarray:
    """ct (..., 2, L, n) → its slots (..., slots)."""
    return decode(phase(ct, s, moduli), scale, slots)
