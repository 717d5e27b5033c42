"""Negacyclic NTT / INTT over RNS limb stacks (int64 (..., L, n), one prime
per limb). "NTT domain" means bit-reversed evaluation order, as in
``lattisense_tpu/core/ntt.py``.

The ring's word picks the kernel: B1 (``ops/ntt_cuda.py``) for the 32-bit
word, B5 (``ops/ntt64_cuda.py``) for the 64-bit word. A CUDA tensor launches
the hand-written kernel, a CPU tensor runs its plain PyTorch twin there.
``ntt_plain`` / ``intt_plain`` are the twins themselves, on any device.
"""

from ..ops.ntt64_cuda import ntt64_fwd, ntt64_inv
from ..ops.ntt_cuda import intt_plain, ntt_plain, ntt32_fwd, ntt32_inv


def ntt(x, ring):
    """Forward NTT. x: int64 (..., L, n) in [0, q). Output bit-reversed."""
    if ring.word_bits == 64:
        return ntt64_fwd(x, ring)
    return ntt32_fwd(x, ring)


def intt(x, ring):
    """Inverse NTT. Input bit-reversed, output natural, scaled by n^-1."""
    if ring.word_bits == 64:
        return ntt64_inv(x, ring)
    return ntt32_inv(x, ring)


__all__ = ['ntt', 'intt', 'ntt_plain', 'intt_plain']
