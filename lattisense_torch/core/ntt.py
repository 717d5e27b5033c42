"""Negacyclic NTT / INTT over RNS limb stacks (int64 (..., L, n), one prime
per limb). "NTT domain" means bit-reversed evaluation order, as in
``lattisense_tpu/core/ntt.py``.

The transforms are kernel B1 (``ops/ntt_cuda.py``): a CUDA tensor launches
the hand-written kernel, a CPU tensor runs its plain PyTorch twin there.
"""

from ..ops.ntt_cuda import intt_plain, ntt_plain, ntt32_fwd, ntt32_inv


def ntt(x, ring):
    """Forward NTT. x: int64 (..., L, n) in [0, q). Output bit-reversed."""
    return ntt32_fwd(x, ring)


def intt(x, ring):
    """Inverse NTT. Input bit-reversed, output natural, scaled by n^-1."""
    return ntt32_inv(x, ring)


__all__ = ['ntt', 'intt', 'ntt_plain', 'intt_plain']
