"""Negacyclic NTT / INTT over RNS limb stacks (int64 (..., L, n), one prime
per limb). "NTT domain" means bit-reversed evaluation order, as in
``lattisense_tpu/core/ntt.py``.

The ring's word picks the kernel: B1 (``ops/ntt_cuda.py``) for the 32-bit
word, B5 (``ops/ntt64_cuda.py``) for the 64-bit word. A CUDA tensor launches
the hand-written kernel, a CPU tensor runs its plain PyTorch twin there.
``ntt_plain`` / ``intt_plain`` are the twins themselves, on any device.

With ``ops/ntt_mxu.py``'s gate on (``LATTISENSE_MXU_NTT``, ``ntt_mxu.ENABLED``)
the 64-bit word's transforms at n >= 4096 are its four-step matrix products
instead, on either device, as ``lattisense_tpu/core/ntt.py`` dispatches; the
Montgomery entry and exit that B5 folds into its epilogues are then separate
elementwise products.

A sharded ring view (``parallel/sharded_engine.py``) carries ``dist``, the
transform of this rank's shard: the distributed four-step NTT over the
mesh's coefficient axis, or the NTT of this rank's own limbs. Its Montgomery
entry and exit are separate elementwise products on either word, as in the
JAX package's unfused path.
"""

from ..ops import ntt_mxu
from ..ops.ntt64_cuda import ntt64_fwd, ntt64_inv
from ..ops.ntt_cuda import intt_plain, ntt_plain, ntt32_fwd, ntt32_inv


def ntt(x, ring, to_mont: bool = False):
    """Forward NTT. x: int64 (..., L, n) in [0, q). Output bit-reversed, and
    with ``to_mont`` multiplied by the word's R (Montgomery form)."""
    dist = getattr(ring, 'dist', None)
    if dist is not None:
        y = dist.fwd_body(x)
        return ring.word.to_mont(y, ring.q, ring.pinv, ring.r2) if to_mont else y
    if ntt_mxu.enabled(ring.n, ring.word_bits):
        y = ntt_mxu.ntt(x, ring)
        return ring.word.to_mont(y, ring.q, ring.pinv, ring.r2) if to_mont else y
    if ring.word_bits == 64:
        return ntt64_fwd(x, ring, to_mont)
    return ntt32_fwd(x, ring, to_mont)


def intt(x, ring, from_mont: bool = False):
    """Inverse NTT. Input bit-reversed, output natural, scaled by n^-1, and
    with ``from_mont`` (64-bit word, or a sharded ring view) divided by R."""
    dist = getattr(ring, 'dist', None)
    if dist is not None:
        if from_mont:
            x = ring.word.from_mont(x, ring.q, ring.pinv)
        return dist.inv_body(x)
    if ntt_mxu.enabled(ring.n, ring.word_bits):
        y = ntt_mxu.intt(x, ring)
        return ring.word.from_mont(y, ring.q, ring.pinv) if from_mont else y
    if ring.word_bits == 64:
        return ntt64_inv(x, ring, from_mont)
    if from_mont:
        raise ValueError('B1 has no from-Montgomery epilogue; the 32-bit word strips R in B4')
    return ntt32_inv(x, ring)


__all__ = ['ntt', 'intt', 'ntt_plain', 'intt_plain']
