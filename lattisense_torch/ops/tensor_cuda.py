"""Kernel B8: the NTT-domain tensor product of two ciphertexts, both words.

For a = (a0, a1) and b = (b0, b1), each (..., 2, L, n) in the NTT domain
over a ring of either word, it returns

    (d0, d1, d2) = (a0·b0, a0·b1 + a1·b0, a1·b1) · R^-1 mod q_t

stacked on dim -3 (R = 2^32 or 2^64 by the ring's ``word_bits``); with
``a_to_mont`` a first enters the Montgomery domain (a·r2·R^-1 = a·R), as a
CKKS ciphertext must. It replaces no Pallas kernel: the JAX package's
``BfvEngine.mult`` and ``CkksEngine.mult`` leave the product to XLA, which
fuses it; the plain PyTorch composition (``tensor_product_plain``) makes
each step a separate pass over whole operands, the 64-bit products from
32-bit halves.

The CUDA source is ``csrc/tensor.cu``, one kernel templated on the word: a
thread owns a limb and a pair of coefficients, reads each input residue once
and writes each output once, in 16-byte pairs, with every intermediate in
registers. ``a`` and ``b`` are read in place through their own polynomial
and component strides, so BFV's ``f[..., :2, :, :]`` / ``f[..., 2:, :, :]``
halves of one stack and CKKS's two ciphertexts are neither concatenated nor
copied. ``thread_map`` gives the thread → (polynomial, limb, coefficient
pair) map in plain Python.

The product is pointwise per (limb, coefficient), so it takes L and n from
the operands' last two dimensions: a coefficient-sharded ring view (whose
``n`` is the full degree) hands it its shard of C coefficients, and a view
that holds no limb at a level (L = 0) gets an empty product without a
launch. A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain twin. ``launches`` counts one launch a call under its word
(``tensor32``, ``tensor64``).
"""

import ctypes
import math

import torch

from ..core import u64 as _u
from ..utils import observability
from . import cuda_build

#: launches since the last reset
launches = {'tensor32': 0, 'tensor64': 0}
observability.register('tensor_cuda', launches, launches=launches)

_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_longlong
_SIGNATURES = {
    'tensor_launch': [_P, _P, _P, _S, _S, _S, _S, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P],
}
# The launch geometry, which the wrapper hands to the kernel: threads a block
# (at most csrc/tensor.cu's kMaxThreads, fewer where n / 2 is smaller), and
# polynomials in the grid's third dimension (CUDA's limit; a loop walks the rest)
THREADS = 256
MAX_GRID_Z = 65535


def geometry(G: int, L: int, n: int):
    """The block's threads and the grid (coefficient blocks, limbs,
    polynomials) of one launch over G polynomial pairs of L limbs of n."""
    threads = min(THREADS, n // 2)
    return threads, (-(-(n // 2) // threads), L, min(G, MAX_GRID_Z))


def thread_map(G: int, L: int, n: int):
    """The kernel's grid and work split as plain Python: the block shape and
    grid, and for every thread (coefficient block, limb, polynomial slot,
    lane) the (polynomial, limb, coefficient) it computes, coefficients i and
    i + 1 (threads with i >= n return at once and are left out)."""
    threads, grid = geometry(G, L, n)
    work = []
    for bx in range(grid[0]):
        for t in range(L):
            for bz in range(grid[2]):
                for lane in range(threads):
                    i = 2 * (bx * threads + lane)
                    if i < n:
                        work += [(g, t, i) for g in range(bz, G, grid[2])]
    return threads, grid, work


def tensor_product_plain(a, b, ring, a_to_mont: bool = False):
    """The plain twin: the word's Montgomery products and modular add."""
    q, pinv, w = ring.q, ring.pinv, ring.word
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    b0, b1 = b[..., 0, :, :], b[..., 1, :, :]
    if a_to_mont:
        a0, a1 = w.to_mont(a0, q, pinv, ring.r2), w.to_mont(a1, q, pinv, ring.r2)
    d1 = _u.addmod(w.mont_mul(a0, b1, q, pinv), w.mont_mul(a1, b0, q, pinv), q)
    return torch.stack([w.mont_mul(a0, b0, q, pinv), d1, w.mont_mul(a1, b1, q, pinv)], dim=-3)


def _check(a, b, ring):
    bits = getattr(ring, 'word_bits', None)
    if bits not in (32, 64):
        raise ValueError(f'tensor_product takes the 32- or 64-bit word; it was handed a '
                         f'{type(ring).__name__} of word_bits={bits}')
    for x in (a, b):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
            raise TypeError(f'expected int64 tensors, got {getattr(x, "dtype", type(x))}')
    L = len(ring.moduli)
    if a.dim() < 3 or tuple(a.shape[-3:-1]) != (2, L) or a.shape != b.shape:
        raise ValueError(f'expected a and b of one shape (..., 2, {L}, n), got '
                         f'{tuple(a.shape)} and {tuple(b.shape)}')
    if b.device != a.device or ring.q.device != a.device:
        raise ValueError(f'a on {a.device}, b on {b.device}, the ring on {ring.q.device}')


def tensor_product_cuda(a, b, ring, a_to_mont: bool = False):
    """The tensor product of ciphertext pairs a, b (..., 2, L, n) over the L
    limbs of ``ring`` → (..., 3, L, n), n whole or a shard of coefficients;
    ``a_to_mont`` brings a into Montgomery form first."""
    _check(a, b, ring)
    if not a.is_cuda:
        return tensor_product_plain(a, b, ring, a_to_mont)
    lib = cuda_build.load('tensor', _SIGNATURES)
    lead, (L, n) = a.shape[:-3], a.shape[-2:]
    G = math.prod(lead)
    out = torch.empty((*lead, 3, L, n), dtype=torch.int64, device=a.device)
    if out.numel():
        av, bv = _aligned(a, G), _aligned(b, G)
        q, pinv, r2 = (c.reshape(-1) for c in (ring.q, ring.pinv, ring.r2))
        threads, grid = geometry(G, L, n)
        with torch.cuda.device(a.device):
            err = lib.tensor_launch(av.data_ptr(), bv.data_ptr(), out.data_ptr(), av.stride(0),
                                    av.stride(1), bv.stride(0), bv.stride(1), G, L, n,
                                    ring.word_bits, int(a_to_mont), q.data_ptr(),
                                    pinv.data_ptr(), r2.data_ptr(), threads, grid[2],
                                    torch.cuda.current_stream(a.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'tensor product launch failed: cudaError_t {err}')
        launches[f'tensor{ring.word_bits}'] += 1
    return out


def _aligned(x, G: int):
    """x as (G, 2, L, n): a view where its rows of n residues are contiguous,
    it starts on 16 bytes and its other strides are even (the kernel moves
    coefficient pairs as 16-byte vectors), else a contiguous copy."""
    v = x.reshape(G, *x.shape[-3:])
    if (v.stride(3) == 1 and v.stride(2) == v.shape[3] and v.stride(1) % 2 == 0
            and v.stride(0) % 2 == 0 and v.data_ptr() % 16 == 0):
        return v
    return v.clone(memory_format=torch.contiguous_format)
