"""Kernel B5: the 64-bit-word negacyclic NTT and inverse NTT.

Replaces five Pallas entries of the JAX package that compute one function,
the u64 transforms of ``lattisense_tpu/core/ntt.py``:
``ops/ntt_pallas64f.py`` ``ntt_fused64`` / ``intt_fused64`` (B5),
``ops/ntt_pallas.py`` ``ntt_fused`` (B5-a), ``_intt_fused_impl`` (B5-b) and
``intt_fused`` / ``_intt_conj_impl`` (B5-c). The CUDA source is
``csrc/ntt64.cu`` on the body it shares with B1, ``csrc/ntt_passes.cuh``:
persistent blocks walk the (batch·limb) rows, each row held in registers
(16 residues a thread, 1024 threads at n=16384) through four register passes
of lazy 64-bit Shoup butterflies, exchanged whole through a 128 KB
shared-memory buffer, the row read and written in coalesced 8-byte pieces.
The schedule
and the pass tables are B1's (``ops/ntt_cuda.py`` ``schedule``,
``pass_tables``), built here from the 64-bit tables. ``ntt64_fwd`` /
``ntt64_inv`` are the entries; the reference's names are aliases of them.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
PyTorch twin, the radix-2 loops of ``lattisense_tpu/core/ntt.py`` on the
64-bit word functions (``ops/ntt_cuda.py`` ``ntt_plain``/``intt_plain``).
Outputs are canonical, so both are bit-exact with any correct NTT of the same
tables. Every launch is counted in ``launch``.
"""

import ctypes

import numpy as np
import torch

from ..core import u64 as _u
from . import cuda_build
from .ntt_cuda import check_stack, intt_plain, ntt_plain, pass_tables, run_aligned

#: launches of each direction since the last reset, counted in ``launch``
launches = {'ntt64_fwd': 0, 'ntt64_inv': 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'ntt64_fwd_launch': [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    'ntt64_inv_launch': [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    'ntt64_blocks_per_sm': [_I, _I],
}
MAX_LOGN = 14          # the exchange buffer 2^14 · 8 B = 128 KB


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def ntt64_plain(x, ring, to_mont: bool = False):
    """Forward NTT on the 64-bit word, natural → bit-reversed order,
    optionally followed by to-Montgomery (x·2^64 mod q)."""
    _u.require_word(ring, 64, 'ntt64_plain')
    return ntt_plain(x, ring, to_mont)


def intt64_plain(x, ring, from_mont: bool = False):
    """Inverse NTT on the 64-bit word, bit-reversed → natural order, scaled
    by n^-1, optionally after from-Montgomery (x·2^-64 mod q)."""
    _u.require_word(ring, 64, 'intt64_plain')
    if from_mont:
        x = _u.from_mont64(x, ring.q, ring.pinv)
    return intt_plain(x, ring)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def _tables(ring):
    """B5's pass tables, (L, entries, 2) int64 (value, Shoup companion) per
    direction, and its per-limb epilogue constants as int64 columns, cached
    on the ring: 2^64 mod q for to-Montgomery, and n^-1·2^-64 mod q for an
    inverse with the from-Montgomery folded in."""
    tabs = getattr(ring, '_b5_tables', None)
    if tabs is None:
        rs, dev = ring.rings, ring.device
        logn = ring.n.bit_length() - 1

        def col(vals):
            return torch.tensor([_u.to_s64(v) for v in vals], dtype=torch.int64, device=dev)

        def table(attr, inverse):
            stack = [np.stack([getattr(r, a) for r in rs]) for a in (attr, attr + '_shoup')]
            return torch.from_numpy(pass_tables(*stack, logn, inverse, 1)).to(dev)

        nir = [r.n_inv * pow(1 << 64, -1, r.q) % r.q for r in rs]
        tabs = {'fwd': table('psi_rev', False), 'inv': table('psi_inv_rev', True),
                'r1': col([r.r1 for r in rs]),
                'r1_shoup': col([(r.r1 << 64) // r.q for r in rs]),
                'n_inv_rinv': col(nir),
                'n_inv_rinv_shoup': col([(v << 64) // r.q for v, r in zip(nir, rs)])}
        ring._b5_tables = tabs
    return tabs


def launch(x, y, ring, inverse: bool, to_mont: bool = False, from_mont: bool = False):
    """Launch B5 on contiguous CUDA int64 stacks x → y (same shape) on the
    current stream, and count the launch under its direction's name.

    ``to_mont`` (forward) multiplies the output by 2^64 mod q; ``from_mont``
    (inverse) folds a from-Montgomery of the input into the n^-1 scale (the
    transform is linear: INTT(x·2^-64) = 2^-64·INTT(x))."""
    _u.require_word(ring, 64, 'B5 (ntt64)')
    if not (x.is_cuda and y.is_cuda and x.is_contiguous() and y.is_contiguous()):
        raise ValueError('B5 takes contiguous CUDA tensors')
    if y.shape != x.shape or y.dtype != torch.int64:
        raise ValueError(f'output {tuple(y.shape)} {y.dtype} does not match input {tuple(x.shape)}')
    if (to_mont and inverse) or (from_mont and not inverse):
        raise ValueError('to_mont is a forward epilogue, from_mont an inverse one')
    logn = ring.n.bit_length() - 1
    if not 1 <= logn <= MAX_LOGN:
        raise ValueError(f'B5 supports 2 <= n <= 2^{MAX_LOGN} (a row of 64-bit words in shared '
                         f'memory), got n={ring.n}')
    rows = x.numel() // ring.n
    if rows == 0:
        return
    lib = cuda_build.load('ntt64', _SIGNATURES)
    tabs = _tables(ring)
    if inverse:
        fn = lib.ntt64_inv_launch
        post, postsh = ((tabs['n_inv_rinv'], tabs['n_inv_rinv_shoup']) if from_mont
                        else (ring.n_inv, ring.n_inv_shoup))
    else:
        fn = lib.ntt64_fwd_launch
        post, postsh = (tabs['r1'], tabs['r1_shoup']) if to_mont else (None, None)
    run_aligned(fn, x, y, rows, len(ring.moduli), logn, tabs['inv' if inverse else 'fwd'],
                ring.q, post, postsh, f'ntt64 {"inverse" if inverse else "forward"}')
    launches['ntt64_inv' if inverse else 'ntt64_fwd'] += 1


def blocks_per_sm(logn: int, inverse: bool) -> int:
    """Blocks of B5's kernel at n = 2^logn that one SM of the current card
    holds, from the occupancy calculator (registers, shared memory, threads)."""
    got = cuda_build.load('ntt64', _SIGNATURES).ntt64_blocks_per_sm(logn, int(inverse))
    if got < 0:
        raise RuntimeError(f'ntt64 occupancy query failed: cudaError_t {-got}')
    return got


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def ntt64_fwd(x, ring, to_mont: bool = False):
    """Forward NTT of an int64 (..., L, n) stack over a 64-bit-word ``ring``
    (bit-reversed output), with the optional to-Montgomery epilogue."""
    _u.require_word(ring, 64, 'ntt64_fwd')
    check_stack(x, ring)
    if not x.is_cuda:
        return ntt64_plain(x, ring, to_mont)
    y = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    launch(x.contiguous(), y, ring, inverse=False, to_mont=to_mont)
    return y


def ntt64_inv(x, ring, from_mont: bool = False):
    """Inverse NTT of an int64 (..., L, n) stack over a 64-bit-word ``ring``
    (bit-reversed input, natural output, scaled by n^-1), with the optional
    from-Montgomery folded in."""
    _u.require_word(ring, 64, 'ntt64_inv')
    check_stack(x, ring)
    if not x.is_cuda:
        return intt64_plain(x, ring, from_mont)
    y = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    launch(x.contiguous(), y, ring, inverse=True, from_mont=from_mont)
    return y


# The JAX package's names for the same two functions.

def ntt_fused64(x, ring):
    """``lattisense_tpu/ops/ntt_pallas64f.py`` ``ntt_fused64``: ``ntt64_fwd``."""
    return ntt64_fwd(x, ring)


def intt_fused64(x, ring):
    """``lattisense_tpu/ops/ntt_pallas64f.py`` ``intt_fused64``: ``ntt64_inv``."""
    return ntt64_inv(x, ring)


def ntt_fused(x, ring):
    """``lattisense_tpu/ops/ntt_pallas.py`` ``ntt_fused``: ``ntt64_fwd``."""
    return ntt64_fwd(x, ring)


def intt_fused(x, ring):
    """``lattisense_tpu/ops/ntt_pallas.py`` ``intt_fused`` (the
    bit-reversal-conjugated inverse): ``ntt64_inv``."""
    return ntt64_inv(x, ring)


def intt_fused_impl(x, ring):
    """``lattisense_tpu/ops/ntt_pallas.py`` ``_intt_fused_impl`` (the
    Gentleman–Sande inverse): ``ntt64_inv``."""
    return ntt64_inv(x, ring)
