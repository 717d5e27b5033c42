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

A 64-bit row of 2^15 or 2^16 (256 or 512 KB) does not fit a block: n = 2^15
and 2^16 take the cluster kernel (``csrc/ntt_cluster.cuh``), one launch
for the phase split of B5-a/b/c: a thread-block cluster of 2^k blocks holds
a row in sub-rows of 2^``SUB_LOGN``, trades the k = log2 n - ``SUB_LOGN``
stages that span sub-rows through distributed shared memory and runs the row
body on each sub-row, each (limb, sub-row) a virtual limb with B1's split
tables (``ops/ntt_cuda.py`` ``split_pass_tables``, ``column_tables``). Its
launches count under ``ntt64_fwd_cluster`` / ``ntt64_inv_cluster``, the row
kernel's under ``ntt64_fwd`` / ``ntt64_inv``.

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
from .ntt_cuda import (SUB_LOGN, check_stack, column_tables, intt_plain, ntt_plain,
                       run_aligned, split_pass_tables)

#: launches of each kernel and direction since the last reset, counted in
#: ``launch``: the row kernel (n <= 2^14) and the cluster kernel (2^15, 2^16)
launches = {'ntt64_fwd': 0, 'ntt64_inv': 0, 'ntt64_fwd_cluster': 0, 'ntt64_inv_cluster': 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'ntt64_fwd_launch': [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    'ntt64_inv_launch': [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    'ntt64_blocks_per_sm': [_I, _I],
    'ntt64_cluster_launch': [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    'ntt64_cluster_fit': [_I, _I, _I],
}
ROW_MAX_LOGN = 14      # the row kernel's exchange buffer 2^14 · 8 B = 128 KB
# SUB_LOGN, B1's: every cluster kernel's sub-rows, here 2^13 · 8 B = 64 KB a block
MAX_LOGN = 16          # the cluster kernel: clusters of up to 2^(16 - SUB_LOGN) blocks


def cluster_depth(logn: int) -> int:
    """k: the stages the cluster kernel trades between the blocks of a
    cluster at n = 2^logn (clusters of 2^k blocks over sub-rows of
    2^SUB_LOGN); 0 where the row kernel holds a whole row."""
    return 0 if logn <= ROW_MAX_LOGN else logn - SUB_LOGN


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
    """B5's pass tables, (rows, entries, 2) int64 (value, Shoup companion)
    per direction, and its per-row constants as int64 columns, cached on
    the ring: q, n^-1, 2^64 mod q for to-Montgomery, and n^-1·2^-64 mod q for
    an inverse with the from-Montgomery folded in. Rows are the limbs, or
    above the row kernel's cap the cluster kernel's virtual limbs (each
    limb's constants repeated 2^k times; n^-1 is the full n's), with the
    cross stages' column tables and the limbs' primes (``cols_*``)."""
    tabs = getattr(ring, '_b5_tables', None)
    if tabs is None:
        rs, dev = ring.rings, ring.device
        logn = ring.n.bit_length() - 1
        k = cluster_depth(logn)

        def per_row(vals):
            return torch.tensor([_u.to_s64(v) for v in vals for _ in range(1 << k)],
                                dtype=torch.int64, device=dev)

        def stacked(attr):
            return [np.stack([getattr(r, a) for r in rs]) for a in (attr, attr + '_shoup')]

        def table(attr, inverse):
            return torch.from_numpy(split_pass_tables(*stacked(attr), logn, k, inverse, 1)).to(dev)

        nir = [r.n_inv * pow(1 << 64, -1, r.q) % r.q for r in rs]
        tabs = {'fwd': table('psi_rev', False), 'inv': table('psi_inv_rev', True),
                'q': per_row([r.q for r in rs]),
                'n_inv': per_row([r.n_inv for r in rs]),
                'n_inv_shoup': per_row([(r.n_inv << 64) // r.q for r in rs]),
                'r1': per_row([r.r1 for r in rs]),
                'r1_shoup': per_row([(r.r1 << 64) // r.q for r in rs]),
                'n_inv_rinv': per_row(nir),
                'n_inv_rinv_shoup': per_row([(v << 64) // r.q for v, r in zip(nir, rs)])}
        if k:
            tabs.update({
                'cols_q': ring.q.reshape(-1).contiguous(),
                'cols_fwd': torch.from_numpy(column_tables(*stacked('psi_rev'), k)).to(dev),
                'cols_inv': torch.from_numpy(column_tables(*stacked('psi_inv_rev'), k)).to(dev)})
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
        raise ValueError(f'B5 supports 2 <= n <= 2^{MAX_LOGN}, got n={ring.n}')
    rows = x.numel() // ring.n
    if rows == 0:
        return
    lib = cuda_build.load('ntt64', _SIGNATURES)
    tabs = _tables(ring)
    if inverse:
        fn = lib.ntt64_inv_launch
        post, postsh = ((tabs['n_inv_rinv'], tabs['n_inv_rinv_shoup']) if from_mont
                        else (tabs['n_inv'], tabs['n_inv_shoup']))
    else:
        fn = lib.ntt64_fwd_launch
        post, postsh = (tabs['r1'], tabs['r1_shoup']) if to_mont else (None, None)
    what = f'ntt64 {"inverse" if inverse else "forward"}'
    k = cluster_depth(logn)
    if k:
        with torch.cuda.device(x.device):
            err = lib.ntt64_cluster_launch(
                x.data_ptr(), y.data_ptr(), rows, len(ring.moduli), logn, logn - k, int(inverse),
                tabs['inv' if inverse else 'fwd'].data_ptr(),
                tabs['cols_inv' if inverse else 'cols_fwd'].data_ptr(), tabs['cols_q'].data_ptr(),
                None if post is None else post.data_ptr(),
                None if postsh is None else postsh.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'{what} cluster launch failed: cudaError_t {err}')
        launches['ntt64_inv_cluster' if inverse else 'ntt64_fwd_cluster'] += 1
    else:
        run_aligned(fn, x, y, rows, len(ring.moduli), logn, tabs['inv' if inverse else 'fwd'],
                    tabs['q'], post, postsh, what)
        launches['ntt64_inv' if inverse else 'ntt64_fwd'] += 1


def blocks_per_sm(logn: int, inverse: bool) -> int:
    """Blocks of B5's kernel at n = 2^logn that one SM of the current card
    holds, from the occupancy calculator (registers, shared memory, threads)."""
    got = cuda_build.load('ntt64', _SIGNATURES).ntt64_blocks_per_sm(logn, int(inverse))
    if got < 0:
        raise RuntimeError(f'ntt64 occupancy query failed: cudaError_t {-got}')
    return got


def cluster_fit(logn: int, inverse: bool) -> int:
    """Clusters of the cluster kernel at n = 2^logn (2^15 or 2^16) that the
    current card runs at once, from ``cudaOccupancyMaxActiveClusters``;
    raises where none fits."""
    got = cuda_build.load('ntt64', _SIGNATURES).ntt64_cluster_fit(
        logn, logn - cluster_depth(logn), int(inverse))
    if got <= 0:
        raise RuntimeError(f'ntt64 cluster occupancy query failed: cudaError_t {-got}')
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
