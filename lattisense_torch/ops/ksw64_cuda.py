"""Kernel B7: the 64-bit-word gadget inner product of hybrid key switching.

Replaces ``lattisense_tpu/ops/ksw_pallas.py`` ``ksw_inner_fused`` (kernel
``_ksw_kernel``): for NTT-domain digits d (..., β, T, n) over Q_ℓ ∪ P and a
key-switching key in NTT + Montgomery form it returns

    acc[..., c, t, i] = Σ_β mont_mul(d[..., β, t, i], key[β, c, t, i]) mod q_t,

c ∈ {0, 1}, as one (..., 2, T, n) stack. The CUDA source is
``csrc/ksw64.cu``: a thread owns a limb and a pair of coefficients, holds
the key's β·2 values for both in registers and walks a chunk of ``CHUNK``
polynomials, reading each one's digits and writing its outputs in 16-byte
pairs; the chunks run fastest in the grid, so the blocks that share a key
slice run together and the key crosses device memory once a call. The key is
read in place from ``key_q`` / ``key_p`` by row index, so no per-call
``torch.cat`` of the level's key slice is needed. ``thread_map`` gives the
thread → (polynomial chunk, limb, coefficient pair) map in plain Python.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
twin ``ksw_inner64_plain`` (the reference's product and addmod fold on the
64-bit word functions). ``ksw_inner64`` counts one launch per call.
"""

import ctypes

import torch

from ..core import u64 as _u
from ..utils import observability
from . import cuda_build

#: launches since the last reset
launches = {'ksw_inner64': 0}
observability.register('ksw64_cuda', launches, launches=launches)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'ksw64_inner_launch': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    'ksw64_max_polys': [],
    'ksw64_chunk': [],
    'ksw64_threads': [],
    'ksw64_max_beta': [],
}
CHUNK = 4          # polynomials a thread walks (csrc/ksw64.cu kChunk)
THREADS = 128      # threads a block (kThreads), fewer where n / 2 is smaller


def thread_map(G: int, T: int, n: int):
    """The kernel's grid and work split as plain Python: the block shape and
    grid, and for every thread (chunk, coefficient block, limb, lane) the
    polynomials, limb and coefficients it computes — a list of
    ((g0, g1), t, i): polynomials g0 .. g1 - 1, limb t, coefficients i and
    i + 1 (threads with i >= n return at once and are left out)."""
    threads = min(THREADS, n // 2)
    grid = (-(-G // CHUNK), -(-(n // 2) // threads), T)
    work = []
    for bx in range(grid[0]):
        g0, g1 = bx * CHUNK, min(bx * CHUNK + CHUNK, G)
        for by in range(grid[1]):
            for t in range(T):
                for lane in range(threads):
                    i = 2 * (by * threads + lane)
                    if i < n:
                        work.append(((g0, g1), t, i))
    return threads, grid, work


def ksw_inner64_plain(digits_ntt, ksk, level: int, ring_qp):
    """The plain twin: Σ_β digit_β ⊙ key_β over Q_ℓ ∪ P → (..., 2, T, n)."""
    L = level + 1
    beta = digits_ntt.shape[-3]
    kd = torch.cat([ksk.key_q[:beta, :, :L], ksk.key_p[:beta]], dim=2)    # (β, 2, T, n)
    acc = None
    for d in range(beta):
        term = _u.mont_mul64(digits_ntt[..., d:d + 1, :, :], kd[d], ring_qp.q, ring_qp.pinv)
        acc = term if acc is None else _u.addmod(acc, term, ring_qp.q)
    return acc


def _check(digits_ntt, ksk, level: int, ring_qp):
    _u.require_word(ring_qp, 64, 'ksw_inner64')
    if not isinstance(digits_ntt, torch.Tensor) or digits_ntt.dtype != torch.int64:
        raise TypeError(f'expected an int64 tensor, got '
                        f'{getattr(digits_ntt, "dtype", type(digits_ntt))}')
    L, T, n = level + 1, len(ring_qp.moduli), ring_qp.n
    kq, kp = ksk.key_q, ksk.key_p
    alpha = T - L
    if digits_ntt.dim() < 3 or tuple(digits_ntt.shape[-2:]) != (T, n):
        raise ValueError(f'expected digits (..., beta, {T}, {n}), got {tuple(digits_ntt.shape)}')
    beta = digits_ntt.shape[-3]
    if (alpha < 1 or kq.dim() != 4 or kq.shape[0] < beta or kq.shape[1] != 2
            or kq.shape[2] < L or kq.shape[3] != n or tuple(kp.shape) != (kq.shape[0], 2, alpha, n)):
        raise ValueError(f'key shapes {tuple(kq.shape)}, {tuple(kp.shape)} do not fit '
                         f'beta={beta}, L={L}, alpha={alpha}, n={n}')
    for t in (kq, kp):
        if t.device != digits_ntt.device:
            raise ValueError(f'digits on {digits_ntt.device}, key on {t.device}')


def ksw_inner64(digits_ntt, ksk, level: int, ring_qp):
    """Gadget inner product of NTT-domain digits (..., β, T, n) with ``ksk``
    at ``level`` over the 64-bit-word ring ``ring_qp`` of Q_ℓ ∪ P →
    (..., 2, T, n)."""
    _check(digits_ntt, ksk, level, ring_qp)
    if not digits_ntt.is_cuda:
        return ksw_inner64_plain(digits_ntt, ksk, level, ring_qp)
    if not (ksk.key_q.is_contiguous() and ksk.key_p.is_contiguous()):
        raise ValueError('ksw_inner64 reads the key in place: key_q and key_p must be contiguous')
    lib = cuda_build.load('ksw64', _SIGNATURES)
    L, T, n = level + 1, len(ring_qp.moduli), ring_qp.n
    beta = digits_ntt.shape[-3]
    lead = digits_ntt.shape[:-3]
    G = digits_ntt.numel() // (beta * T * n)
    if G > lib.ksw64_max_polys():
        raise ValueError(f'ksw_inner64 takes at most {lib.ksw64_max_polys()} polynomials per '
                         f'call, got {G}')
    d = _aligned(digits_ntt.contiguous())
    kq, kp = _aligned(ksk.key_q), _aligned(ksk.key_p)
    out = torch.empty((*lead, 2, T, n), dtype=torch.int64, device=d.device)
    if G:
        with torch.cuda.device(d.device):
            err = lib.ksw64_inner_launch(d.data_ptr(), kq.data_ptr(), kp.data_ptr(),
                                         out.data_ptr(), G, L, kq.shape[2], T - L, beta, T, n,
                                         ring_qp.q.data_ptr(), ring_qp.pinv.data_ptr(),
                                         torch.cuda.current_stream(d.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'ksw64 inner product launch failed: cudaError_t {err}')
        launches['ksw_inner64'] += 1
    return out


def _aligned(x):
    """x, or a copy of it where it does not start on 16 bytes (the kernel
    moves coefficient pairs as 16-byte vectors)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()
