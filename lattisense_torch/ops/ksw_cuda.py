"""Kernel B3: the whole hybrid key switch for the 32-bit-word engine.

Replaces ``lattisense_tpu/ops/ksw_pallas32.py`` ``ksw_switch32`` (kernel
``_ksw_kernel``, launch ``_ksw_impl``). For a coefficient-domain int64
(..., L, n) stack x over Q_ℓ it returns (e0, e1), each (..., L, n),
bit-identical to ``KeySwitcher.switch_plain``: digit decomposition,
per-digit FastBConv mod-up to Q_ℓ∪P, forward NTT, gadget inner product with
the Montgomery-form key, inverse NTT of both components, ``RoundDivP``
mod-down, and with ``output_ntt`` a forward NTT of the result.

The TPU kernel keeps one ciphertext's ~48 rows (~3 MB at n=16384) in VMEM.
The gadget inner product is local to a row, so the fused route
(``csrc/ksw32.cu``) runs one block per (ciphertext, row t): the mod-up of
each digit's row t from x, its forward NTT, the product with the key read
in place and both components' inverse NTTs stay in the block's registers
and shared memory, and only the coefficient-domain product leaves, as 32-bit
residues; one per-coefficient kernel then runs the mod-down, the only step
across rows. n = 2^15 and 2^16 (``switch_route``), whose three 32-bit rows
do not fit a block, take the cluster route: the same row spread over a
thread-block cluster of 2^k blocks, each owning a sub-row of
2^``ntt_cuda.SUB_LOGN`` of the digit row and of both accumulators, the k NTT
stages that span sub-rows traded through distributed shared memory (the
cross stages of kernel B1's cluster kernel, ``csrc/ntt_cluster.cuh``, with
its virtual-limb tables ``ntt_cuda.cluster_tables`` at
``ntt_cuda.cluster_depth``), into the same mod-down. Bound, as
the fused route, by its 32-bit operations; neither route moves a digit
stack through device memory. With ``output_ntt`` either route ends in a B1
forward over the result.

``ksw_switch32`` counts one launch per call, for the whole sequence (the
output NTT's under ``ntt_cuda.launches``: ``ntt32_fwd``, and above 2^14
also ``ntt32_fwd_cluster``). Both routes index polynomials in 64 bits (at
n = 2^16 with 52 rows and 12 digits a ciphertext's key rows alone hold
4·10^7 residues). A CUDA tensor launches the kernels or raises; a CPU
tensor runs the plain twin. ``tests/test_torch_fused_rows.py`` walks both
routes on the CPU.
"""

import ctypes
import math

import torch

from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..core.rns import _shoup
from ..utils import observability
from . import cuda_build, ntt_cuda

#: launches of the wrapper's kernel sequence since the last reset
launches = {'ksw_switch32': 0}
observability.register('ksw_cuda', launches, launches=launches)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'ksw32_moddown32_launch': [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    'ksw32_rows_launch': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                          _P],
    'ksw32_cluster_launch': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P],
    'ksw32_rows_blocks_per_sm': [_I],
    'ksw32_cluster_fit': [_I, _I],
    'ksw32_max_alpha': [],
}
_MAX_GRID_YZ = 65535
FUSED_MAX_LOGN = 14    # three 32-bit rows of 2^15 (384 KB) do not fit a block
MAX_LOGN = ntt_cuda.MAX_LOGN   # the cluster route: B1's cluster depths, B1's sub-rows


def switch_route(n: int) -> str:
    """The route B3 takes at n, chosen by shape: 'fused' (one block per
    ciphertext and row, three 32-bit rows of shared memory) up to
    n = 2^14, 'cluster' (one thread-block cluster per ciphertext and row)
    above."""
    return 'fused' if n.bit_length() - 1 <= FUSED_MAX_LOGN else 'cluster'


def _consts(sw, level: int):
    """The kernels' uint32 constant blocks for one level (layouts in
    ksw32.cu: the rows kernels' ``modup`` and ``inner``, the mod-down's),
    cached on the KeySwitcher."""
    cache = sw.__dict__.setdefault('_b3_consts', {})
    if level in cache:
        return cache[level]
    observability.table_built('ksw_cuda._consts')
    L = level + 1
    alpha, beta = sw.alpha, sw.beta(level)
    q = list(sw.q_moduli[:L])
    p = list(sw.p_moduli)
    qp = q + p
    T = len(qp)
    ring_qp = get_rns_ring(qp, sw.n, sw.device)
    src, hinv, hinvs = [1] * (beta * alpha), [0] * (beta * alpha), [0] * (beta * alpha)
    mv, ms = [0] * (beta * alpha * T), [0] * (beta * alpha * T)
    for d in range(beta):
        grp = q[d * alpha:(d + 1) * alpha]
        Qd = math.prod(grp)
        for j, qj in enumerate(grp):
            r = d * alpha + j
            h = Qd // qj
            src[r], hinv[r] = qj, pow(h, -1, qj)
            hinvs[r] = _shoup(hinv[r], qj)
            for t, dt in enumerate(qp):
                mv[r * T + t], ms[r * T + t] = h % dt, _shoup(h % dt, dt)
    P = math.prod(p)
    half = P // 2
    pinv = [pow(P % qi, -1, qi) for qi in q]
    phat_inv = [pow(P // pj, -1, pj) for pj in p]
    cv = [(P // pj) % qi for pj in p for qi in q]
    cs = [_shoup((P // pj) % qi, qi) for pj in p for qi in q]
    dev = sw.device
    tabs = {
        'modup': ntt_cuda.u32_tensor(src + hinv + hinvs + qp + mv + ms, dev),
        'inner': ntt_cuda.u32_tensor(qp + [r.pinv for r in ring_qp.rings], dev),
        'moddown': ntt_cuda.u32_tensor(
            q + [half % qi for qi in q] + pinv + [_shoup(v, qi) for v, qi in zip(pinv, q)]
            + p + [half % pj for pj in p] + phat_inv
            + [_shoup(v, pj) for v, pj in zip(phat_inv, p)] + [(1 << 62) // pj for pj in p]
            + cv + cs, dev),
    }
    cache[level] = tabs
    return tabs


def _check(x, ksk, sw, level: int):
    _u.require_word(sw, 32, 'ksw_switch32')
    L = level + 1
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
        raise TypeError(f'expected an int64 tensor, got {getattr(x, "dtype", type(x))}')
    if not 0 <= level < len(sw.q_moduli):
        raise ValueError(f'level {level} outside the chain of {len(sw.q_moduli)} primes')
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, sw.n):
        raise ValueError(f'expected shape (..., {L}, {sw.n}) at level {level}, '
                         f'got {tuple(x.shape)}')
    beta, alpha, Lq = sw.beta(level), sw.alpha, len(sw.q_moduli)
    kq, kp = ksk.key_q, ksk.key_p
    if (kq.dim() != 4 or kq.shape[0] < beta or tuple(kq.shape[1:]) != (2, Lq, sw.n)
            or kp.dim() != 4 or kp.shape[0] != kq.shape[0]
            or tuple(kp.shape[1:]) != (2, alpha, sw.n)):
        raise ValueError(f'key shapes {tuple(kq.shape)}, {tuple(kp.shape)} do not fit '
                         f'beta={beta}, Lq={Lq}, alpha={alpha}, n={sw.n}')
    for t in (x, kq, kp):
        if t.device != sw.device:
            raise ValueError(f'tensor on {t.device}, key switcher on {sw.device}')


def ksw_switch32(x, ksk, sw, level: int, output_ntt: bool = False):
    """Key switch of coefficient-domain x (..., L, n) with ``ksk`` through
    KeySwitcher ``sw`` at ``level`` → (e0, e1) over Q_ℓ.

    The kernels take x contiguous: a strided view (the relinearize path's
    ``ct3.data[..., 2, :, :]``) is copied once with ``.contiguous()``. The
    key is read in place from ``key_q``/``key_p`` (contiguous, at full
    level)."""
    _check(x, ksk, sw, level)
    if not x.is_cuda:
        return sw.switch_plain(x, ksk, level, output_ntt)
    return _switch(x, ksk, sw, level, output_ntt, switch_route(sw.n))


def _switch(x, ksk, sw, level: int, output_ntt: bool, route: str):
    """B3 on a CUDA stack through ``route`` ('fused' up to n = 2^14,
    'cluster' above); the card tests and ``tools/fused_bench.py`` call it to
    hold and time a route."""
    lib = cuda_build.load('ksw32', _SIGNATURES)
    L, n = level + 1, sw.n
    logn = n.bit_length() - 1
    alpha, beta, Lq = sw.alpha, sw.beta(level), len(sw.q_moduli)
    T = L + alpha
    if alpha > lib.ksw32_max_alpha():
        raise ValueError(f'ksw_switch32 supports at most {lib.ksw32_max_alpha()} special '
                         f'primes, got {alpha}')
    if not (ksk.key_q.is_contiguous() and ksk.key_p.is_contiguous()):
        raise ValueError('ksw_switch32 reads the key in place: key_q and key_p must be '
                         'contiguous')
    if logn > MAX_LOGN:
        raise ValueError(f'ksw_switch32 supports n <= 2^{MAX_LOGN}, got n={n}')
    if route not in ('fused', 'cluster') or (route == 'fused') != (logn <= FUSED_MAX_LOGN):
        raise ValueError(f'the {route} B3 does not take n={n}')
    if ksk.key_q.data_ptr() % 16 or ksk.key_p.data_ptr() % 16:
        raise ValueError('B3 reads the key in 16-byte pieces: key_q and key_p must start on '
                         '16 bytes')
    lead = x.shape[:-2]
    G = x.numel() // (L * n)
    if 2 * G > _MAX_GRID_YZ:
        raise ValueError(f'ksw_switch32 takes at most {_MAX_GRID_YZ // 2} polynomials per '
                         f'call, got {G}')
    e = torch.empty((*lead, 2, L, n), dtype=torch.int64, device=x.device)
    if G:
        x = x.contiguous()
        tabs = _consts(sw, level)
        ring_qp = get_rns_ring(tuple(sw.q_moduli[:L]) + sw.p_moduli, n, sw.device)
        dev = x.device
        out = e if not output_ntt else torch.empty_like(e)
        stream = torch.cuda.current_stream(dev).cuda_stream
        prod = torch.empty((G, 2, T, n), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            if route == 'fused':
                ntab = ntt_cuda.row_tables(ring_qp)
                err = lib.ksw32_rows_launch(
                    x.data_ptr(), ksk.key_q.data_ptr(), ksk.key_p.data_ptr(), prod.data_ptr(),
                    G, L, Lq, alpha, beta, T, logn, ntab['fwd'].data_ptr(),
                    ntab['inv'].data_ptr(), ntab['n_inv'].data_ptr(),
                    ntab['n_inv_shoup'].data_ptr(), tabs['modup'].data_ptr(),
                    tabs['inner'].data_ptr(), stream)
            else:
                ntab = ntt_cuda.cluster_tables(ring_qp, ntt_cuda.cluster_depth(logn))
                err = lib.ksw32_cluster_launch(
                    x.data_ptr(), ksk.key_q.data_ptr(), ksk.key_p.data_ptr(), prod.data_ptr(),
                    G, L, Lq, alpha, beta, T, logn, ntt_cuda.SUB_LOGN, ntab['fwd'].data_ptr(),
                    ntab['inv'].data_ptr(), ntab['cols_fwd'].data_ptr(),
                    ntab['cols_inv'].data_ptr(), ntab['n_inv'].data_ptr(),
                    ntab['n_inv_shoup'].data_ptr(), tabs['modup'].data_ptr(),
                    tabs['inner'].data_ptr(), stream)
            _raise(err, f'{route} rows')
            err = lib.ksw32_moddown32_launch(prod.data_ptr(), out.data_ptr(), 2 * G, L,
                                             alpha, T, n, tabs['moddown'].data_ptr(), stream)
            _raise(err, 'mod-down')
            if output_ntt:
                ntt_cuda.launch(out, e, get_rns_ring(sw.q_moduli[:L], n, sw.device),
                                inverse=False)
        launches['ksw_switch32'] += 1
    return e[..., 0, :, :], e[..., 1, :, :]


def rows_blocks_per_sm(n: int) -> int:
    """Blocks of the fused B3 kernel at n that one SM of the current card
    holds (the occupancy calculator)."""
    got = cuda_build.load('ksw32', _SIGNATURES).ksw32_rows_blocks_per_sm(n.bit_length() - 1)
    if got < 0:
        raise RuntimeError(f'ksw32 occupancy query failed: cudaError_t {-got}')
    return got


def cluster_fit(n: int) -> int:
    """Clusters of the cluster route at n that the current card runs at once
    (``cudaOccupancyMaxActiveClusters``); raises where none fits."""
    got = cuda_build.load('ksw32', _SIGNATURES).ksw32_cluster_fit(n.bit_length() - 1,
                                                                  ntt_cuda.SUB_LOGN)
    if got <= 0:
        raise RuntimeError(f'ksw32 cluster occupancy query failed: cudaError_t {-got}')
    return got


def _raise(err: int, stage: str):
    if err != 0:
        raise RuntimeError(f'ksw32 {stage} launch failed: cudaError_t {err}')
