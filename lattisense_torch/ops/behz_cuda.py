"""Kernels B2 and B4: the BEHZ multiply's two halves for the 32-bit-word engine.

B2, ``behz_prep32``, the front half.

Replaces ``lattisense_tpu/ops/behz_pallas32.py`` ``behz_prep32`` (kernel
``_k1_kernel``). For (..., L, n) coefficient-domain polynomials over Q it
returns ``(to_mont(ntt(x, ring_q)), to_mont(ntt(ExactExtend(x), ring_aux)))``,
exactly the composition of ``BfvEngine.mult`` in the reference
(``schemes/bfv.py:347-349``).

The TPU kernel keeps all L+T rows of a polynomial resident in VMEM (~1.2 MB at
n=16384), more than the 227 KB a block may hold on this card, so the
extension (every limb of a coefficient) and the NTT (every coefficient of a
row) meet in device memory once, as 32-bit rows (``csrc/behz32.cu``): one
thread per two coefficients extends x into a uint32 (..., T, n) scratch,
with L a template parameter so that its digits stay in registers; then
kernel B1's row loop walks the L+T rows of every polynomial in one launch,
the q rows from x and the aux rows from the scratch, each with its limb of
the joint ring q ∪ aux (``prep_ring``), ending in the to-Montgomery
epilogue and int64 stores to fq and fa in 16-byte pairs. Bound by
device-memory bytes: the design moves 8L+4T+8L+4T+8(L+T) bytes a
coefficient against the bound's 8L+8(L+T).

B4, ``behz_finish32``, the back half. Replaces ``behz_pallas32.py``
``behz_finish32`` (kernel ``_k3_kernel``): for the NTT + Montgomery tensor
products dq (..., L, n) and da (..., T, n) it returns
``scale_and_back(intt(from_mont(dq)), intt(from_mont(da)))`` over Q. The TPU
kernel keeps the L+T rows of one product in VMEM. Here the work stays where
the rows are (``csrc/behz32.cu``): kernel B1's loop over the dq rows ends
each row, still in registers, with the q half of the scale-back (the
inverse NTT with the from-Montgomery folded into n^-1, then [tX]_Q
decomposed), its loop over the da rows ends each with the inverse NTT, both
store 32-bit rows, and one thread per coefficient finishes the scale-back
from them: three launches, no int64 intermediate, bound by device-memory
bytes.

The row loops hold a row up to 2^14 (``kMaxLogn`` of ``csrc/behz32.cu``,
B1's row kernel's cap, ``ROWS_MAX_LOGN`` here). At n = 2^15 and 2^16 a row
does not fit a block's registers, and each half takes the cluster route
(``route``): its row-loop step becomes one launch of the cluster body of
``csrc/ntt_cluster.cuh``, one thread-block cluster of 2^k blocks a row over
sub-rows of 2^``ntt_cuda.SUB_LOGN``, with the tables of
``ntt_cuda.cluster_tables(prep_ring(bz), k)`` at ``ntt_cuda.cluster_depth``.
B2 extends into the uint32 scratch as above, then one cluster launch
transforms the joint rows, each block reading the cells of its columns from
x (a q row) or the scratch (an aux row) and ending its sub-row in the
to-Montgomery epilogue and paired stores. B4's cluster launch runs the
inverse over the dq and da rows, each block parking its last window and
crossing the cluster, and ends each row's cells in the q half of the
scale-back or in X_aux,k, as 32-bit rows; the per-coefficient scale-back
follows. So both routes move the same bytes.

Each wrapper counts one launch per call, the cluster route also under
``behz32_prep_cluster`` / ``behz32_finish_cluster``; neither launches any of
B1's entries. A CPU tensor runs the plain PyTorch composition below; a CUDA
tensor launches the kernels or raises. ``tests/test_torch_prep_bconv.py``
and ``tests/test_torch_fused_rows.py`` walk both routes on the CPU.
"""

import ctypes
import math

import torch

from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..core.rns import _shoup
from ..params import MTILDE
from ..utils import observability
from . import cuda_build, ntt_cuda

#: launches of each wrapper's kernels since the last reset (a call's cluster
#: launch also under ``*_cluster``)
launches = {'behz_prep32': 0, 'behz_finish32': 0, 'behz32_prep_cluster': 0,
            'behz32_finish_cluster': 0}
observability.register('behz_cuda', launches,
                       launches=[k for k in launches if not k.endswith('_cluster')])

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'behz32_prep_launch': [_P] * 4 + [_I] * 4 + [_P] * 6,
    'behz32_finish_launch': [_P] * 5 + [_I] * 4 + [_P] * 10,
    'behz32_prep_cluster_launch': [_P] * 4 + [_I] * 5 + [_P] * 7,
    'behz32_finish_cluster_launch': [_P] * 5 + [_I] * 5 + [_P] * 7,
    'behz32_cluster_fit': [_I] * 3,
    'behz32_max_limbs': [],
    'behz32_max_aux': [],
    'behz32_max_logn': [],
}
MAX_LOGN = ntt_cuda.MAX_LOGN
ROWS_MAX_LOGN = ntt_cuda.ROW_MAX_LOGN   # the row loops (behz32.cu kMaxLogn)


def route(n: int) -> str:
    """The route B2 and B4 take at n, chosen by shape: 'rows' (B1's row loop
    restated, one block a row) up to n = 2^14, 'cluster' (one thread-block
    cluster a row) above."""
    return 'rows' if n.bit_length() - 1 <= ROWS_MAX_LOGN else 'cluster'


def cluster_fit(n: int, inverse: bool) -> int:
    """Clusters of B2's (or, ``inverse``, B4's) cluster kernel at n = 2^15 or
    2^16 that the current card runs at once, from
    ``cudaOccupancyMaxActiveClusters``; raises where none fits."""
    got = cuda_build.load('behz32', _SIGNATURES).behz32_cluster_fit(
        n.bit_length() - 1, ntt_cuda.SUB_LOGN, int(inverse))
    if got <= 0:
        raise RuntimeError(f'behz32 cluster occupancy query failed: cudaError_t {-got}')
    return got


def behz_prep_plain(x, bz):
    """The reference composition: extend, two forward NTTs, to-Montgomery."""
    rq, ra = bz.ring_q, bz.ring_aux
    fq = ntt_cuda.ntt_plain(x, rq, to_mont=True)
    fa = ntt_cuda.ntt_plain(bz.extend(x), ra, to_mont=True)
    return fq, fa


def _sh(v: int, q: int) -> int:
    return (v << 32) // q


def _consts(bz):
    """The extension kernel's uint32 constant block (layout in behz32.cu),
    cached on the BehzMult object."""
    tab = getattr(bz, '_b2_consts', None)
    if tab is None:
        observability.table_built('behz_cuda._consts')
        src = list(bz.ring_q.moduli)
        dst = list(bz.ring_aux.moduli)
        Q = math.prod(src)
        qhat = [Q // qi for qi in src]
        qhat_inv = [pow(h, -1, qi) for h, qi in zip(qhat, src)]
        mt = [MTILDE % qi for qi in src]
        qm = [Q % d for d in dst]
        mti = [pow(MTILDE, -1, d) for d in dst]
        cv = [qhat[i] % d for i in range(len(src)) for d in dst]
        cs = [_sh(qhat[i] % d, d) for i in range(len(src)) for d in dst]
        vals = (src + mt + [_sh(v, q) for v, q in zip(mt, src)]
                + qhat_inv + [_sh(v, q) for v, q in zip(qhat_inv, src)]
                + [h % MTILDE for h in qhat]
                + dst + qm + [_sh(v, d) for v, d in zip(qm, dst)]
                + mti + [_sh(v, d) for v, d in zip(mti, dst)]
                + cv + cs + [bz.extend.smmrq.neg_qinv_mtilde])
        tab = ntt_cuda.u32_tensor(vals, bz.ring_q.device)
        bz._b2_consts = tab
    return tab


def prep_ring(bz):
    """The joint ring of B2's row launch: ring_q's L limbs followed by
    ring_aux's T, so that row k of a polynomial's L+T rows takes limb k."""
    rq, ra = bz.ring_q, bz.ring_aux
    return get_rns_ring(tuple(rq.moduli) + tuple(ra.moduli), rq.n, rq.device, 32)


def behz_prep32(x, bz):
    """Fused BEHZ prep for an int64 (..., L, n) stack of coefficient-domain
    polynomials over ``bz.ring_q``: returns (fq (..., L, n), fa (..., T, n))."""
    _u.require_word(bz, 32, 'behz_prep32')
    rq, ra = bz.ring_q, bz.ring_aux
    ntt_cuda.check_stack(x, rq)
    if not x.is_cuda:
        return behz_prep_plain(x, bz)
    if not x.is_contiguous():
        raise ValueError('behz_prep32 takes a contiguous tensor')
    L, T, n = len(rq.moduli), len(ra.moduli), rq.n
    lib = cuda_build.load('behz32', _SIGNATURES)
    if L > lib.behz32_max_limbs():
        raise ValueError(f'behz_prep32 supports at most {lib.behz32_max_limbs()} limbs, got {L}')
    if not 1 <= n.bit_length() - 1 <= MAX_LOGN:
        raise ValueError(f'behz_prep32 supports 2 <= n <= 2^{MAX_LOGN}, got n={n}')
    lead = x.shape[:-2]
    polys = x.numel() // (L * n)
    fq = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    fa = torch.empty((*lead, T, n), dtype=torch.int64, device=x.device)
    if polys:
        x = x if x.data_ptr() % 16 == 0 else x.clone()    # rows move in 16-byte pieces
        ext = torch.empty((*lead, T, n), dtype=torch.int32, device=x.device)
        logn = n.bit_length() - 1
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            if route(n) == 'rows':
                tabs = ntt_cuda.row_tables(prep_ring(bz))
                err = lib.behz32_prep_launch(
                    x.data_ptr(), ext.data_ptr(), fq.data_ptr(), fa.data_ptr(), polys, L, T, logn,
                    _consts(bz).data_ptr(),
                    *(tabs[k].data_ptr() for k in ('fwd', 'q', 'r1', 'r1_shoup')), stream)
            else:
                tabs = ntt_cuda.cluster_tables(prep_ring(bz), ntt_cuda.cluster_depth(logn))
                err = lib.behz32_prep_cluster_launch(
                    x.data_ptr(), ext.data_ptr(), fq.data_ptr(), fa.data_ptr(), polys, L, T, logn,
                    ntt_cuda.SUB_LOGN, _consts(bz).data_ptr(),
                    *(tabs[k].data_ptr() for k in ('fwd', 'cols_fwd', 'cols_q', 'r1', 'r1_shoup')),
                    stream)
        if err != 0:
            raise RuntimeError(f'behz32 prep launch failed: cudaError_t {err}')
        launches['behz_prep32'] += 1
        if route(n) == 'cluster':
            launches['behz32_prep_cluster'] += 1
    return fq, fa


# ---------------------------------------------------------------------------
# B4: behz_finish32
# ---------------------------------------------------------------------------

def behz_finish_plain(dq, da, bz):
    """The reference composition: from_mont, inverse NTT on both bases,
    ``scale_and_back``."""
    rq, ra = bz.ring_q, bz.ring_aux
    dq = ntt_cuda.intt_plain(_u.from_mont(dq, rq.q, rq.pinv), rq)
    da = ntt_cuda.intt_plain(_u.from_mont(da, ra.q, ra.pinv), ra)
    return bz.scale_and_back(dq, da)


def _finish_consts(bz):
    """The scale-back kernel's uint32 constant block (layout in behz32.cu),
    cached on the BehzMult object."""
    tab = getattr(bz, '_b4_consts', None)
    if tab is None:
        observability.table_built('behz_cuda._finish_consts')
        q = list(bz.ring_q.moduli)
        aux = list(bz.ring_aux.moduli)
        b, m_sk, t = aux[:-1], aux[-1], bz.t
        Q, B = math.prod(q), math.prod(b)
        qhi = [pow(Q // qi, -1, qi) for qi in q]
        qinv = [pow(Q % d, -1, d) for d in aux]
        bhi = [pow(B // bk, -1, bk) for bk in b]
        binv = pow(B % m_sk, -1, m_sk)
        dst2 = q + [m_sk]

        def pair(vals, mods):
            return vals + [_shoup(v, m) for v, m in zip(vals, mods)]

        vals = (q + pair([t % qi for qi in q], q) + pair(qhi, q) + pair([B % qi for qi in q], q)
                + aux + pair([t % d for d in aux], aux) + pair(qinv, aux)
                + [(Q // qi) % d for qi in q for d in aux]
                + [_shoup((Q // qi) % d, d) for qi in q for d in aux]
                + pair(bhi, b)
                + [(B // bk) % d for bk in b for d in dst2]
                + [_shoup((B // bk) % d, d) for bk in b for d in dst2]
                + [binv, _shoup(binv, m_sk), m_sk >> 1])
        tab = ntt_cuda.u32_tensor(vals, bz.ring_q.device)
        bz._b4_consts = tab
    return tab


def behz_finish32(dq, da, bz):
    """Fused BEHZ finish: dq (..., L, n) over ``bz.ring_q`` and da (..., T, n)
    over ``bz.ring_aux``, both NTT + Montgomery, with the same leading
    dimensions → (..., L, n) over Q in the coefficient domain."""
    _u.require_word(bz, 32, 'behz_finish32')
    rq, ra = bz.ring_q, bz.ring_aux
    ntt_cuda.check_stack(dq, rq)
    ntt_cuda.check_stack(da, ra)
    if dq.shape[:-2] != da.shape[:-2]:
        raise ValueError(f'leading dimensions differ: {tuple(dq.shape)} vs {tuple(da.shape)}')
    if not dq.is_cuda:
        return behz_finish_plain(dq, da, bz)
    if not (dq.is_contiguous() and da.is_contiguous()):
        raise ValueError('behz_finish32 takes contiguous tensors')
    L, T, n = len(rq.moduli), len(ra.moduli), rq.n
    lib = cuda_build.load('behz32', _SIGNATURES)
    if L > lib.behz32_max_limbs() or T > lib.behz32_max_aux():
        raise ValueError(f'behz_finish32 supports at most {lib.behz32_max_limbs()} limbs and '
                         f'{lib.behz32_max_aux()} aux limbs, got {L} and {T}')
    if not 1 <= n.bit_length() - 1 <= MAX_LOGN:
        raise ValueError(f'behz_finish32 supports 2 <= n <= 2^{MAX_LOGN}, got n={n}')
    out = torch.empty(dq.shape, dtype=torch.int64, device=dq.device)
    polys = dq.numel() // (L * n)
    if polys:
        # the row kernels stage rows in 16-byte pieces
        dq = dq if dq.data_ptr() % 16 == 0 else dq.clone()
        da = da if da.data_ptr() % 16 == 0 else da.clone()
        y = torch.empty(dq.shape, dtype=torch.int32, device=dq.device)
        xa = torch.empty(da.shape, dtype=torch.int32, device=dq.device)
        logn = n.bit_length() - 1
        stream = torch.cuda.current_stream(dq.device).cuda_stream
        with torch.cuda.device(dq.device):
            if route(n) == 'rows':
                tq, ta = ntt_cuda.row_tables(rq), ntt_cuda.row_tables(ra)
                err = lib.behz32_finish_launch(
                    dq.data_ptr(), da.data_ptr(), out.data_ptr(), y.data_ptr(), xa.data_ptr(),
                    polys, L, T, logn,
                    *(t[k].data_ptr() for t in (tq, ta)
                      for k in ('inv', 'q', 'n_inv_rinv', 'n_inv_rinv_shoup')),
                    _finish_consts(bz).data_ptr(), stream)
            else:
                tabs = ntt_cuda.cluster_tables(prep_ring(bz), ntt_cuda.cluster_depth(logn))
                err = lib.behz32_finish_cluster_launch(
                    dq.data_ptr(), da.data_ptr(), out.data_ptr(), y.data_ptr(), xa.data_ptr(),
                    polys, L, T, logn, ntt_cuda.SUB_LOGN,
                    *(tabs[k].data_ptr() for k in ('inv', 'cols_inv', 'cols_q', 'n_inv_rinv',
                                                   'n_inv_rinv_shoup')),
                    _finish_consts(bz).data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f'behz32 finish launch failed: cudaError_t {err}')
        launches['behz_finish32'] += 1
        if route(n) == 'cluster':
            launches['behz32_finish_cluster'] += 1
    return out
