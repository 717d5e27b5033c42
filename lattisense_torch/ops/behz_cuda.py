"""Kernel B2: the BEHZ multiply front half for the 32-bit-word engine.

Replaces ``lattisense_tpu/ops/behz_pallas32.py`` ``behz_prep32`` (kernel
``_k1_kernel``). For (..., L, n) coefficient-domain polynomials over Q it
returns ``(to_mont(ntt(x, ring_q)), to_mont(ntt(ExactExtend(x), ring_aux)))``,
exactly the composition of ``BfvEngine.mult`` in the reference
(``schemes/bfv.py:347-349``).

The TPU kernel keeps all L+T rows of a polynomial resident in VMEM (~1.2 MB at
n=16384), more than the 227 KB a block may hold on this card, so the work is
split in two: ``csrc/behz32.cu`` extends each coefficient in its own thread
(the L decomposed digits in a per-thread local array, every conversion
constant in shared memory) into a scratch (..., T, n) tensor, then kernel
B1's forward NTT with its to-Montgomery epilogue runs over the q rows and
over the aux rows. Both
parts are bound by device-memory bytes (the extension does ~(9L+12)·T 32-bit
operations per coefficient, ~6.6 per byte moved at L=8, T=11); the split
costs one extra write and read of the T aux rows.

A CPU tensor runs the plain PyTorch composition below; a CUDA tensor launches
the kernels or raises.
"""

import ctypes
import math

import torch

from ..params import MTILDE
from . import cuda_build, ntt_cuda

#: launches of the wrapper's kernels since the last reset
launches = {'behz_prep32': 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'behz32_extend_launch': [_P, _P, _I, _I, _I, _I, _P, _P],
    'behz32_max_limbs': [],
}


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


def behz_prep32(x, bz):
    """Fused BEHZ prep for an int64 (..., L, n) stack of coefficient-domain
    polynomials over ``bz.ring_q``: returns (fq (..., L, n), fa (..., T, n))."""
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
    lead = x.shape[:-2]
    polys = x.numel() // (L * n)
    ext = torch.empty((*lead, T, n), dtype=torch.int64, device=x.device)
    fq = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    fa = torch.empty(ext.shape, dtype=torch.int64, device=x.device)
    if polys:
        consts = _consts(bz)
        with torch.cuda.device(x.device):
            err = lib.behz32_extend_launch(x.data_ptr(), ext.data_ptr(), polys, L, T, n,
                                           consts.data_ptr(),
                                           torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'behz32 extension launch failed: cudaError_t {err}')
        ntt_cuda.launch(x, fq, rq, inverse=False, to_mont=True)
        ntt_cuda.launch(ext, fa, ra, inverse=False, to_mont=True)
        launches['behz_prep32'] += 1
    return fq, fa
