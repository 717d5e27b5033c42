"""Kernel B6: the 64-bit-word fast base conversion sum (FastBConv).

Replaces ``lattisense_tpu/ops/bconv_pallas.py`` ``bconv_convert_fused`` and
``bconv_raw_fused`` (kernel ``_bconv_kernel``):

    out[..., t, i] = Σ_l mont_mul(y[..., l, i], C[t, l]) mod d_t

with Montgomery constants C (T, L) for R = 2^64, every output the
canonical residue. The CUDA source is ``csrc/bconv64.cu``: one thread per
two coefficients of a row holds its L source residues in registers
(compile-time (L, T) instances for the path's shapes, an instance of each
L with a run-time T otherwise) and sums the L 128-bit products y·C before
one Montgomery reduction an output. That single reduction is exact while
the sum stays below d·2^64, which the wrapper proves from the largest
source residue (``lazy_fold``); where it cannot for all L terms, the kernel
folds the sum's high word after each term past the proven count.

Entries:

- ``bconv64_convert(y, conv)``: the conversion of a 64-bit-word
  ``core/rns.py`` ``BasisConv`` (the BEHZ extension, ``scale_and_back``,
  Shenoy–Kumaresan and ``RoundDivP`` all reach it through
  ``BasisConv.convert``);
- ``bconv64_raw(y, C, dst_q, dst_pinv)``: caller-supplied constants. C may
  be (T, L), or (G, T, L) with y (..., G, L, n): group g of y takes C[g]. The
  key switch's mod-up passes all β digits' constants at once, so one launch
  converts every digit (the reference loops over digits in Python).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
twin ``bconv64_plain`` (the reference's sum on the 64-bit word functions).
Each entry counts its launches under its own name.
"""

import ctypes

import torch

from ..core import u64 as _u
from ..utils import observability
from . import cuda_build

#: launches of each entry since the last reset
launches = {'bconv64_convert': 0, 'bconv64_raw': 0}
observability.register('bconv_cuda', launches, launches=launches)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'bconv64_launch': [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    'bconv64_max_src': [],
    'bconv64_max_const_words': [],
    'bconv64_specific': [_I, _I, _I],
}
#: the largest residue of the 64-bit word: every modulus is below 2^62
WORD_GUARD = (1 << 62) - 1


def lazy_fold(L: int, ymax: int) -> int:
    """How many of the L terms y_l·C_l (y_l ≤ ymax, C_l < d) the kernel may
    sum before its one Montgomery reduction: the most F ≤ L with
    F·ymax ≤ 2^64, so that the sum stays below d·2^64. F = L: the lazy sum
    of all terms is exact; F < L: the kernel folds the high word after each
    term past the F-th."""
    return max(1, min(L, (1 << 64) // max(ymax, 1)))


def bconv64_plain(y, C, dst_q, dst_pinv):
    """The plain twin: y (..., L, n) with C (T, L), or y (..., G, L, n) with
    C (G, T, L) → (..., [G,] T, n); dst_q / dst_pinv hold the T moduli and
    -d^-1 mod 2^64 (any shape with T entries)."""
    grouped = C.dim() == 3
    cg = C if grouped else C[None]
    yg = y if grouped else y.unsqueeze(-3)                    # (..., G, L, n)
    q, pinv = dst_q.reshape(-1, 1), dst_pinv.reshape(-1, 1)   # (T, 1)
    acc = None
    for l in range(cg.shape[-1]):
        term = _u.mont_mul64(yg[..., :, l:l + 1, :], cg[:, :, l:l + 1], q, pinv)
        acc = term if acc is None else _u.addmod(acc, term, q)
    return acc if grouped else acc.squeeze(-3)


def _check(y, C, dst_q, dst_pinv):
    if not isinstance(y, torch.Tensor) or y.dtype != torch.int64:
        raise TypeError(f'expected an int64 tensor, got {getattr(y, "dtype", type(y))}')
    if C.dim() not in (2, 3) or C.dtype != torch.int64:
        raise ValueError(f'constants must be an int64 (T, L) or (G, T, L) tensor, got '
                         f'{tuple(C.shape)} {C.dtype}')
    T, L = C.shape[-2:]
    lead = 3 if C.dim() == 3 else 2
    if y.dim() < lead or y.shape[-2] != L or (C.dim() == 3 and y.shape[-3] != C.shape[0]):
        raise ValueError(f'input {tuple(y.shape)} does not fit constants {tuple(C.shape)}')
    if dst_q.numel() != T or dst_pinv.numel() != T:
        raise ValueError(f'expected {T} destination moduli, got {dst_q.numel()}, '
                         f'{dst_pinv.numel()}')
    for t in (C, dst_q, dst_pinv):
        if t.device != y.device:
            raise ValueError(f'tensor on {y.device}, constants on {t.device}')


def _launch(y, C, dst_q, dst_pinv, ymax: int, name: str):
    """Launch B6 over y's rows on the current stream and count it; ``ymax``
    bounds y's residues."""
    for t in (C, dst_q, dst_pinv):
        if not t.is_contiguous():
            raise ValueError(f'{name}: constants must be contiguous')
    lib = cuda_build.load('bconv64', _SIGNATURES)
    G = C.shape[0] if C.dim() == 3 else 1
    T, L = C.shape[-2:]
    n = y.shape[-1]
    if L > lib.bconv64_max_src() or G * T * L + 2 * T > lib.bconv64_max_const_words():
        raise ValueError(f'{name} supports at most {lib.bconv64_max_src()} source limbs and '
                         f'{lib.bconv64_max_const_words()} constant words, got L={L}, '
                         f'G·T·L+2T={G * T * L + 2 * T}')
    y = y.contiguous()
    y = y if y.data_ptr() % 16 == 0 else y.clone()        # rows move in 16-byte pieces
    out = torch.empty((*y.shape[:-2], T, n), dtype=torch.int64, device=y.device)
    rows = y.numel() // (L * n)
    if rows:
        with torch.cuda.device(y.device):
            err = lib.bconv64_launch(y.data_ptr(), out.data_ptr(), rows, G, L, T, n,
                                     lazy_fold(L, ymax), C.data_ptr(), dst_q.data_ptr(),
                                     dst_pinv.data_ptr(),
                                     torch.cuda.current_stream(y.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'{name} launch failed: cudaError_t {err}')
        launches[name] += 1
    return out


def instance(L: int, T: int, ymax: int) -> str:
    """Which kernel instance B6 takes for L source and T destination limbs
    with residues up to ``ymax``: 'specific' (compile-time L and T, the lazy
    sum proven exact) or 'generic' (compile-time L, run-time T and fold)."""
    lib = cuda_build.load('bconv64', _SIGNATURES)
    return 'specific' if lib.bconv64_specific(L, T, lazy_fold(L, ymax)) else 'generic'


def bconv64_raw(y, C, dst_q, dst_pinv):
    """FastBConv sum with caller-supplied 64-bit Montgomery constants: y
    (..., L, n) with C (T, L), or y (..., G, L, n) with C (G, T, L). The
    residues of y are taken below 2^62, the word's guard; C's below their
    moduli."""
    _check(y, C, dst_q, dst_pinv)
    if not y.is_cuda:
        return bconv64_plain(y, C, dst_q, dst_pinv)
    return _launch(y, C, dst_q, dst_pinv, WORD_GUARD, 'bconv64_raw')


def bconv64_convert(y, conv):
    """``BasisConv.convert`` of a 64-bit-word BasisConv: decomposed
    residues y (..., L, n), each below its source modulus, → (..., T, n)."""
    _u.require_word(conv, 64, 'bconv64_convert')
    C, q, pinv = conv.qhat_dst_mont, conv.dst_q, conv.dst_pinv
    _check(y, C, q, pinv)
    if not y.is_cuda:
        return bconv64_plain(y, C, q, pinv)
    return _launch(y, C, q, pinv, max(conv.src) - 1, 'bconv64_convert')
