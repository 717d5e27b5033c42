"""RNS basis conversion and scaling primitives (the BEHZ toolbox) on tensors.

Port of ``lattisense_tpu/core/rns.py`` for both machine words: fast base
conversion, the m̃-trick small Montgomery reduction (SmMRq) for exact
extension, Shenoy–Kumaresan exact back-conversion and divide-and-round by
the last prime. Every class takes ``word_bits`` (32 or 64), holds its
constants as int64 tensors on one device (64-bit constants as their bit
patterns) and works on (..., L, n) limb stacks with plain elementwise
PyTorch. At the 64-bit word ``BasisConv.convert`` is kernel B6
(``ops/bconv_cuda.py``) on a CUDA tensor.
"""

import math

import torch

from . import u64 as _u
from ..ops.bconv_cuda import bconv64_convert, bconv64_plain
from ..params import MTILDE


def _col(vals, device):
    return torch.tensor([_u.to_s64(v) for v in vals], dtype=torch.int64,
                        device=device).reshape(len(vals), 1)


def _mont(v: int, p: int, bits: int) -> int:
    return (v << bits) % p


def _shoup(v: int, p: int, bits: int = 32) -> int:
    return (v << bits) // p


def _pinv(p: int, bits: int) -> int:
    return (-pow(p, -1, 1 << bits)) % (1 << bits)


class BasisConv:
    """Fast base conversion src → dst (FastBConv):
    conv(x)_t = Σ_i [x_i · (Q/q_i)^-1]_{q_i} · [Q/q_i]_{d_t} mod d_t
             = x + α·Q for some 0 ≤ α ≤ |src|."""

    def __init__(self, src: tuple[int, ...], dst: tuple[int, ...], device,
                 word_bits: int = 32):
        b = word_bits
        self.word_bits = b
        self.word = _u.word(b)
        self.src = tuple(src)
        self.dst = tuple(dst)
        Q = math.prod(src)
        qhat = [Q // qi for qi in src]
        qhat_inv = [pow(h, -1, qi) for h, qi in zip(qhat, src)]
        self.src_q = _col(src, device)
        self.dst_q = _col(dst, device)
        self.dst_pinv = _col([_pinv(d, b) for d in dst], device)
        self.qhat_inv = _col(qhat_inv, device)
        self.qhat_inv_shoup = _col([_shoup(v, qi, b) for v, qi in zip(qhat_inv, src)], device)
        # [Q/q_i]_{d_t} in Montgomery form w.r.t. d_t: (T, L)
        self.qhat_dst_mont = torch.tensor(
            [[_u.to_s64(_mont(qhat[i] % d, d, b)) for i in range(len(src))] for d in dst],
            dtype=torch.int64, device=device)
        self.qhat_mtilde = torch.tensor([qhat[i] % MTILDE for i in range(len(src))],
                                        dtype=torch.int64, device=device)

    def decompose(self, x):
        """y_i = [x_i · (Q/q_i)^-1]_{q_i};  x: (..., L, n)."""
        return self.word.shoup_mul(x, self.qhat_inv, self.qhat_inv_shoup, self.src_q)

    def convert(self, y, plain: bool = False):
        """Σ_i y_i · [Q/q_i]_{d_t} mod d_t;  y: (..., L, n) → (..., T, n).

        At the 64-bit word this is kernel B6 (``bconv64_convert``: the
        kernel on a CUDA tensor, its plain twin on a CPU tensor or with
        ``plain``). At the 32-bit word, one source limb at a time: the int64
        sum of L Montgomery products below 2^31 is exact, and one reduction
        at the end gives the same canonical value as the reference's addmod
        fold, without holding the (..., T, L, n) terms tensor."""
        if self.word_bits == 64:
            if plain:
                return bconv64_plain(y, self.qhat_dst_mont, self.dst_q, self.dst_pinv)
            return bconv64_convert(y, self)
        acc = None
        for i in range(len(self.src)):
            term = _u.mont_mul(y[..., i:i + 1, :], self.qhat_dst_mont[:, i:i + 1],
                               self.dst_q, self.dst_pinv)
            acc = term if acc is None else acc + term
        return torch.remainder(acc, self.dst_q)

    def convert_mtilde(self, y):
        """The same conversion targeting m̃ = 2^16 (masks only: the int64
        sum is exact, and m̃ divides 2^32 as in the reference's u32 sum)."""
        mask = MTILDE - 1
        return ((y & mask) * self.qhat_mtilde[:, None]).sum(dim=-2) & mask

    def __call__(self, x):
        return self.convert(self.decompose(x))


class SmMRq:
    """BEHZ small Montgomery reduction mod m̃: removes the α·Q overflow of a
    FastBConv of [x·m̃]_Q, yielding x' ≡ x (mod Q) with ‖x'‖ ≤ Q(1+|src|)/2."""

    def __init__(self, src_q: tuple[int, ...], dst: tuple[int, ...], device,
                 word_bits: int = 32):
        b = word_bits
        self.word_bits = b
        self.word = _u.word(b)
        Q = math.prod(src_q)
        self.neg_qinv_mtilde = (-pow(Q, -1, MTILDE)) % MTILDE
        self.dst_q = _col(dst, device)
        self.dst_pinv = _col([_pinv(d, b) for d in dst], device)
        self.q_mont = _col([_mont(Q % d, d, b) for d in dst], device)
        self.mtilde_inv_mont = _col([_mont(pow(MTILDE, -1, d), d, b) for d in dst], device)

    def __call__(self, ext, ext_mtilde):
        """ext: (..., T, n) residues of x·m̃+αQ; ext_mtilde: (..., n) mod m̃."""
        r = ((ext_mtilde * self.neg_qinv_mtilde) & (MTILDE - 1))[..., None, :]
        # center r to [-m̃/2, m̃/2): negative r maps to dst_q - (m̃ - r)
        r_mod = torch.where(r >= MTILDE // 2, self.dst_q - (MTILDE - r), r)
        term = self.word.mont_mul(r_mod, self.q_mont, self.dst_q, self.dst_pinv)
        s = _u.addmod(ext, term, self.dst_q)
        return self.word.mont_mul(s, self.mtilde_inv_mont, self.dst_q, self.dst_pinv)


class ExactExtend:
    """Exact extension R_Q → R_{B ∪ m_sk}: x ↦ [x·m̃]_Q → FastBConv → SmMRq."""

    def __init__(self, src: tuple[int, ...], dst: tuple[int, ...], device,
                 word_bits: int = 32):
        b = word_bits
        self.word_bits = b
        self.word = _u.word(b)
        self.src_q = _col(src, device)
        self.src_pinv = _col([_pinv(q, b) for q in src], device)
        self.mtilde_mont = _col([_mont(MTILDE % q, q, b) for q in src], device)
        self.conv = BasisConv(src, dst, device, b)
        self.smmrq = SmMRq(src, dst, device, b)

    def __call__(self, x):
        xm = self.word.mont_mul(x, self.mtilde_mont, self.src_q, self.src_pinv)
        y = self.conv.decompose(xm)
        return self.smmrq(self.conv.convert(y), self.conv.convert_mtilde(y))


class ShenoyConvert:
    """Exact conversion B → Q using the redundant modulus m_sk
    (Shenoy–Kumaresan): corrects FastBConv's α·B overflow exactly."""

    def __init__(self, b_primes: tuple[int, ...], m_sk: int, dst: tuple[int, ...], device,
                 word_bits: int = 32):
        b = word_bits
        self.word_bits = b
        self.word = _u.word(b)
        B = math.prod(b_primes)
        self.m_sk = m_sk
        self.conv = BasisConv(b_primes, tuple(dst) + (m_sk,), device, b)
        self.binv_sk = pow(B % m_sk, -1, m_sk)
        self.sk_pinv = _u.to_s64(_pinv(m_sk, b))
        self.binv_sk_mont = _mont(self.binv_sk, m_sk, b)
        self.dst_q = _col(dst, device)
        self.dst_pinv = _col([_pinv(d, b) for d in dst], device)
        self.b_mont = _col([_mont(B % d, d, b) for d in dst], device)

    def __call__(self, x_b, x_sk):
        """x_b: (..., T, n) residues in B; x_sk: (..., n) residue mod m_sk."""
        full = self.conv(x_b)                     # (..., |dst|+1, n) = x + αB
        conv_q, conv_sk = full[..., :-1, :], full[..., -1, :]
        diff = _u.submod(conv_sk, x_sk, self.m_sk)
        alpha = self.word.mont_mul(diff, self.binv_sk_mont, self.m_sk, self.sk_pinv)
        # α is small (≤ |B|); center to allow slight negatives from rounding
        alpha = alpha[..., None, :]
        alpha_mod = torch.where(alpha >= (self.m_sk >> 1),
                                self.dst_q - (self.m_sk - alpha), alpha)
        corr = self.word.mont_mul(alpha_mod, self.b_mont, self.dst_q, self.dst_pinv)
        return _u.submod(conv_q, corr, self.dst_q)


class DivRoundLast:
    """c' = round(c / q_last) on RNS limbs: BFV modulus switching (drops the
    last limb)."""

    def __init__(self, moduli: tuple[int, ...], device, word_bits: int):
        if len(moduli) < 2:
            raise ValueError('DivRoundLast needs at least two moduli')
        b = word_bits
        self.word_bits = b
        self.word = _u.word(b)
        q_last = moduli[-1]
        rest = moduli[:-1]
        self.q_last_half = (q_last + 1) // 2
        self.dst_q = _col(rest, device)
        self.dst_pinv = _col([_pinv(d, b) for d in rest], device)
        self.qlast_inv_mont = _col([_mont(pow(q_last % d, -1, d), d, b) for d in rest], device)

    def __call__(self, x):
        """x: (..., L, n) → (..., L-1, n)."""
        c_rest, c_last = x[..., :-1, :], x[..., -1:, :]
        a = self.word.mont_mul(c_last, self.qlast_inv_mont, self.dst_q, self.dst_pinv)
        b = self.word.mont_mul(c_rest, self.qlast_inv_mont, self.dst_q, self.dst_pinv)
        delta = (c_last >= self.q_last_half).long()
        return _u.addmod(_u.submod(b, a, self.dst_q), delta, self.dst_q)
