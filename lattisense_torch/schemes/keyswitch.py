"""Hybrid RNS key switching (GHS / Lattigo-style gadget product) on tensors.

Port of ``lattisense_tpu/schemes/keyswitch.py`` for both machine words.
switch(x, ksk) for x ∈ R_{Q_ℓ} (coefficient domain) computes (e0, e1) with
e0 + e1·s ≈ x·s' by:

1. digit-decomposing x into β = ceil((ℓ+1)/α) groups of α = |P| limbs,
2. mod-up of each digit to Q_ℓ ∪ P (FastBConv),
3. NTT, inner product with the Montgomery-form key digits, accumulate,
4. INTT and divide-and-round by P (``RoundDivP``).

``switch`` dispatches on the word. At the 32-bit word it is kernel B3
(``ops/ksw_cuda.py`` ``ksw_switch32``) on a CUDA tensor. At the 64-bit word
it is the composition above with the mod-up of all β digits as one launch
of kernel B6 (``ops/bconv_cuda.py`` ``bconv64_raw``), the NTTs as kernel B5
(``ops/ntt64_cuda.py``), the inner product as kernel B7
(``ops/ksw64_cuda.py`` ``ksw_inner64``) and ``RoundDivP``'s conversion as
B6. ``switch_plain`` is the plain composition, the twin of either word's
kernels, plain PyTorch throughout; on a CPU tensor ``switch`` computes the
same through each kernel's plain twin. Leading batch dimensions pass
through every step.
"""

import math

import torch

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..core.rns import BasisConv, _col, _mont, _pinv, _shoup
from ..ops.bconv_cuda import bconv64_plain, bconv64_raw
from ..ops.ksw64_cuda import ksw_inner64, ksw_inner64_plain
from ..ops.ksw_cuda import ksw_switch32, switch_route
from ..utils import observability
from ..utils.observability import OFF, span


def _stage(name: str, plain: bool):
    """The span of one stage of the 64-bit word's key switch. The plain
    composition records none: at the 32-bit word it is B3's twin, and B3
    is one call without stages."""
    return OFF if plain else span(name)


class RoundDivP:
    """c' = round(c / P): exact mod-down Q_ℓ∪P → Q_ℓ, with the reference's
    overflow correction: the FastBConv of the P part overflows by v·P,
    v = floor(Σ_j y_j/p_j), which is estimated and added back. At the
    32-bit word the estimate is the fixed point (Σ_j y_j·floor(2^62/p_j))
    >> 62; at the 64-bit word a float64 sum."""

    def __init__(self, q_moduli: tuple[int, ...], p_moduli: tuple[int, ...], device,
                 word_bits: int = 32):
        b = word_bits
        self.word_bits = b
        self.word = _u.word(b)
        P = math.prod(p_moduli)
        half = P // 2
        self.conv = BasisConv(p_moduli, q_moduli, device, b)
        self.p_q = _col(p_moduli, device)
        self.dst_q = _col(q_moduli, device)
        self.dst_pinv = _col([_pinv(q, b) for q in q_moduli], device)
        self.half_p = _col([half % p for p in p_moduli], device)
        self.half_q = _col([half % q for q in q_moduli], device)
        self.pinv_mont = _col([_mont(pow(P % q, -1, q), q, b) for q in q_moduli], device)
        self.p_inv_fx = _col([(1 << 62) // p for p in p_moduli], device)
        # 1/p_j rounded to float64 as the reference rounds it (1.0 / float64(p_j))
        self.p_inv_f = [1.0 / float(p) for p in p_moduli]

    def overflow(self, y):
        """v = floor(Σ_j y_j/p_j) for decomposed digits y (..., |P|, n).

        32-bit word: each term y_j·floor(2^62/p_j) is below 2^62, but their
        sum may pass 2^63 (α = 4 comes close to 2^64): the int64 sum then
        wraps, keeping the low 64 bits of the reference's uint64 sum, whose
        top two bits are (sum >> 62) & 3.

        64-bit word: the reference's float64 estimate, bit for bit: each
        y_j is rounded to float64 (round to nearest, as NumPy converts),
        multiplied by the float64 1/p_j, and the products are added left to
        right in j order (NumPy's reduction order over this axis), each
        operation its own rounded PyTorch kernel. ``.sum()`` is not used:
        its order on CUDA is unspecified. A kernel that takes this estimate
        over must compile without FMA contraction (``--fmad=false``, or
        ``__dmul_rn``/``__dadd_rn``): a fused multiply-add rounds once
        where the reference rounds twice."""
        if self.word_bits == 32:
            acc = (y * self.p_inv_fx).sum(dim=-2)
            return (acc >> 62) & 3
        frac = None
        for j, inv in enumerate(self.p_inv_f):
            term = y[..., j, :].to(torch.float64) * inv
            frac = term if frac is None else frac + term
        return torch.floor(frac).to(torch.int64)

    def __call__(self, x_q, x_p, plain: bool = False):
        """x_q: (..., L, n), x_p: (..., |P|, n) → (..., L, n)."""
        xp2 = _u.addmod(x_p, self.half_p, self.p_q)
        y = self.conv.decompose(xp2)
        conv = self.conv.convert(y, plain)
        num = _u.submod(_u.addmod(x_q, self.half_q, self.dst_q), conv, self.dst_q)
        out = self.word.mont_mul(num, self.pinv_mont, self.dst_q, self.dst_pinv)
        v = self.overflow(y)[..., None, :]
        return _u.addmod(out, v, self.dst_q)


class KeySwitcher:
    """Per-parameter key-switch engine for one word; per-level constants are
    cached."""

    def __init__(self, q_moduli: tuple[int, ...], p_moduli: tuple[int, ...], n: int, device,
                 word_bits: int = 32):
        self.q_moduli = tuple(int(q) for q in q_moduli)
        self.p_moduli = tuple(int(p) for p in p_moduli)
        self.n = n
        self.device = torch.device(device)
        self.word_bits = word_bits
        self.word = _u.word(word_bits)
        self.alpha = len(self.p_moduli)
        self._pre: dict[int, tuple] = {}

    def beta(self, level: int) -> int:
        return (level + 1 + self.alpha - 1) // self.alpha

    def ring_qp(self, level: int):
        """The ring of Q_ℓ ∪ P on this switcher's word."""
        return get_rns_ring(self.q_moduli[:level + 1] + self.p_moduli, self.n, self.device,
                            self.word_bits)

    def _level_pre(self, level: int):
        """Digit-decomposition constants for one level: qhat_inv/shoup and
        src_q (β, α, 1) — zero / one in the padded lanes of a ragged last
        digit, so those lanes stay zero — and qhat_conv (β, T, α) with
        T = L + |P|."""
        pre = self._pre.get(level)
        if pre is not None:
            return pre
        observability.table_built('KeySwitcher._level_pre')
        L = level + 1
        alpha, beta, wb = self.alpha, self.beta(level), self.word_bits
        q = self.q_moduli[:L]
        qp = q + self.p_moduli
        T = len(qp)
        qhat_inv = torch.zeros((beta, alpha, 1), dtype=torch.int64)
        qhat_inv_shoup = torch.zeros((beta, alpha, 1), dtype=torch.int64)
        src_q = torch.ones((beta, alpha, 1), dtype=torch.int64)
        qhat_conv = torch.zeros((beta, T, alpha), dtype=torch.int64)
        for d in range(beta):
            grp = q[d * alpha:(d + 1) * alpha]
            Qd = math.prod(grp)
            for j, qi in enumerate(grp):
                h = Qd // qi
                hinv = pow(h, -1, qi)
                qhat_inv[d, j, 0] = hinv
                qhat_inv_shoup[d, j, 0] = _u.to_s64(_shoup(hinv, qi, wb))
                src_q[d, j, 0] = qi
                for t, dt in enumerate(qp):
                    qhat_conv[d, t, j] = _u.to_s64(_mont(h % dt, dt, wb))
        dev = self.device
        pre = (self.ring_qp(level), qhat_inv.to(dev), qhat_inv_shoup.to(dev),
               src_q.to(dev), qhat_conv.to(dev), RoundDivP(q, self.p_moduli, dev, wb))
        self._pre[level] = pre
        return pre

    def decompose_modup_ntt(self, x, level: int, plain: bool = False):
        """Digit-decompose + mod-up + NTT: x (..., L, n) coefficient domain →
        (..., β, T, n) in the NTT domain over Q_ℓ∪P. The forward NTT is
        kernel B1 or B5 on a CUDA tensor, and at the 64-bit word the mod-up
        is one launch of kernel B6 over all β digits; ``plain`` runs the
        plain twins throughout."""
        ring_qp, qhat_inv, qhat_inv_shoup, src_q, qhat_conv, _ = self._level_pre(level)
        L = level + 1
        alpha, beta = self.alpha, self.beta(level)
        pad = beta * alpha - L
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        xg = x.reshape(*x.shape[:-2], beta, alpha, self.n)
        with _stage('ksw.modup', plain):
            y = self.word.shoup_mul(xg, qhat_inv, qhat_inv_shoup, src_q)
            qp, qp_pinv = ring_qp.q, ring_qp.pinv
            if self.word_bits == 64:
                # grouped FastBConv: digit d's (T, α) constants on its α limbs
                modup = bconv64_plain if plain else bconv64_raw
                xd = modup(y, qhat_conv, qp, qp_pinv)
            else:
                # grouped FastBConv, one digit limb at a time: Σ_j y_j·[Q_d/q_j]_{t}
                acc = None
                for j in range(alpha):
                    term = _u.mont_mul(y[..., :, j:j + 1, :], qhat_conv[:, :, j:j + 1], qp,
                                       qp_pinv)
                    acc = term if acc is None else acc + term
                xd = torch.remainder(acc, qp)
        with _stage('ksw.ntt', plain):
            return (ntt_mod.ntt_plain if plain else ntt_mod.ntt)(xd, ring_qp)

    def inner_product(self, digits_ntt, ksk, level: int, plain: bool = False):
        """Σ_d digit_d ⊙ key_d over Q_ℓ∪P (NTT domain) → (..., 2, T, n).

        digits_ntt: (..., β, T, n); keys in NTT+Montgomery form. At the
        64-bit word this is kernel B7 (its plain twin with ``plain``)."""
        ring_qp = self._level_pre(level)[0]
        if self.word_bits == 64:
            return (ksw_inner64_plain if plain else ksw_inner64)(digits_ntt, ksk, level, ring_qp)
        L = level + 1
        beta = self.beta(level)
        kd = torch.cat([ksk.key_q[:beta, :, :L], ksk.key_p[:beta]], dim=2)   # (β, 2, T, n)
        acc = None
        for d in range(beta):
            term = _u.mont_mul(digits_ntt[..., d:d + 1, :, :], kd[d], ring_qp.q, ring_qp.pinv)
            acc = term if acc is None else acc + term
        return torch.remainder(acc, ring_qp.q)

    def switch_from_digits(self, digits, ksk, level: int, output_ntt: bool = False,
                           plain: bool = False):
        """Gadget product + mod-down from NTT-domain digits (..., β, T, n).
        Both key components go through one INTT of the (..., 2, T, n) stack."""
        pre = self._level_pre(level)
        ring_qp, round_div = pre[0], pre[5]
        L = level + 1
        ntt, intt = ((ntt_mod.ntt_plain, ntt_mod.intt_plain) if plain
                     else (ntt_mod.ntt, ntt_mod.intt))
        with _stage('ksw.inner', plain):
            c = self.inner_product(digits, ksk, level, plain)
        with _stage('ksw.intt', plain):
            c = intt(c, ring_qp)
        with _stage('ksw.moddown', plain):
            e = round_div(c[..., :L, :], c[..., L:, :], plain)              # (..., 2, L, n)
        if output_ntt:
            with _stage('ksw.output_ntt', plain):
                e = ntt(e, get_rns_ring(self.q_moduli[:L], self.n, self.device, self.word_bits))
        return e[..., 0, :, :], e[..., 1, :, :]

    def switch(self, x, ksk, level: int, output_ntt: bool = False):
        """Full key switch of coefficient-domain x (..., L, n) → (e0, e1) over
        Q_ℓ: kernel B3 at the 32-bit word; at the 64-bit word kernels B6, B5,
        B7, B5 and B6 in turn. A CPU tensor takes each kernel's plain twin.
        Its span carries the word, the route ('fused' or 'cluster' for B3,
        'plain' for B3's twin on a CPU tensor, 'staged' at the 64-bit word),
        L, α, β and G, the polynomials switched at once."""
        with span('ksw.switch') as sp:
            if sp:
                sp.attrs.update(
                    word=self.word_bits, L=level + 1, alpha=self.alpha, beta=self.beta(level),
                    G=x.numel() // ((level + 1) * self.n),
                    route=('staged' if self.word_bits == 64 else
                           switch_route(self.n) if x.is_cuda else 'plain'))
            if self.word_bits == 32:
                return ksw_switch32(x, ksk, self, level, output_ntt)
            digits = self.decompose_modup_ntt(x, level)
            return self.switch_from_digits(digits, ksk, level, output_ntt)

    def switch_plain(self, x, ksk, level: int, output_ntt: bool = False):
        """The plain composition of ``switch`` (the kernels' twin), plain
        PyTorch throughout, its NTTs included, on any device."""
        digits = self.decompose_modup_ntt(x, level, plain=True)
        return self.switch_from_digits(digits, ksk, level, output_ntt, plain=True)
