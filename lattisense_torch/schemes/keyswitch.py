"""Hybrid RNS key switching (GHS / Lattigo-style gadget product) on tensors.

Port of ``lattisense_tpu/schemes/keyswitch.py`` at word_bits=32.
switch(x, ksk) for x ∈ R_{Q_ℓ} (coefficient domain) computes (e0, e1) with
e0 + e1·s ≈ x·s' by:

1. digit-decomposing x into β = ceil((ℓ+1)/α) groups of α = |P| limbs,
2. mod-up of each digit to Q_ℓ ∪ P (FastBConv),
3. NTT, inner product with the Montgomery-form key digits, accumulate,
4. INTT and divide-and-round by P (``RoundDivP``).

``switch`` is kernel B3 (``ops/ksw_cuda.py`` ``ksw_switch32``) on a CUDA
tensor; ``switch_plain`` is the plain composition above, B3's twin, which a
CPU tensor runs. ``decompose_modup_ntt`` and ``switch_from_digits`` stay
plain PyTorch around kernel B1: the hoisted rotations call them apart.
Leading batch dimensions pass through every step.
"""

import math

import torch

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..core.rns import BasisConv, _col, _mont, _pinv, _shoup
from ..ops.ksw_cuda import ksw_switch32


class RoundDivP:
    """c' = round(c / P): exact mod-down Q_ℓ∪P → Q_ℓ, with the reference's
    overflow correction: the FastBConv of the P part overflows by v·P,
    v = floor(Σ_j y_j/p_j), which is estimated in 32-bit-word fixed point
    (Σ_j y_j·floor(2^62/p_j)) >> 62 and added back."""

    def __init__(self, q_moduli: tuple[int, ...], p_moduli: tuple[int, ...], device):
        P = math.prod(p_moduli)
        half = P // 2
        self.conv = BasisConv(p_moduli, q_moduli, device)
        self.p_q = _col(p_moduli, device)
        self.dst_q = _col(q_moduli, device)
        self.dst_pinv = _col([_pinv(q) for q in q_moduli], device)
        self.half_p = _col([half % p for p in p_moduli], device)
        self.half_q = _col([half % q for q in q_moduli], device)
        self.pinv_mont = _col([_mont(pow(P % q, -1, q), q) for q in q_moduli], device)
        self.p_inv_fx = _col([(1 << 62) // p for p in p_moduli], device)

    def overflow(self, y):
        """v = floor(Σ_j y_j/p_j) for decomposed digits y (..., |P|, n).

        Each term y_j·floor(2^62/p_j) is below 2^62, but their sum may pass
        2^63 (α = 4 comes close to 2^64): the int64 sum then wraps, keeping
        the low 64 bits of the reference's uint64 sum, whose top two bits are
        (sum >> 62) & 3."""
        acc = (y * self.p_inv_fx).sum(dim=-2)
        return (acc >> 62) & 3

    def __call__(self, x_q, x_p):
        """x_q: (..., L, n), x_p: (..., |P|, n) → (..., L, n)."""
        xp2 = _u.addmod(x_p, self.half_p, self.p_q)
        y = self.conv.decompose(xp2)
        conv = self.conv.convert(y)
        num = _u.submod(_u.addmod(x_q, self.half_q, self.dst_q), conv, self.dst_q)
        out = _u.mont_mul(num, self.pinv_mont, self.dst_q, self.dst_pinv)
        v = self.overflow(y)[..., None, :]
        return _u.addmod(out, v, self.dst_q)


class KeySwitcher:
    """Per-parameter key-switch engine; per-level constants are cached."""

    def __init__(self, q_moduli: tuple[int, ...], p_moduli: tuple[int, ...], n: int, device):
        self.q_moduli = tuple(int(q) for q in q_moduli)
        self.p_moduli = tuple(int(p) for p in p_moduli)
        self.n = n
        self.device = torch.device(device)
        self.alpha = len(self.p_moduli)
        self._pre: dict[int, tuple] = {}

    def beta(self, level: int) -> int:
        return (level + 1 + self.alpha - 1) // self.alpha

    def _level_pre(self, level: int):
        """Digit-decomposition constants for one level: qhat_inv/shoup and
        src_q (β, α, 1) — zero / one in the padded lanes of a ragged last
        digit, so those lanes stay zero — and qhat_conv (β, T, α) with
        T = L + |P|."""
        pre = self._pre.get(level)
        if pre is not None:
            return pre
        L = level + 1
        alpha, beta = self.alpha, self.beta(level)
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
                qhat_inv_shoup[d, j, 0] = _shoup(hinv, qi)
                src_q[d, j, 0] = qi
                for t, dt in enumerate(qp):
                    qhat_conv[d, t, j] = _mont(h % dt, dt)
        dev = self.device
        pre = (get_rns_ring(qp, self.n, dev), qhat_inv.to(dev), qhat_inv_shoup.to(dev),
               src_q.to(dev), qhat_conv.to(dev), RoundDivP(q, self.p_moduli, dev))
        self._pre[level] = pre
        return pre

    def decompose_modup_ntt(self, x, level: int, ntt=ntt_mod.ntt):
        """Digit-decompose + mod-up + NTT: x (..., L, n) coefficient domain →
        (..., β, T, n) in the NTT domain over Q_ℓ∪P. ``ntt`` is the forward
        transform used (kernel B1 on a CUDA tensor by default)."""
        ring_qp, qhat_inv, qhat_inv_shoup, src_q, qhat_conv, _ = self._level_pre(level)
        L = level + 1
        alpha, beta = self.alpha, self.beta(level)
        pad = beta * alpha - L
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        xg = x.reshape(*x.shape[:-2], beta, alpha, self.n)
        y = _u.shoup_mul(xg, qhat_inv, qhat_inv_shoup, src_q)
        # grouped FastBConv, one digit limb at a time: Σ_j y_j·[Q_d/q_j]_{t}
        qp, qp_pinv = ring_qp.q, ring_qp.pinv
        acc = None
        for j in range(alpha):
            term = _u.mont_mul(y[..., :, j:j + 1, :], qhat_conv[:, :, j:j + 1], qp, qp_pinv)
            acc = term if acc is None else acc + term
        return ntt(torch.remainder(acc, qp), ring_qp)

    def inner_product(self, digits_ntt, ksk, level: int):
        """Σ_d digit_d ⊙ key_d over Q_ℓ∪P (NTT domain) → (..., 2, T, n).

        digits_ntt: (..., β, T, n); keys in NTT+Montgomery form."""
        ring_qp = self._level_pre(level)[0]
        L = level + 1
        beta = self.beta(level)
        kd = torch.cat([ksk.key_q[:beta, :, :L], ksk.key_p[:beta]], dim=2)   # (β, 2, T, n)
        acc = None
        for d in range(beta):
            term = _u.mont_mul(digits_ntt[..., d:d + 1, :, :], kd[d], ring_qp.q, ring_qp.pinv)
            acc = term if acc is None else acc + term
        return torch.remainder(acc, ring_qp.q)

    def switch_from_digits(self, digits, ksk, level: int, output_ntt: bool = False,
                           ntt=ntt_mod.ntt, intt=ntt_mod.intt):
        """Gadget product + mod-down from NTT-domain digits (..., β, T, n).
        Both key components go through one INTT of the (..., 2, T, n) stack."""
        pre = self._level_pre(level)
        ring_qp, round_div = pre[0], pre[5]
        L = level + 1
        c = intt(self.inner_product(digits, ksk, level), ring_qp)
        e = round_div(c[..., :L, :], c[..., L:, :])                       # (..., 2, L, n)
        if output_ntt:
            e = ntt(e, get_rns_ring(self.q_moduli[:L], self.n, self.device))
        return e[..., 0, :, :], e[..., 1, :, :]

    def switch(self, x, ksk, level: int, output_ntt: bool = False):
        """Full key switch of coefficient-domain x (..., L, n) → (e0, e1) over
        Q_ℓ: kernel B3 on a CUDA tensor, ``switch_plain`` on a CPU one."""
        return ksw_switch32(x, ksk, self, level, output_ntt)

    def switch_plain(self, x, ksk, level: int, output_ntt: bool = False):
        """The plain composition of ``switch`` (kernel B3's twin), plain
        PyTorch throughout, its NTTs included, on any device."""
        digits = self.decompose_modup_ntt(x, level, ntt=ntt_mod.ntt_plain)
        return self.switch_from_digits(digits, ksk, level, output_ntt,
                                       ntt=ntt_mod.ntt_plain, intt=ntt_mod.intt_plain)
