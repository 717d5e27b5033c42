"""Limb-sharded (digit-sharded) hybrid key switching over the mesh's ``limb`` axis.

Port of ``lattisense_tpu/parallel/keyswitch_sharded.py``: one key switch of
``KeySwitcher.switch`` split over D ranks.

- The β gadget digits are split over the ranks (β padded to a multiple of D
  with zero digits, which annihilate against zero keys): each rank computes
  its digit group's decomposition, FastBConv mod-up and NTT over Q_ℓ∪P with
  no communication, and its keys are its digit group's.
- The gadget inner product is then a partial sum on each rank; one
  ``psum_scatter`` over the T = L+|P| output limbs (T padded to a multiple of
  D) both reduces over the ranks and leaves each rank T/D rows. The int64 sum
  wraps modulo 2^64 as the JAX package's uint64 sum does; at the 64-bit word
  D·q reaches 2^63 for D = 4 and q near 2^61, so the fold of the ≤ D·q
  overflow compares unsigned (``u64.fold_sum``). At the 32-bit word int64
  carries D·q exactly: the JAX package's widening to uint64 has no
  counterpart here.
- Each rank's INTT runs over a ring of its own rows' moduli (padding rows
  repeat the last modulus: valid tables over zero data, discarded): on the
  card B1 or B5 (or the MXU route), never a plain twin.
- One small ``psum`` replicates the |P| special rows, then each rank
  mod-downs its own rows of Q_ℓ with a ``RoundDivP`` over those rows (B6 at
  the 64-bit word).

The JAX package leaves the result sharded over ``limb`` inside its jitted
program and gathers it when it is read; here the rows are all-gathered over
``limb`` at the end, so every entry returns the whole (e0, e1) over Q_ℓ on
every rank of the axis. Leading batch dimensions (a rank's ``op`` shard of a
batch) pass through every step. At the 64-bit word the mod-up is B6 and the
inner product B7, as in ``KeySwitcher``; at the 32-bit word they are plain
PyTorch (B3, which fuses the whole switch, has no sharded form).

Traffic a switch of G polynomials, per rank: psum_scatter 2·G·T_pad·n words
in, psum 2·G·|P|·n, all_gather 2·G·T_pad/D·n.
"""

import torch

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..ops.bconv_cuda import bconv64_raw
from ..ops.ksw64_cuda import ksw_inner64
from ..schemes.keyswitch import RoundDivP
from ..schemes.types import KeySwitchKey


def _pad_dim(x, dim: int, size: int):
    """x zero-padded at the end of ``dim`` to ``size``."""
    if x.shape[dim] >= size:
        return x
    dim %= x.dim()
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, size - x.shape[dim]]
    return torch.nn.functional.pad(x, pad)


def _pad_constant(x, size: int, fill: int):
    """x (β, ...) padded on its first axis to ``size`` with ``fill``."""
    if x.shape[0] >= size:
        return x
    tail = torch.full((size - x.shape[0], *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


class ShardedKeySwitcher:
    """Digit/limb-sharded twin of ``KeySwitcher.switch`` for one (mesh,
    level), on this rank's device."""

    def __init__(self, switcher, level: int, mesh, axis: str = 'limb',
                 coeff_axis: str | None = None):
        self.sw, self.level, self.mesh, self.axis = switcher, level, mesh, axis
        self.D = D = mesh.shape[axis]
        self.my = my = mesh.index(axis)
        self.L = L = level + 1
        n = switcher.n
        self.alpha = switcher.alpha
        self.beta = switcher.beta(level)
        self.beta_pad = -(-self.beta // D) * D
        self.bD = self.beta_pad // D
        self.wb = switcher.word_bits
        self.word = _u.word(self.wb)
        dev = mesh.device
        self.device = dev
        qp = switcher.q_moduli[:L] + switcher.p_moduli
        self.T = T = len(qp)
        self.T_pad = -(-T // D) * D
        self.rpd = rpd = self.T_pad // D
        # rows of the padded Q_ℓ∪P: padding rows repeat the last modulus
        padded = qp + (qp[-1],) * (self.T_pad - T)
        self.rows = padded[my * rpd:(my + 1) * rpd]
        # with a coefficient axis every polynomial is this rank's C = n/Dc
        # coefficients and the transforms are the distributed NTT's bodies
        self.coeff_axis = coeff_axis
        self.dntt = None
        if coeff_axis is not None:
            from .coeff_sharded import DistNtt
            self.dntt = DistNtt(padded, n, mesh, coeff_axis, self.wb)
            n = self.dntt.C
        self.n_loc = n
        self.ring_qp = get_rns_ring(qp, n, dev, self.wb)
        self.ring_rows = get_rns_ring(self.rows, n, dev, self.wb)
        # this rank's digit group's constants, zero digits past β
        _, qhat_inv, qhat_inv_shoup, src_q, qhat_conv, _ = switcher._level_pre(level)
        lo = my * self.bD

        def mine(t, fill):
            return _pad_constant(t.to(dev), self.beta_pad, fill)[lo:lo + self.bD].contiguous()
        self.qhat_inv = mine(qhat_inv, 0)
        self.qhat_inv_shoup = mine(qhat_inv_shoup, 0)
        self.src_q = mine(src_q, 1)
        self.qhat_conv = mine(qhat_conv, 0)
        # its rows of Q_ℓ, mod-downed here
        self.nq = max(0, min(rpd, L - my * rpd))
        self.round_div = (RoundDivP(self.rows[:self.nq], switcher.p_moduli, dev, self.wb)
                          if self.nq else None)

    def local(self, x):
        """This rank's coefficients of whole polynomials x (..., n)."""
        if self.dntt is None:
            return x
        C = self.n_loc
        return x.narrow(-1, self.mesh.index(self.coeff_axis) * C, C)

    def _fwd(self, xd):
        if self.dntt is None:
            return ntt_mod.ntt(xd, self.ring_qp)
        return self.dntt.fwd_body(xd, rows=(0, self.T))

    def _inv(self, acc):
        if self.dntt is None:
            return ntt_mod.intt(acc, self.ring_rows)
        return self.dntt.inv_body(acc, rows=(self.my * self.rpd, self.rpd))

    # ---- keys and digits in the sharded layout ---------------------------
    def pad_keys(self, key_q, key_p) -> KeySwitchKey:
        """(β, 2, Lq, n) / (β, 2, |P|, n) keys → this rank's digit group
        (β_pad/D digits, zero past β) as a contiguous KeySwitchKey."""
        lo = self.my * self.bD

        def mine(k):
            return _pad_constant(self.local(k[:self.beta]).to(self.device), self.beta_pad, 0)[
                lo:lo + self.bD].contiguous()
        return KeySwitchKey(key_q=mine(key_q[:, :, :self.L]), key_p=mine(key_p),
                            level=self.level, sp_level=self.alpha - 1)

    def pad_digits(self, digits):
        """(..., β, T, n) NTT-domain digits → this rank's group
        (..., β_pad/D, T, n), zero past β."""
        d = _pad_dim(digits, -3, self.beta_pad)
        return d.narrow(-3, self.my * self.bD, self.bD)

    # ---- the local steps ---------------------------------------------------
    def _local_digits(self, x):
        """Coefficient-domain x (..., L, n) → this rank's NTT-domain digits
        (..., β_pad/D, T, n)."""
        alpha, n = self.alpha, self.n_loc
        xg = _pad_dim(x, -2, self.beta_pad * alpha)
        xg = xg.reshape(*x.shape[:-2], self.beta_pad, alpha, n)
        xg = xg.narrow(-3, self.my * self.bD, self.bD)
        y = self.word.shoup_mul(xg, self.qhat_inv, self.qhat_inv_shoup, self.src_q)
        qp, qp_pinv = self.ring_qp.q, self.ring_qp.pinv
        if self.wb == 64:
            xd = bconv64_raw(y, self.qhat_conv, qp, qp_pinv)          # B6
        else:
            acc = None
            for j in range(alpha):
                term = _u.mont_mul(y[..., :, j:j + 1, :], self.qhat_conv[:, :, j:j + 1], qp,
                                   qp_pinv)
                acc = term if acc is None else acc + term
            xd = torch.remainder(acc, qp)
        return self._fwd(xd)

    def _inner(self, xd, kd: KeySwitchKey):
        """Σ over this rank's digits of digit ⊙ key → (..., 2, T, n)."""
        if self.wb == 64:
            return ksw_inner64(xd, kd, self.level, self.ring_qp)       # B7
        q, pinv = self.ring_qp.q, self.ring_qp.pinv
        keys = torch.cat([kd.key_q, kd.key_p], dim=2)                   # (bD, 2, T, n)
        acc = None
        for d in range(self.bD):
            term = _u.mont_mul(xd[..., d:d + 1, :, :], keys[d], q, pinv)
            acc = term if acc is None else acc + term
        return torch.remainder(acc, q)

    def _tail(self, xd, kd: KeySwitchKey):
        """Inner product, psum_scatter over the output rows, fold, INTT of
        this rank's rows, psum of the special rows, mod-down of its Q_ℓ rows,
        all_gather → (e0, e1) over Q_ℓ."""
        mesh, axis, rpd, L = self.mesh, self.axis, self.rpd, self.L
        acc = _pad_dim(self._inner(xd, kd), -2, self.T_pad)
        acc = mesh.psum_scatter(acc, axis, acc.dim() - 2)             # (..., 2, rpd, n)
        acc = _u.fold_sum(acc, self.ring_rows.q, self.D)
        c = self._inv(acc.contiguous())
        lead = c.shape[:-2]
        c_p = torch.zeros((*lead, self.alpha, self.n_loc), dtype=c.dtype, device=c.device)
        for a in range(self.alpha):
            owner, row = divmod(L + a, rpd)
            if owner == self.my:
                c_p[..., a, :] = c[..., row, :]
        c_p = mesh.psum(c_p, axis)
        e = torch.zeros_like(c)
        if self.nq:
            e[..., :self.nq, :] = self.round_div(c[..., :self.nq, :], c_p)
        e = mesh.all_gather(e, axis, e.dim() - 2)[..., :L, :]
        return e[..., 0, :, :], e[..., 1, :, :]

    # ---- entries -------------------------------------------------------------
    def traced(self, x, kd: KeySwitchKey):
        """Key switch of coefficient-domain x (..., L, n) with keys from
        ``pad_keys`` → (e0, e1) (..., L, n) over Q_ℓ, bit for bit
        ``KeySwitcher.switch``."""
        return self._tail(self._local_digits(x), kd)

    def __call__(self, x, key_q, key_p):
        """x (..., L, n) coefficient domain → (e0, e1) over Q_ℓ."""
        return self.traced(x, self.pad_keys(key_q, key_p))

    def traced_from_digits(self, digits, kd: KeySwitchKey):
        """Hoisted switch of this rank's digits (``pad_digits``), keys from
        ``pad_keys`` → (e0, e1) over Q_ℓ (coefficient domain)."""
        return self._tail(digits, kd)

    def switch_from_digits(self, digits, key_q, key_p):
        """Hoisted switch of the whole (..., β, T, n) NTT-domain digits
        (``KeySwitcher.decompose_modup_ntt``), bit for bit
        ``KeySwitcher.switch_from_digits``."""
        return self._tail(self.pad_digits(digits), self.pad_keys(key_q, key_p))
