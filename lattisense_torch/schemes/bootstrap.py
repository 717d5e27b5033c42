"""CKKS bootstrapping: ModRaise → CoeffsToSlots → EvalMod → SlotsToCoeffs.

Port of ``lattisense_tpu/schemes/bootstrap.py`` (after the reference SDK's
CkksBtpContext::bootstrap, fhe_ops_lib/fhe_lib_v2.h:1173-1217) to the port's
engine: the engine methods take tensors, leading batch dimensions are
batches, and the host-side encoding of the transforms' diagonals is NumPy
float64, encoded once per (level, scale) and kept on the device.

Value algebra (dense packing, slots s = n/2, folded u_c = m_c + i·m_{c+s}):

1. ModRaise: centred lift of the base-level ciphertext to the full chain; it
   then encrypts u = m + Q0·I with |I| ≲ K (sparse secret, weight h). Q0 is
   q0, or on the 32-bit word the composite q0·q1 (two limbs a level), lifted
   by an exact CRT in 64-bit Montgomery arithmetic on the device.
2. CoeffsToSlots: inverse special-FFT stages post-scaled so the slots hold
   y_j = u_j/(2K·Q0·2^r) in bit-reversed order; a conjugation splits the
   real and imaginary coefficient halves.
3. EvalMod: a Chebyshev series of cos(2π(2K·2^r·y − 0.25)/2^r), then r
   double-angle squarings: the slots become sin(2π·u/Q0) ≈ 2π·m/Q0. The two
   halves run as one call on a batch of two.
4. SlotsToCoeffs: forward stages post-scaled by Q0/(2π·Δ) return the values
   to the coefficients; the result decodes to the original message.

Every NTT, key switch and base conversion on the way is one of the port's
kernels on a CUDA tensor (B1 and B3 at the 32-bit word; B5, B6 and B7 at
the 64-bit word); the rest is plain PyTorch on the engine's device. The
scales are host floats, set exactly as the reference sets them.
"""

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from .bootstrap_params import find_best_bsgs_split
from .galois import galois_elt_col, galois_elt_row
from .linear_transform import EncodedLinearTransform
from .poly_eval import ChebyshevEvaluator, chebyshev_interpolate
from .special_fft import cts_matrices, stc_matrices
from .types import Ciphertext

_log = logging.getLogger(__name__)


@dataclass
class BootstrapConfig:
    """EvalMod and DFT-depth configuration (the reference's CkksBtpParameter
    fields btp_cts_depth, btp_stc_depth, btp_eval_mod_*)."""

    cts_depth: int = 3
    stc_depth: int = 3
    k: int = 16                    # covers |I + m/q0| < K
    sine_deg: int = 30
    double_angle: int = 3
    bsgs_ratio: float = 2.0
    em_scale: float | None = None  # EvalMod working scale; the level primes' product by default
    message_ratio: float = 256.0   # the message is scaled to q0/message_ratio before ModRaise
    limbs_per_level: int | None = None
    # limbs one multiplicative level consumes: None gives 1 on the 64-bit
    # word and 2 on the 32-bit word (a working scale near 2^62 spans a pair
    # of 31-bit primes, every rescale drops two limbs, and ModRaise lifts
    # from the composite base q0·q1)
    arcsine: bool = False          # a deg-3 arcsine correction after EvalMod (2 more levels)


class CkksBootstrapper:
    """The per-context precompute and the bootstrap itself."""

    def __init__(self, engine, config: BootstrapConfig | None = None):
        self.engine = engine
        self.cfg = config or BootstrapConfig()
        p = engine.params
        cfg = self.cfg
        s = p.slots
        # sparse packing replicates the message R times over the ring slots;
        # the transforms shrink to size s at the cost of a SubSum projection
        self.repl = (p.n // 2) // s
        self.step = int(cfg.limbs_per_level or (2 if engine.word_bits == 32 else 1))
        st = self.step
        # the ModRaise base: one prime, or the composite q0·q1 for pairs
        self.q0_int = 1
        for j in range(st):
            self.q0_int *= int(p.q[j])
        self.q0 = float(self.q0_int)
        self.scale = p.scale
        L = p.max_level

        em_default = 1.0
        for j in range(st, 2 * st):
            em_default *= float(p.q[j])
        self.em_scale = float(cfg.em_scale or em_default)

        # the split must be the frontend's, whose key prediction a compiled
        # task's signature registers
        def split(g):
            return find_best_bsgs_split({o: True for o in g}, s, cfg.bsgs_ratio)

        # the working message scale inside the pipeline: q0/message_ratio
        self.c_int = max(1, int(round(self.q0 / (cfg.message_ratio * self.scale))))
        self.scale_eff = self.scale * self.c_int

        # folded into CoeffsToSlots (no extra level): the SubSum gain 1/R,
        # the EvalMod domain map 2^{r+1} and the 0.5 / -0.5i of the
        # real/imaginary split (two variants of the last group, closed by a
        # conjugation and an add)
        post_cts = (self.scale_eff * 2 ** (cfg.double_angle + 1)
                    / (2.0 * cfg.k * self.q0 * 2 ** cfg.double_angle * self.repl))
        groups = cts_matrices(s, cfg.cts_depth, post_scale=post_cts)
        self.cts = [EncodedLinearTransform(engine, g, L, split(g), limb_step=st)
                    for g in groups[:-1]]
        last = groups[-1]
        self.cts_last_re = EncodedLinearTransform(
            engine, {o: v * 0.5 for o, v in last.items()}, L, split(last),
            out_scale_target=self.em_scale, limb_step=st)
        self.cts_last_im = EncodedLinearTransform(
            engine, {o: v * -0.5j for o, v in last.items()}, L, split(last),
            out_scale_target=self.em_scale, limb_step=st)
        post_stc = self.q0 / (2.0 * np.pi * self.scale_eff)
        self.stc = [EncodedLinearTransform(engine, g, L, split(g), limb_step=st)
                    for g in stc_matrices(s, cfg.stc_depth, post_scale=post_stc)]

        # the EvalMod series; its operand arrives normalized to [-1, 1]
        K2r = 2.0 * cfg.k * 2 ** cfg.double_angle
        r = cfg.double_angle

        def f(y):
            return np.cos(2 * np.pi * (K2r * y - 0.25) / 2 ** r)

        a = 1.0 / 2 ** (r + 1)
        coeffs = chebyshev_interpolate(f, -a, a, cfg.sine_deg)
        # a degree too low for K leaves a systematic error that
        # SlotsToCoeffs amplifies up to n/2: check the fit on a grid
        grid = np.linspace(-a, a, 512)
        fit = np.polynomial.chebyshev.chebval(grid / a, coeffs)
        resid = float(np.max(np.abs(fit - f(grid))))
        if resid > 1e-9:
            _log.warning('EvalMod sine fit residual %.1e at sine_deg=%d, k=%d: raise sine_deg '
                         '(the truncation error is systematic and SlotsToCoeffs amplifies it '
                         'up to n/2)', resid, cfg.sine_deg, cfg.k)
        self.evalmod = ChebyshevEvaluator(engine, coeffs, -1.0, 1.0, pre_normalized=True,
                                          limb_step=st)
        # steer CoeffsToSlots' output onto the evaluator's planned entry scale
        entry_level = L - cfg.cts_depth * st
        self.em_entry_scale = self.evalmod.planned_scale(entry_level, self.em_scale)
        self.cts_last_re.out_scale_target = self.em_entry_scale
        self.cts_last_im.out_scale_target = self.em_entry_scale

        # ModRaise's device constants, made once a ring (a captured CUDA graph
        # reads them in place)
        self._q0_mod: dict = {}
        self._scale_up: dict = {}
        self._complex_pt: dict = {}

    # ------------------------------------------------------------------
    def galois_elements(self) -> list[int]:
        p = self.engine.params
        elts = {galois_elt_row(p.n)}
        for lt in self.cts + [self.cts_last_re, self.cts_last_im] + self.stc:
            elts.update(lt.galois_elements())
        step = p.slots
        while step < p.n // 2:                   # SubSum rotations (sparse)
            elts.add(galois_elt_col(step, p.n))
            step <<= 1
        return sorted(elts)

    def min_levels(self) -> int:
        """The limbs a bootstrap consumes, roughly (each level ``step`` limbs)."""
        cfg = self.cfg
        em = (len(self.evalmod.coeffs) - 1).bit_length() + 2
        arc = 2 if cfg.arcsine else 0
        return self.step * (cfg.cts_depth + 1 + em + cfg.double_angle + arc + 1 + cfg.stc_depth)

    # ------------------------------------------------------------------
    def _qstep(self, level: int) -> float:
        out = 1.0
        for j in range(level - self.step + 1, level + 1):
            out *= float(self.engine.q[j])
        return out

    def _rescale_n(self, ct):
        for _ in range(self.step):
            ct = self.engine.rescale(ct)
        return ct

    # ------------------------------------------------------------------
    def mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Base level (``step`` - 1) → the full chain by the centred lift of
        the coefficients mod the (possibly composite) base Q0 = Π q_{<step}."""
        eng = self.engine
        p = eng.params
        ring_b = eng.ring(self.step - 1)
        ring_l = eng.ring(p.max_level)
        coeffs = ntt_mod.intt(ct.data.contiguous(), ring_b)     # (..., 2, step, n) mod q_j
        coeffs = eng.whole_limbs(coeffs, self.step - 1)
        Q0 = self.q0_int
        if self.step == 1:
            v = coeffs[..., 0, :]
        else:
            # the CRT of v mod Q0, exact in 64-bit Montgomery arithmetic
            # (Q0 < 2^62 is odd)
            pinv = _u.to_s64((-pow(Q0, -1, 1 << 64)) % (1 << 64))
            r2 = pow(1 << 64, 2, Q0)
            v = None
            for j in range(self.step):
                qj = int(eng.q[j])
                cj = (Q0 // qj) * pow(Q0 // qj, -1, qj) % Q0
                term = _u.mulmod64(coeffs[..., j, :], cj, Q0, pinv, r2)
                v = term if v is None else _u.addmod(v, term, Q0)
        qs = ring_l.q                                  # (L+1, 1)
        key = (ring_l.moduli, qs.device)
        q0_mod = self._q0_mod.get(key)
        if q0_mod is None:
            q0_mod = self._q0_mod[key] = torch.remainder(torch.full_like(qs, Q0), qs)
        vm = torch.remainder(v.unsqueeze(-2), qs)
        neg = torch.remainder(vm + qs - q0_mod, qs)
        lifted = torch.where((v > Q0 // 2).unsqueeze(-2), neg, vm)
        data = ntt_mod.ntt(lifted.contiguous(), ring_l)
        return Ciphertext(data=data, level=p.max_level, is_ntt=True, scale=ct.scale)

    def _mul_const_complex(self, ct, value, target_scale=None):
        """Constant product landing at ``target_scale`` (by default keeping
        ct.scale), by steering the plaintext's scale."""
        eng = self.engine
        target = target_scale or ct.scale
        pt_scale = target * self._qstep(ct.level) / ct.scale
        if complex(value).imag == 0.0:
            pt = eng.encode_const(complex(value).real, ct.level, pt_scale)
        else:
            key = (complex(value), ct.level, pt_scale)
            pt = self._complex_pt.get(key)
            if pt is None:
                pt = self._complex_pt[key] = eng.encode(np.full(eng.params.slots, value),
                                                        ct.level, pt_scale)
        out = self._rescale_n(eng.mult(ct, pt))
        out.scale = target
        return out

    def _conj(self, ct, glk_map):
        elt = galois_elt_row(self.engine.params.n)
        return self.engine.apply_galois(ct, elt, glk_map[elt])

    def _double_angle(self, ct, rlk):
        eng = self.engine
        sq = self._rescale_n(eng.relinearize(eng.mult(ct, ct), rlk))
        two = eng.add(sq, sq)
        pt = eng.encode_const(-1.0, two.level, two.scale)
        return eng.add(two, pt)

    def _arcsine(self, ct, rlk):
        """Slots hold v = sin(2πε) after the doublings; return
        v + v³/6 ≈ arcsin(v) = 2πε. Costs two levels (v², v³); the division
        by 6 is a change of the declared scale."""
        eng = self.engine
        st = self.step
        v2 = self._rescale_n(eng.relinearize(eng.mult(ct, ct), rlk))
        vd = eng.drop_level(ct, st)
        v3 = self._rescale_n(eng.relinearize(eng.mult(v2, vd), rlk))
        v3.scale *= 6.0                      # decodes as v³/6
        base = self._mul_const_complex(eng.drop_level(ct, st), 1.0, target_scale=v3.scale)
        return eng.add(v3, base)

    def _check_input_snr(self, ct):
        """Warn once when the input's own noise bounds the output precision
        (err ≈ c·n·σ/scale): bootstrap-bound data wants a higher scale."""
        if getattr(self, '_snr_warned', False):
            return
        n = self.engine.params.n
        floor = 2.0 * n * 3.2 / float(ct.scale)
        if floor > 1e-5:
            self._snr_warned = True
            _log.warning('bootstrap input scale %.1e caps output precision at ~%.0e '
                         '(input-SNR bound ~ n*sigma/scale); encode bootstrap-bound '
                         'ciphertexts at a higher scale (e.g. 2^40)', ct.scale, floor)

    # ------------------------------------------------------------------
    def segments(self, caller_scale: float, swk_dts=None, swk_std=None):
        """The bootstrap as a list of (name, fn) with
        fn(cts: tuple[Ciphertext, ...], rlk, glk_map) → tuple; folding them
        in order is bit-identical to ``__call__``. A task's partitioned run
        captures each as a CUDA graph of its own."""
        eng = self.engine

        def s_raise(cts, rlk, glk_map):
            ct, = cts
            # a level-free integer scale-up to the working scale; c_int
            # follows the actual input scale, the last steer returns to the
            # caller's scale
            c_int = max(1, int(round(self.scale_eff / ct.scale)))
            if c_int > 1:
                ring_b = eng.ring(self.step - 1)
                cm = self._scale_up.get(c_int)
                if cm is None:
                    cm = self._scale_up[c_int] = eng.mont_col(c_int, self.step - 1)
                ct = Ciphertext(data=ring_b.word.mont_mul(ct.data, cm, ring_b.q, ring_b.pinv),
                                level=self.step - 1, is_ntt=ct.is_ntt, scale=ct.scale * c_int)
            ct.scale = self.scale_eff
            if swk_dts is not None:
                ct = eng.key_switch(ct, swk_dts)
            t = self.mod_raise(ct)
            if swk_std is not None:
                t = eng.key_switch(t, swk_std)
            # sparse packing: SubSum projects onto the replicated subspace
            p = eng.params
            step = p.slots
            while step < p.n // 2:
                elt = galois_elt_col(step, p.n)
                t = eng.add(t, eng.apply_galois(t, elt, glk_map[elt]))
                step <<= 1
            return (t,)

        segs = [('raise', s_raise)]

        # CoeffsToSlots → y in bit-reversed order; the real/imaginary split
        # is the two last-group variants and a conjugation each
        for i, lt in enumerate(self.cts):
            def s_cts(cts, rlk, glk_map, lt=lt):
                t, = cts
                return (self._rescale_n(lt(t, glk_map)),)
            segs.append((f'cts{i}', s_cts))

        def s_split_re(cts, rlk, glk_map):
            t, = cts
            ta = self._rescale_n(self.cts_last_re(t, glk_map))
            ta.scale = self.em_entry_scale
            t0 = eng.add(ta, self._conj(ta, glk_map))
            return (t0, t)
        segs.append(('split_re', s_split_re))

        def s_split_im(cts, rlk, glk_map):
            t0, t = cts
            tb = self._rescale_n(self.cts_last_im(t, glk_map))
            tb.scale = self.em_entry_scale
            t1 = eng.add(tb, self._conj(tb, glk_map))
            return (t0, t1)
        segs.append(('split_im', s_split_im))

        # The two EvalMod halves share their level and scale metadata, so
        # they run as one call on a batch of two (a leading dimension of
        # size 2 stacked in front of the ciphertexts' own); every engine op
        # treats a leading dimension as a batch, so each half equals its
        # own run bit for bit.
        def _em_pair(stage_fn):
            def seg(cts, rlk, glk_map):
                c0, c1 = cts
                c = stage_fn(Ciphertext(data=torch.stack([c0.data, c1.data]), level=c0.level,
                                        is_ntt=c0.is_ntt, scale=c0.scale), rlk)
                return (Ciphertext(data=c.data[0], level=c.level, is_ntt=c.is_ntt,
                                   scale=c.scale),
                        Ciphertext(data=c.data[1], level=c.level, is_ntt=c.is_ntt,
                                   scale=c.scale))
            return seg

        # the list-valued twin for the staged Chebyshev evaluation:
        # boundaries carry (re_0..re_{k-1}, im_0..im_{k-1}), the halves'
        # metadata equal position by position
        def _em_pair_list(stage_fn):
            def seg(cts, rlk, glk_map):
                half = len(cts) // 2
                res, ims = cts[:half], cts[half:]
                stacked = [Ciphertext(data=torch.stack([r.data, i.data]), level=r.level,
                                      is_ntt=r.is_ntt, scale=r.scale)
                           for r, i in zip(res, ims)]
                outs = stage_fn(stacked, rlk)
                return tuple(Ciphertext(data=c.data[k], level=c.level, is_ntt=c.is_ntt,
                                        scale=c.scale) for k in (0, 1) for c in outs)
            return seg

        def st_da(c, rlk):
            for _ in range(self.cfg.double_angle):
                c = self._double_angle(c, rlk)
            return c

        for suffix, st in self.evalmod.stages(self.em_scale):
            segs.append((f'evalmod_{suffix}', _em_pair_list(st)))
        if self.cfg.double_angle:
            segs.append(('evalmod_da', _em_pair(st_da)))
        if self.cfg.arcsine:
            segs.append(('evalmod_asin', _em_pair(self._arcsine)))

        def s_merge(cts, rlk, glk_map):
            g0, g1 = cts
            g1i = self._mul_const_complex(g1, 1j)
            if g0.level > g1i.level:
                g0 = eng.drop_level(g0, g0.level - g1i.level)
            g0.scale = g1i.scale
            return (eng.add(g0, g1i),)
        segs.append(('merge', s_merge))

        for i, lt in enumerate(self.stc):
            def s_stc(cts, rlk, glk_map, lt=lt):
                t, = cts
                return (self._rescale_n(lt(t, glk_map)),)
            segs.append((f'stc{i}', s_stc))

        def s_steer(cts, rlk, glk_map):
            t, = cts
            # land on the caller's scale (the reference restores the input
            # scale, mega_ag_executors_cpu.cpp:460-463)
            if abs(t.scale - caller_scale) / caller_scale > 1e-9:
                t = self._mul_const_complex(t, 1.0, target_scale=caller_scale)
            return (t,)
        segs.append(('steer', s_steer))
        return segs

    def prepare(self, ct: Ciphertext) -> Ciphertext:
        """The input as the first segment takes it: its noise checked
        (``_check_input_snr``) and dropped to the base level ``step - 1``.
        Every fold of ``segments`` starts here."""
        self._check_input_snr(ct)
        base = self.step - 1
        if ct.level != base:
            ct = self.engine.drop_level(ct, ct.level - base)
        return ct

    def __call__(self, ct: Ciphertext, rlk, glk_map, swk_dts=None, swk_std=None) -> Ciphertext:
        """With ``swk_dts`` / ``swk_std`` (the two-secret design): switch onto
        the sparse bootstrapping secret for the ModRaise (small |I|), then
        back to the dense secret before the linear transforms."""
        ct = self.prepare(ct)
        cts = (ct,)
        for _name, fn in self.segments(ct.scale, swk_dts, swk_std):
            cts = fn(cts, rlk, glk_map)
        out, = cts
        return out
