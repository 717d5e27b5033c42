"""BFV scheme engine on tensors: encode/encrypt/decrypt and evaluation ops.

Port of ``lattisense_tpu/schemes/bfv.py`` for both machine words (the
parameter set's ``word_bits``). Multiplication is the integer-only BEHZ RNS
algorithm: exact-extend both ciphertexts Q_ℓ → B_ℓ ∪ m_sk, NTT tensor
product over Q_ℓ and the auxiliary basis, scale by t/Q_ℓ, exact
Shenoy–Kumaresan conversion back to Q_ℓ.

At the 32-bit word the extension and the forward NTTs are kernel B2, the
inverse NTTs and the scale-back kernel B4 (``ops/behz_cuda.py``); key
switching (relinearization, rotations) is kernel B3 (``ops/ksw_cuda.py``);
every NTT is kernel B1 (``ops/ntt_cuda.py``). At the 64-bit word the
multiply follows the reference's composition: every FastBConv (extension,
``scale_and_back``) is kernel B6 (``ops/bconv_cuda.py``), every NTT kernel
B5 (``ops/ntt64_cuda.py``) and key switching B6, B5 and B7
(``schemes/keyswitch.py``). At both words the NTT-domain tensor product is
kernel B8 (``ops/tensor_cuda.py``). The rest is plain PyTorch on the
engine's device.

Sampling runs on the host in NumPy; ``decrypt``'s CRT and rounding run in
machine words on the engine's device (``round_t_over_q``). The evaluation
ops take and return ``Ciphertext`` objects whose data may carry leading
batch dimensions.
"""

import math

import numpy as np
import torch

from .. import resolve_device
from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..core.rns import BasisConv, DivRoundLast, ExactExtend, ShenoyConvert, _col, _mont
from ..ops.behz_cuda import behz_finish32, behz_prep32
from ..ops.tensor_cuda import tensor_product_cuda as tensor_product
from ..params import BfvParams, bfv_aux_basis
from ..utils import observability
from ..utils.observability import span
from .encoding import bfv_decode_slots, bfv_encode_slots
from .galois import (apply_automorphism_coeff, apply_automorphism_ntt, galois_elt_col,
                     galois_elt_row)
from .keys import as_tensor, lift_to, sample_gaussian, sample_ternary, sample_uniform_rns
from .keyswitch import KeySwitcher
from .types import Ciphertext, DecomposedCiphertext, Plaintext, PlaintextMul, PlaintextRingt


def round_t_over_q(acc, ring, t: int):
    """round(t·X / Q) mod t, X in [0, Q) the CRT of the (L, n) residues
    ``acc`` over ``ring`` (Q the product of its moduli): the reference's
    ((2tX + Q) // 2Q) mod t, exactly, in 64-bit words on ``acc``'s device,
    for moduli below 2^62 and t below 2^31. Garner's mixed-radix digits v_j
    give X = Σ v_j q_0⋯q_{j-1}, each digit folded out of every later limb at
    once with the word's modular product; then S = floor(2t·X_j / P_j), X_j
    and P_j the first j digits and moduli, follows digit by digit,
    S ← floor((2t·v_j + S) / q_j) (a fraction below one added to an integer
    numerator never crosses a multiple of q_j), each quotient estimated in
    float64 (within one) and corrected by its remainder, exact mod 2^64; the
    rounding is floor((S + 1) / 2)."""
    moduli = [int(m) for m in ring.moduli]
    if max(moduli) >= 1 << 62 or not 1 < t < 1 << 31:
        raise ValueError('round_t_over_q takes moduli below 2^62 and t below 2^31')
    dev = acc.device
    u = acc.clone()
    for i in range(len(moduli) - 1):               # v_i = u[i]: fold it out of the rest
        rest = ring.q[i + 1:]
        inv = torch.tensor([pow(moduli[i], -1, m) for m in moduli[i + 1:]], dtype=torch.int64,
                           device=dev).reshape(-1, 1).expand_as(u[i + 1:])
        diff = _u.submod(u[i + 1:], u[i] % rest, rest)
        u[i + 1:] = ring.word.mulmod(diff, inv, rest, ring.pinv[i + 1:], ring.r2[i + 1:])
    s = torch.zeros_like(u[0])
    for j, qj in enumerate(moduli):
        num = 2 * t * u[j] + s                      # exact mod 2^64
        d = torch.floor(u[j].double() * (2 * t / qj) + s.double() / qj).long()
        r = num - d * qj                            # in [-q_j, 2 q_j)
        s = d - (r < 0).long() + (r >= qj).long()
    return (s + 1) // 2 % t


class BehzMult:
    """Per-level constants for BEHZ multiplication on one device."""

    def __init__(self, q: tuple[int, ...], aux: tuple[int, ...], m_sk: int,
                 t: int, n: int, device, word_bits: int = 32):
        wb = word_bits
        self.word_bits = wb
        self.word = _u.word(wb)
        Q = math.prod(q)
        # the shortest aux prefix whose product clears the tensor bound
        # 8·t·n·Q (Shenoy needs ω < B)
        b = []
        prod_b = 1
        for prime in aux:
            b.append(prime)
            prod_b *= prime
            if len(b) > len(q) and prod_b > 8 * t * n * Q:
                break
        b = tuple(b)
        if math.prod(b) <= 8 * t * n * Q:
            raise ValueError('BEHZ auxiliary basis too small')
        self.b_primes = b
        self.m_sk = m_sk
        self.t = t
        dst = b + (m_sk,)
        self.extend = ExactExtend(q, dst, device, wb)
        self.ring_q = get_rns_ring(q, n, device, wb)
        self.ring_aux = get_rns_ring(dst, n, device, wb)
        self.shenoy = ShenoyConvert(b, m_sk, q, device, wb)
        self.conv_q_to_aux = BasisConv(q, dst, device, wb)
        self.t_mont_q = _col([_mont(t % qi, qi, wb) for qi in q], device)
        self.t_mont_aux = _col([_mont(t % d, d, wb) for d in dst], device)
        self.qinv_mont_aux = _col([_mont(pow(Q % d, -1, d), d, wb) for d in dst], device)

    def scale_and_back(self, d_q, d_aux):
        """round-ish(t/Q · X) mod Q for X given over Q (d_q) and B∪m_sk (d_aux)."""
        rq, ra, mont_mul = self.ring_q, self.ring_aux, self.word.mont_mul
        u = mont_mul(d_q, self.t_mont_q, rq.q, rq.pinv)                  # [tX]_Q
        v = self.conv_q_to_aux(u)                                        # + α'Q
        td = mont_mul(d_aux, self.t_mont_aux, ra.q, ra.pinv)
        w = mont_mul(_u.submod(td, v, ra.q), self.qinv_mont_aux, ra.q, ra.pinv)
        return self.shenoy(w[..., :-1, :], w[..., -1, :])


class BfvEngine:
    """BFV engine for one parameter set on one device (CUDA by default)."""

    def __init__(self, params: BfvParams, device=None):
        self.params = params
        self.device = resolve_device(device)
        self.n = params.n
        self.t = params.t
        self.q = tuple(params.q)
        self.p = tuple(params.p)
        self.word_bits = params.word_bits
        self.aux, self.m_sk = bfv_aux_basis(params.n, self.q, self.p, self.word_bits)
        self.switcher = KeySwitcher(self.q, self.p, self.n, self.device, self.word_bits)
        self._behz: dict[int, BehzMult] = {}
        self._rescaler: dict[int, DivRoundLast] = {}
        self._delta_mont: dict = {}

    # ---- cached per-level helpers ----
    def ring(self, level: int):
        return get_rns_ring(self.q[:level + 1], self.n, self.device, self.word_bits)

    def behz(self, level: int) -> BehzMult:
        if level not in self._behz:
            observability.table_built('BfvEngine.behz')
            self._behz[level] = BehzMult(self.q[:level + 1], self.aux, self.m_sk, self.t,
                                         self.n, self.device, self.word_bits)
        return self._behz[level]

    def rescaler(self, level: int) -> DivRoundLast:
        if level not in self._rescaler:
            observability.table_built('BfvEngine.rescaler')
            self._rescaler[level] = DivRoundLast(self.q[:level + 1], self.device, self.word_bits)
        return self._rescaler[level]

    def delta_mont(self, level: int):
        """[Δ_ℓ]_{q_i} in Montgomery form, Δ_ℓ = floor(Q_ℓ/t), cached per
        level so that a captured CUDA graph copies nothing from the host."""
        if level not in self._delta_mont:
            delta = self.params.delta(level)
            self._delta_mont[level] = _col(
                [_mont(delta % qi, qi, self.word_bits) for qi in self.q[:level + 1]], self.device)
        return self._delta_mont[level]

    def _tensor(self, arr):
        return as_tensor(arr, self.device)

    # ---- encode / decode (host) ----
    def _scale_to_q(self, m: np.ndarray, level: int) -> Plaintext:
        """round(m·Q/t) over Q_ℓ for m in [0, t), exactly and vectorized:
        (m·Q + ⌊t/2⌋) // t = m·Δ + (m·(Q mod t) + ⌊t/2⌋) // t. The carry is
        int64-exact for t < 2^31; so is every term at the 32-bit word
        (t, q_i < 2^31). At the 64-bit word m·(Δ mod q_i) needs up to 78
        bits, so that product is taken in Python integers."""
        Q = self.params.q_prod(level)
        m = np.asarray(m, dtype=np.int64)
        carry = (m * (Q % self.t) + self.t // 2) // self.t
        delta = Q // self.t
        if self.word_bits == 64:
            mo, co = m.astype(object), carry.astype(object)
            data = np.stack([((mo * (delta % qi) + co) % qi).astype(np.int64)
                             for qi in self.q[:level + 1]])
        else:
            data = np.stack([(m * (delta % qi) + carry) % qi for qi in self.q[:level + 1]])
        return Plaintext(data=self._tensor(data), level=level)

    def encode(self, values, level: int) -> Plaintext:
        """Slot-batched encode, scaled by round(m·Q/t)."""
        return self._scale_to_q(bfv_encode_slots(values, self.t, self.n), level)

    def encode_ringt(self, values) -> PlaintextRingt:
        return PlaintextRingt(data=self._tensor(bfv_encode_slots(values, self.t, self.n)))

    def encode_mul(self, values, level: int) -> PlaintextMul:
        """NTT + Montgomery form of the unscaled message lifted to Q_ℓ."""
        return self._lift_mul(bfv_encode_slots(values, self.t, self.n), level)

    def _lift_mul(self, m: np.ndarray, level: int) -> PlaintextMul:
        ring = self.ring(level)
        lifted = self._tensor(np.broadcast_to(m, (level + 1, self.n)))
        f = ntt_mod.ntt(lifted, ring)
        return PlaintextMul(data=ring.word.to_mont(f, ring.q, ring.pinv, ring.r2), level=level)

    def decode(self, pt_mod_t) -> np.ndarray:
        return bfv_decode_slots(np.asarray(pt_mod_t), self.t, self.n)

    def _coeffs_mod_t(self, coeffs) -> np.ndarray:
        m = np.zeros(self.n, dtype=np.int64)
        vals = np.asarray(coeffs, dtype=np.uint64) % np.uint64(self.t)
        m[:len(vals)] = vals.astype(np.int64)
        return m

    def encode_coeffs(self, coeffs, level: int) -> Plaintext:
        return self._scale_to_q(self._coeffs_mod_t(coeffs), level)

    def encode_coeffs_ringt(self, coeffs) -> PlaintextRingt:
        return PlaintextRingt(data=self._tensor(self._coeffs_mod_t(coeffs)))

    def encode_coeffs_mul(self, coeffs, level: int) -> PlaintextMul:
        return self._lift_mul(self._coeffs_mod_t(coeffs), level)

    # ---- encrypt / decrypt (host sampling, device arithmetic) ----
    def encrypt_asymmetric(self, rng, pk, pt: Plaintext) -> Ciphertext:
        level = pt.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        u_ntt = ntt_mod.ntt(lift_to(sample_ternary(rng, self.n), q_mods, self.device), ring)
        c = []
        for j in range(2):
            prod = ring.word.mulmod(pk.data[j][:level + 1], u_ntt, ring.q, ring.pinv, ring.r2)
            poly = ntt_mod.intt(prod, ring)
            e = lift_to(sample_gaussian(rng, self.n), q_mods, self.device)
            c.append(_u.addmod(poly, e, ring.q))
        c0 = _u.addmod(c[0], pt.data, ring.q)
        return Ciphertext(data=torch.stack([c0, c[1]]), level=level)

    def encrypt_symmetric(self, rng, sk, pt: Plaintext) -> Ciphertext:
        level = pt.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        a_ntt = self._tensor(sample_uniform_rns(rng, q_mods, self.n))
        s_ntt = sk.ntt_form(q_mods, self.n, self.device, self.word_bits)
        as_ = ntt_mod.intt(ring.word.mulmod(a_ntt, s_ntt, ring.q, ring.pinv, ring.r2), ring)
        e = lift_to(sample_gaussian(rng, self.n), q_mods, self.device)
        c0 = _u.addmod(_u.negmod(_u.addmod(as_, e, ring.q), ring.q), pt.data, ring.q)
        return Ciphertext(data=torch.stack([c0, ntt_mod.intt(a_ntt, ring)]), level=level)

    def encrypt_symmetric_compressed(self, rng, sk, pt: Plaintext, seed: int | None = None):
        """Seed-expanded symmetric encryption (after the reference's
        fhe_lib_v2.h:561): c1 = INTT(expand_uniform(seed)) is not stored."""
        from ..utils.serialize import CompressedCiphertext, expand_uniform
        level = pt.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        if seed is None:
            seed = (rng.seed_128() if hasattr(rng, 'seed_128')
                    else int(rng.integers(0, 1 << 62)))
        a_ntt = self._tensor(expand_uniform(seed, q_mods, self.n))
        s_ntt = sk.ntt_form(q_mods, self.n, self.device, self.word_bits)
        as_ = ntt_mod.intt(ring.word.mulmod(a_ntt, s_ntt, ring.q, ring.pinv, ring.r2), ring)
        e = lift_to(sample_gaussian(rng, self.n), q_mods, self.device)
        c0 = _u.addmod(_u.negmod(_u.addmod(as_, e, ring.q), ring.q), pt.data, ring.q)
        return CompressedCiphertext(c0=c0, seed=seed, level=level, is_ntt=False)

    def decompress_ciphertext(self, cct) -> Ciphertext:
        """(c0, seed) → the full ciphertext (compressed_ciphertext_to_ciphertext)."""
        from ..utils.serialize import expand_uniform
        ring = self.ring(cct.level)
        a_ntt = self._tensor(expand_uniform(cct.seed, self.q[:cct.level + 1], self.n))
        c0 = torch.as_tensor(cct.c0, dtype=torch.int64, device=self.device)
        return Ciphertext(data=torch.stack([c0, ntt_mod.intt(a_ntt, ring)]), level=cct.level)

    def _phase_residues(self, sk, ct: Ciphertext):
        """Σ_k c_k·s^k over Q_ℓ: the (L, n) residues on the engine's device."""
        level = ct.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        s_ntt = sk.ntt_form(q_mods, self.n, self.device, self.word_bits)
        mulmod = ring.word.mulmod
        acc = ct.data[0]
        s_pow = s_ntt
        for k in range(1, ct.data.shape[0]):
            ck = ntt_mod.ntt(ct.data[k].contiguous(), ring)
            term = ntt_mod.intt(mulmod(ck, s_pow, ring.q, ring.pinv, ring.r2), ring)
            acc = _u.addmod(acc, term, ring.q)
            if k + 1 < ct.data.shape[0]:
                s_pow = mulmod(s_pow, s_ntt, ring.q, ring.pinv, ring.r2)
        return acc

    def _decrypt_phase(self, sk, ct: Ciphertext):
        """Σ_k c_k·s^k CRT-reconstructed to big ints: (X mod Q, Q)."""
        acc = self._phase_residues(sk, ct).cpu().numpy()
        q_mods = self.q[:ct.level + 1]
        Q = self.params.q_prod(ct.level)
        X = np.zeros(self.n, dtype=object)
        for i, qi in enumerate(q_mods):
            Qi = Q // qi
            X = X + acc[i].astype(object) * (Qi * pow(Qi, -1, qi))
        return X % Q, Q

    def decrypt(self, sk, ct: Ciphertext) -> np.ndarray:
        """→ plaintext polynomial mod t, (n,) int64: the exact CRT and
        rounding of ``round_t_over_q`` (big integers where it does not
        apply)."""
        if max(self.q[:ct.level + 1]) < 1 << 62 and 1 < self.t < 1 << 31:
            return round_t_over_q(self._phase_residues(sk, ct), self.ring(ct.level),
                                  self.t).cpu().numpy()
        X, Q = self._decrypt_phase(sk, ct)
        return np.array([((2 * self.t * int(x) + Q) // (2 * Q)) % self.t for x in X],
                        dtype=np.int64)

    def decrypt_coeffs(self, sk, ct: Ciphertext) -> np.ndarray:
        return self.decrypt(sk, ct)

    def noise_budget(self, sk, ct: Ciphertext) -> float:
        """Invariant-noise budget in bits (SEAL semantics): log2(Q / (2·‖t·X − Q·m‖∞))."""
        X, Q = self._decrypt_phase(sk, ct)
        t = self.t
        w_max = 0
        for x in X:
            m = ((2 * t * int(x) + Q) // (2 * Q)) % t
            w = t * int(x) - Q * m
            w = ((w + Q * t // 2) % (Q * t)) - Q * t // 2
            w_max = max(w_max, abs(w))
        if w_max == 0:
            return float(math.log2(Q) - 1.0)
        return float(math.log2(Q) - 1.0 - math.log2(w_max))

    def decrypt_decode(self, sk, ct: Ciphertext) -> np.ndarray:
        return self.decode(self.decrypt(sk, ct))

    # ---- evaluation ops ----
    @staticmethod
    def _check_levels(a, b, op: str):
        if isinstance(b, Ciphertext) and a.level != b.level:
            raise ValueError(f'ciphertext level mismatch in {op}: {a.level} vs {b.level}')

    def _with_c0(self, a: Ciphertext, c0):
        data = torch.cat([c0.unsqueeze(-3), a.data[..., 1:, :, :]], dim=-3)
        return Ciphertext(data=data, level=a.level, is_ntt=a.is_ntt)

    def add(self, a: Ciphertext, b) -> Ciphertext:
        self._check_levels(a, b, 'add')
        ring = self.ring(a.level)
        if isinstance(b, Ciphertext):
            return Ciphertext(data=_u.addmod(a.data, b.data, ring.q), level=a.level,
                              is_ntt=a.is_ntt)
        if isinstance(b, Plaintext):
            return self._with_c0(a, _u.addmod(a.data[..., 0, :, :], b.data, ring.q))
        if isinstance(b, PlaintextRingt):
            dm = ring.word.mont_mul(b.data[..., None, :], self.delta_mont(a.level), ring.q,
                                   ring.pinv)
            return self._with_c0(a, _u.addmod(a.data[..., 0, :, :], dm, ring.q))
        raise TypeError(type(b))

    def sub(self, a: Ciphertext, b) -> Ciphertext:
        self._check_levels(a, b, 'sub')
        ring = self.ring(a.level)
        if isinstance(b, Ciphertext):
            return Ciphertext(data=_u.submod(a.data, b.data, ring.q), level=a.level,
                              is_ntt=a.is_ntt)
        if isinstance(b, Plaintext):
            return self._with_c0(a, _u.submod(a.data[..., 0, :, :], b.data, ring.q))
        if isinstance(b, PlaintextRingt):
            dm = ring.word.mont_mul(b.data[..., None, :], self.delta_mont(a.level), ring.q,
                                   ring.pinv)
            return self._with_c0(a, _u.submod(a.data[..., 0, :, :], dm, ring.q))
        raise TypeError(type(b))

    def neg(self, a: Ciphertext) -> Ciphertext:
        ring = self.ring(a.level)
        return Ciphertext(data=_u.negmod(a.data, ring.q), level=a.level, is_ntt=a.is_ntt)

    def mult(self, a: Ciphertext, b) -> Ciphertext:
        """ct⊗ct → ct3 (BEHZ); ct×pt per plaintext format."""
        with span('bfv.mult'):
            self._check_levels(a, b, 'mult')
            level = a.level
            ring = self.ring(level)
            w = ring.word
            if isinstance(b, Ciphertext):
                bz = self.behz(level)
                ra = bz.ring_aux
                polys = torch.cat([a.data[..., :2, :, :], b.data[..., :2, :, :]], dim=-3)
                if self.word_bits == 64 or getattr(ring, 'dist', None) is not None:
                    # the reference's composition; B5's to-Montgomery epilogue and
                    # from-Montgomery fold stand for its separate passes. A
                    # sharded ring view (parallel/sharded_engine.py) takes it on
                    # either word: a coefficient shard is not a ring row, and B2
                    # and B4 hold full-length NTTs; at the 32-bit word its
                    # from-Montgomery product strips the R that B4 strips
                    ext = bz.extend(polys)                                    # B6 inside
                    fq = ntt_mod.ntt(polys, ring, to_mont=True)
                    fa = ntt_mod.ntt(ext, ra, to_mont=True)
                    with span('bfv.tensor_product'):
                        dq = tensor_product(fq[..., :2, :, :], fq[..., 2:, :, :], ring)
                        da = tensor_product(fa[..., :2, :, :], fa[..., 2:, :, :], ra)
                    dq = ntt_mod.intt(dq, ring, from_mont=True)
                    da = ntt_mod.intt(da, ra, from_mont=True)
                    with span('bfv.scale_and_back'):
                        return Ciphertext(data=bz.scale_and_back(dq, da), level=level)   # B6 inside
                # all four polynomials through one extend + NTT pass (kernel B2)
                with span('bfv.behz_prep'):
                    fq, fa = behz_prep32(polys, bz)
                with span('bfv.tensor_product'):
                    dq = tensor_product(fq[..., :2, :, :], fq[..., 2:, :, :], ring)
                    da = tensor_product(fa[..., :2, :, :], fa[..., 2:, :, :], ra)
                # two to_mont added two R, the product's mont_mul removed one:
                # kernel B4 strips the remaining R, inverts both NTTs and scales
                with span('bfv.behz_finish'):
                    return Ciphertext(data=behz_finish32(dq, da, bz), level=level)
            if isinstance(b, Plaintext):
                bz = self.behz(level)
                ra = bz.ring_aux
                pq = w.to_mont(ntt_mod.ntt(b.data, ring), ring.q, ring.pinv, ring.r2)
                pa = w.to_mont(ntt_mod.ntt(bz.extend(b.data), ra), ra.q, ra.pinv, ra.r2)
                # a plaintext with batch dimensions meets both ciphertext components
                pq, pa = pq.unsqueeze(-3), pa.unsqueeze(-3)
                dq = w.mont_mul(ntt_mod.ntt(a.data.contiguous(), ring), pq, ring.q, ring.pinv)
                da = w.mont_mul(ntt_mod.ntt(bz.extend(a.data), ra), pa, ra.q, ra.pinv)
                return Ciphertext(data=bz.scale_and_back(ntt_mod.intt(dq, ring),
                                                         ntt_mod.intt(da, ra)), level=level)
            if isinstance(b, PlaintextRingt):
                lifted = b.data.unsqueeze(-2).expand(*b.data.shape[:-1], level + 1,
                                                     self.n).contiguous()
                f = w.to_mont(ntt_mod.ntt(lifted, ring), ring.q, ring.pinv, ring.r2)
                prod = w.mont_mul(ntt_mod.ntt(a.data.contiguous(), ring), f.unsqueeze(-3), ring.q,
                                  ring.pinv)
                return Ciphertext(data=ntt_mod.intt(prod, ring), level=level)
            if isinstance(b, PlaintextMul):
                prod = w.mont_mul(ntt_mod.ntt(a.data.contiguous(), ring),
                                  b.data[..., :level + 1, :].unsqueeze(-3), ring.q, ring.pinv)
                return Ciphertext(data=ntt_mod.intt(prod, ring), level=level)
            raise TypeError(type(b))

    def relinearize(self, ct3: Ciphertext, rlk) -> Ciphertext:
        with span('bfv.relinearize'):
            level = ct3.level
            ring = self.ring(level)
            e0, e1 = self.switcher.switch(ct3.data[..., 2, :, :], rlk, level)
            c0 = _u.addmod(ct3.data[..., 0, :, :], e0, ring.q)
            c1 = _u.addmod(ct3.data[..., 1, :, :], e1, ring.q)
            return Ciphertext(data=torch.stack([c0, c1], dim=-3), level=level)

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """BFV modulus switching: drop the last prime, round exactly."""
        rs = self.rescaler(ct.level)
        return Ciphertext(data=rs(ct.data), level=ct.level - 1, is_ntt=ct.is_ntt)

    def mult_scalar(self, ct: Ciphertext, scalar: int) -> Ciphertext:
        """ct · scalar over Q_ℓ (Montgomery product with [scalar·R]_{q_i})."""
        ring = self.ring(ct.level)
        sm = _col([_mont(scalar % qi, qi, self.word_bits) for qi in self.q[:ct.level + 1]],
                  self.device)
        return Ciphertext(data=ring.word.mont_mul(ct.data, sm, ring.q, ring.pinv),
                          level=ct.level, is_ntt=ct.is_ntt)

    def drop_level(self, ct: Ciphertext, levels: int = 1) -> Ciphertext:
        # Limb truncation is not a BFV level drop: Δ = round(Q/t) changes
        # with Q, so the truncated ciphertext decrypts wrong.
        raise NotImplementedError(
            'drop_level is not supported for BFV (Delta = round(Q/t) changes '
            'with Q); use CKKS drop_level or a full BFV modulus switch')

    # ---- rotations ----
    def _auto_coeff(self, x, galois_elt: int, q):
        """σ_g on coefficient-domain polynomials (a sharded view overrides
        it)."""
        return apply_automorphism_coeff(x, q, self.n, galois_elt)

    def _auto_ntt(self, x, galois_elt: int):
        """σ_g on NTT-domain polynomials (a sharded view overrides it)."""
        return apply_automorphism_ntt(x, self.n, galois_elt)

    def apply_galois(self, ct: Ciphertext, galois_elt: int, glk, out_ntt: bool | None = None,
                     out_mform: bool | None = None) -> Ciphertext:
        """σ_g then key switch back to s, on any ciphertext form: NTT or
        Montgomery inputs are brought to the coefficient domain first; the
        output form defaults to the input's and can be forced."""
        with span('bfv.apply_galois'):
            level = ct.level
            ring = self.ring(level)
            out_ntt = ct.is_ntt if out_ntt is None else out_ntt
            out_mform = ct.is_mform if out_mform is None else out_mform
            data = ct.data
            if ct.is_mform:
                data = ring.word.from_mont(data, ring.q, ring.pinv)
            if ct.is_ntt:
                data = ntt_mod.intt(data.contiguous(), ring)
            with span('galois.automorphism'):
                c0 = self._auto_coeff(data[..., 0, :, :], galois_elt, ring.q)
                c1 = self._auto_coeff(data[..., 1, :, :], galois_elt, ring.q)
            e0, e1 = self.switcher.switch(c1, glk, level)
            out = torch.stack([_u.addmod(c0, e0, ring.q), e1], dim=-3)
            if out_ntt:
                out = ntt_mod.ntt(out, ring)
            if out_mform:
                out = ring.word.to_mont(out, ring.q, ring.pinv, ring.r2)
            return Ciphertext(data=out, level=level, is_ntt=out_ntt, is_mform=out_mform)

    def rns_sp_decomp(self, ct: Ciphertext) -> DecomposedCiphertext:
        """Pay the digit decomposition + mod-up + NTT of c1 once; every later
        rotation of this ciphertext shares it (hoisting)."""
        if ct.is_ntt:
            raise ValueError('rns_sp_decomp takes a coefficient-domain ciphertext')
        digits = self.switcher.decompose_modup_ntt(ct.data[..., 1, :, :], ct.level)
        return DecomposedCiphertext(c0=ct.data[..., 0, :, :], digits=digits, level=ct.level)

    def apply_galois_decomposed(self, dct: DecomposedCiphertext, galois_elt: int, glk,
                                out_ntt: bool = False, out_mform: bool = False) -> Ciphertext:
        """Hoisted rotation: σ_g commutes with the RNS digit decomposition, so
        it permutes the precomputed NTT-domain digits directly."""
        level = dct.level
        ring = self.ring(level)
        c0 = self._auto_coeff(dct.c0, galois_elt, ring.q)
        digits = self._auto_ntt(dct.digits, galois_elt)
        e0, e1 = self.switcher.switch_from_digits(digits, glk, level, output_ntt=out_ntt)
        if out_ntt:
            c0 = ntt_mod.ntt(c0, ring)
        data = torch.stack([_u.addmod(c0, e0, ring.q), e1], dim=-3)
        if out_mform:
            data = ring.word.to_mont(data, ring.q, ring.pinv, ring.r2)
        return Ciphertext(data=data, level=level, is_ntt=out_ntt, is_mform=out_mform)

    def rotate_cols(self, ct: Ciphertext, step: int, glk) -> Ciphertext:
        return self.apply_galois(ct, galois_elt_col(step, self.n), glk)

    def rotate_rows(self, ct: Ciphertext, glk) -> Ciphertext:
        return self.apply_galois(ct, galois_elt_row(self.n), glk)

    # ---- ciphertext form conversions ----
    def to_ntt(self, ct: Ciphertext) -> Ciphertext:
        if ct.is_ntt:
            raise ValueError('to_ntt: ciphertext is already in the NTT domain')
        ring = self.ring(ct.level)
        return Ciphertext(data=ntt_mod.ntt(ct.data.contiguous(), ring), level=ct.level,
                          is_ntt=True, is_mform=ct.is_mform)

    def to_inv_ntt(self, ct: Ciphertext) -> Ciphertext:
        if not ct.is_ntt:
            raise ValueError('to_inv_ntt: ciphertext is in the coefficient domain')
        ring = self.ring(ct.level)
        return Ciphertext(data=ntt_mod.intt(ct.data.contiguous(), ring), level=ct.level,
                          is_ntt=False, is_mform=ct.is_mform)

    def to_mf(self, ct: Ciphertext) -> Ciphertext:
        if ct.is_mform:
            raise ValueError('to_mf: ciphertext is already in Montgomery form')
        ring = self.ring(ct.level)
        return Ciphertext(data=ring.word.to_mont(ct.data, ring.q, ring.pinv, ring.r2),
                          level=ct.level, is_ntt=ct.is_ntt, is_mform=True)

    def to_mul(self, ct: Ciphertext) -> Ciphertext:
        """coefficient → NTT + Montgomery ("mul" form) in one pass."""
        if ct.is_ntt or ct.is_mform:
            raise ValueError('to_mul takes a coefficient-domain, non-Montgomery ciphertext')
        ring = self.ring(ct.level)
        return Ciphertext(data=ntt_mod.ntt(ct.data.contiguous(), ring, to_mont=True),
                          level=ct.level, is_ntt=True, is_mform=True)
