"""CKKS scheme engine on tensors: encode/encrypt/decrypt and evaluation ops.

Port of ``lattisense_tpu/schemes/ckks.py`` for both machine words (the
parameter set's ``word_bits``). Ciphertexts and plaintexts live in the NTT
domain, not in Montgomery form. Multiplication is the RNS pointwise product
(no base extension): ``a`` enters the Montgomery domain and its Montgomery
products with the raw ``b`` give plain products. Rescaling divides by the
last prime with exact RNS rounding and divides the scale by it; the scale
is host metadata on each carrier. Sparse packing (slots < n/2) replicates
the message (Lattigo's convention).

Every NTT is kernel B1 (32-bit word) or B5 (64-bit word) on a CUDA tensor;
key switching (relinearization, rotations) is B3 with an NTT-domain output
at the 32-bit word, and B6, B5 and B7 at the 64-bit word
(``schemes/keyswitch.py``); the ct × ct tensor product is B8 at both words
(``ops/tensor_cuda.py``). The rest is plain PyTorch on the engine's device.
Host work (encoding, sampling, the big-integer CRT in ``decrypt``) runs in
NumPy. The evaluation ops take and return carriers whose data may carry
leading batch dimensions.
"""

import numpy as np
import torch

from .. import resolve_device
from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..core.rns import DivRoundLast, _col, _mont
from ..params import CkksParams
from ..utils import observability
from ..utils.observability import span
from .bfv import tensor_product
from .encoding import ckks_decode_values, ckks_encode_values
from .galois import apply_automorphism_ntt, galois_elt_col, galois_elt_row
from .keys import as_tensor, lift_to, sample_gaussian, sample_ternary, sample_uniform_rns
from .keyswitch import KeySwitcher
from .types import Ciphertext, DecomposedCiphertext, Plaintext, PlaintextMul, PlaintextRingt


class CkksEngine:
    """CKKS engine for one parameter set on one device (CUDA by default)."""

    def __init__(self, params: CkksParams, device=None):
        self.params = params
        self.device = resolve_device(device)
        self.n = params.n
        self.q = tuple(params.q)
        self.p = tuple(params.p)
        self.word_bits = params.word_bits
        self.switcher = KeySwitcher(self.q, self.p, self.n, self.device, self.word_bits)
        self._rescaler: dict[int, DivRoundLast] = {}
        self._const_cols: dict = {}
        self._monomials: dict = {}
        self.bootstrapper = None

    def ring(self, level: int):
        return get_rns_ring(self.q[:level + 1], self.n, self.device, self.word_bits)

    def rescaler(self, level: int) -> DivRoundLast:
        if level not in self._rescaler:
            observability.table_built('CkksEngine.rescaler')
            self._rescaler[level] = DivRoundLast(self.q[:level + 1], self.device, self.word_bits)
        return self._rescaler[level]

    def _tensor(self, arr):
        return as_tensor(arr, self.device)

    def mont_col(self, value: int, level: int):
        """[value·R]_{q_i} over the limbs of ``level``: an (L, 1) column on the
        device (a limb-sharded view holds its own limbs' rows)."""
        return _col([_mont(value % qi, qi, self.word_bits) for qi in self.q[:level + 1]],
                    self.device)

    def whole_limbs(self, x, level: int):
        """x (..., L, n) with every limb of ``level`` on this device: x itself
        here; a limb-sharded view gathers its ranks' limbs."""
        return x

    # ---- encode / decode (host) ----
    def _residues(self, coeffs, level: int) -> np.ndarray:
        """Integer coefficients (n,), int64 or Python ints → (L, n) int64
        residues over Q_ℓ."""
        return np.stack([np.mod(coeffs, qi).astype(np.int64) for qi in self.q[:level + 1]])

    def encode(self, values, level: int, scale: float | None = None) -> Plaintext:
        scale = scale or self.params.scale
        coeffs = ckks_encode_values(values, self.n, self.params.slots, scale)
        data = ntt_mod.ntt(self._tensor(self._residues(coeffs, level)), self.ring(level))
        return Plaintext(data=data, level=level, is_ntt=True, scale=scale)

    def encode_const(self, value: float, level: int, scale: float | None = None) -> Plaintext:
        """Exact constant plaintext: a constant slot vector is the constant
        polynomial round(v·Δ)·X⁰, whose NTT is the constant itself in every
        position — no embedding FFT and none of its rounding noise. The
        (L, 1) column is expanded to a contiguous (L, n) tensor, as every
        kernel takes it."""
        scale = scale or self.params.scale
        c0 = int(round(float(value) * scale))
        # the column is made once and kept on the device for the engine's
        # life, so a run that a CUDA graph captures copies nothing from the
        # host here, and the graph's replays read it in place: it is never
        # evicted
        col = self._const_cols.get((c0, level))
        if col is None:
            col = self._const_cols[(c0, level)] = self._tensor(
                np.array([[c0 % qi] for qi in self.q[:level + 1]], dtype=np.int64))
        return Plaintext(data=col.expand(level + 1, self.n).contiguous(), level=level,
                         is_ntt=True, scale=scale)

    def encode_ringt(self, values, scale: float | None = None) -> PlaintextRingt:
        """Single-component plaintext: small signed integer coefficients,
        lifted to the chain at multiplication time."""
        scale = scale or self.params.scale
        coeffs = ckks_encode_values(values, self.n, self.params.slots, scale)
        if not all(abs(c) < (1 << 62) for c in coeffs):
            raise ValueError('ringt coefficients overflow 62 bits')
        return PlaintextRingt(data=self._tensor(coeffs.astype(np.int64)), scale=scale)

    def encode_mul(self, values, level: int, scale: float | None = None) -> PlaintextMul:
        pt = self.encode(values, level, scale)
        ring = self.ring(level)
        return PlaintextMul(data=ring.word.to_mont(pt.data, ring.q, ring.pinv, ring.r2),
                            level=level, scale=pt.scale)

    def decode(self, coeffs_signed, scale: float) -> np.ndarray:
        return ckks_decode_values(coeffs_signed, self.n, self.params.slots, scale)

    # ---- encrypt / decrypt (host sampling, device arithmetic) ----
    def _ntt_of_small(self, coeffs, q_mods, ring):
        return ntt_mod.ntt(lift_to(coeffs, q_mods, self.device), ring)

    def encrypt_asymmetric(self, rng, pk, pt: Plaintext) -> Ciphertext:
        level = pt.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        u_ntt = self._ntt_of_small(sample_ternary(rng, self.n), q_mods, ring)
        c = []
        for j in range(2):
            prod = ring.word.mulmod(pk.data[j][:level + 1], u_ntt, ring.q, ring.pinv, ring.r2)
            e_ntt = self._ntt_of_small(sample_gaussian(rng, self.n), q_mods, ring)
            c.append(_u.addmod(prod, e_ntt, ring.q))
        c0 = _u.addmod(c[0], pt.data, ring.q)
        return Ciphertext(data=torch.stack([c0, c[1]]), level=level, is_ntt=True,
                          scale=pt.scale)

    def _encrypt_sym_c0(self, rng, sk, a_ntt, pt: Plaintext):
        """c0 = -(a·s + e) + m over Q_ℓ for the NTT-domain mask ``a_ntt``."""
        level = pt.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        s_ntt = sk.ntt_form(q_mods, self.n, self.device, self.word_bits)
        as_ = ring.word.mulmod(a_ntt, s_ntt, ring.q, ring.pinv, ring.r2)
        e_ntt = self._ntt_of_small(sample_gaussian(rng, self.n), q_mods, ring)
        return _u.addmod(_u.negmod(_u.addmod(as_, e_ntt, ring.q), ring.q), pt.data, ring.q)

    def encrypt_symmetric(self, rng, sk, pt: Plaintext) -> Ciphertext:
        a_ntt = self._tensor(sample_uniform_rns(rng, self.q[:pt.level + 1], self.n))
        c0 = self._encrypt_sym_c0(rng, sk, a_ntt, pt)
        return Ciphertext(data=torch.stack([c0, a_ntt]), level=pt.level, is_ntt=True,
                          scale=pt.scale)

    def encrypt_symmetric_compressed(self, rng, sk, pt: Plaintext, seed: int | None = None):
        """Seed-expanded symmetric encryption (after the reference's
        fhe_lib_v2.h:1026): c1 = expand_uniform(seed), in the NTT domain like
        every CKKS ciphertext component, is not stored."""
        from ..utils.serialize import CompressedCiphertext, expand_uniform
        if seed is None:
            seed = (rng.seed_128() if hasattr(rng, 'seed_128')
                    else int(rng.integers(0, 1 << 62)))
        a_ntt = self._tensor(expand_uniform(seed, self.q[:pt.level + 1], self.n))
        c0 = self._encrypt_sym_c0(rng, sk, a_ntt, pt)
        return CompressedCiphertext(c0=c0, seed=seed, level=pt.level, is_ntt=True,
                                    scale=pt.scale)

    def decompress_ciphertext(self, cct) -> Ciphertext:
        from ..utils.serialize import expand_uniform
        a_ntt = self._tensor(expand_uniform(cct.seed, self.q[:cct.level + 1], self.n))
        c0 = torch.as_tensor(cct.c0, dtype=torch.int64, device=self.device)
        return Ciphertext(data=torch.stack([c0, a_ntt]), level=cct.level, is_ntt=True,
                          scale=cct.scale)

    def decrypt(self, sk, ct: Ciphertext) -> np.ndarray:
        """One ciphertext → its centered big-int coefficients, (n,) dtype=object."""
        level = ct.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        s_ntt = sk.ntt_form(q_mods, self.n, self.device, self.word_bits)
        mulmod = ring.word.mulmod
        acc = ct.data[0]
        s_pow = s_ntt
        for k in range(1, ct.data.shape[0]):
            term = mulmod(ct.data[k], s_pow, ring.q, ring.pinv, ring.r2)
            acc = _u.addmod(acc, term, ring.q)
            if k + 1 < ct.data.shape[0]:
                s_pow = mulmod(s_pow, s_ntt, ring.q, ring.pinv, ring.r2)
        coeffs = ntt_mod.intt(acc.contiguous(), ring).cpu().numpy()
        Q = self.params.q_prod(level)
        X = np.zeros(self.n, dtype=object)
        for i, qi in enumerate(q_mods):
            Qi = Q // qi
            X = X + coeffs[i].astype(object) * (Qi * pow(Qi, -1, qi))
        X = X % Q
        return np.where(X > Q // 2, X - Q, X)

    def decrypt_decode(self, sk, ct: Ciphertext) -> np.ndarray:
        return self.decode(self.decrypt(sk, ct), ct.scale)

    # ---- evaluation ops ----
    @staticmethod
    def _check_scales(a, b):
        if abs(a.scale - b.scale) > 1e-6 * max(a.scale, b.scale):
            raise ValueError(f'scale mismatch: {a.scale} vs {b.scale}')

    @staticmethod
    def _check_levels(a, b, op: str):
        if isinstance(b, Ciphertext) and a.level != b.level:
            raise ValueError(f'ciphertext level mismatch in {op}: {a.level} vs {b.level}')

    def _ct(self, data, like, level=None, scale=None) -> Ciphertext:
        return Ciphertext(data=data, level=like.level if level is None else level, is_ntt=True,
                          scale=like.scale if scale is None else scale)

    def _with_c0(self, a: Ciphertext, c0) -> Ciphertext:
        return self._ct(torch.cat([c0.unsqueeze(-3), a.data[..., 1:, :, :]], dim=-3), a)

    def _addsub(self, a: Ciphertext, b, op: str, f) -> Ciphertext:
        self._check_levels(a, b, op)
        ring = self.ring(a.level)
        if isinstance(b, Ciphertext):
            self._check_scales(a, b)
            return self._ct(f(a.data, b.data, ring.q), a)
        if isinstance(b, Plaintext):
            self._check_scales(a, b)
            return self._with_c0(a, f(a.data[..., 0, :, :], b.data, ring.q))
        if isinstance(b, PlaintextRingt):
            self._check_scales(a, b)
            lifted = self._lift_ringt_ntt(b, a.level)
            return self._with_c0(a, f(a.data[..., 0, :, :], lifted, ring.q))
        raise TypeError(type(b))

    def add(self, a: Ciphertext, b) -> Ciphertext:
        return self._addsub(a, b, 'add', _u.addmod)

    def sub(self, a: Ciphertext, b) -> Ciphertext:
        return self._addsub(a, b, 'sub', _u.submod)

    def neg(self, a: Ciphertext) -> Ciphertext:
        return self._ct(_u.negmod(a.data, self.ring(a.level).q), a)

    def _lift_ringt_ntt(self, pt: PlaintextRingt, level: int):
        """Signed single-component coefficients (..., n) → NTT form over Q_ℓ,
        (..., L, n). A negative coefficient c becomes c + q_i in int64, the
        bits of the reference's wrapping word add (masked to 32 bits on
        the 32-bit word)."""
        ring = self.ring(level)
        c = pt.data.unsqueeze(-2)
        if self.word_bits == 32:
            pos = c & _u.MASK32
            lifted = torch.where(c < 0, (pos + ring.q) & _u.MASK32, pos)
        else:
            lifted = torch.where(c < 0, c + ring.q, c)
        lifted = lifted.expand(*c.shape[:-2], level + 1, self.n).contiguous()
        return ntt_mod.ntt(lifted, ring)

    def mult(self, a: Ciphertext, b) -> Ciphertext:
        """ct⊗ct → ct3, ct×pt per plaintext format; the scales multiply."""
        with span('ckks.mult'):
            self._check_levels(a, b, 'mult')
            level = a.level
            ring = self.ring(level)
            w = ring.word
            if isinstance(b, Ciphertext):
                d = tensor_product(a.data[..., :2, :, :], b.data[..., :2, :, :], ring,
                                   a_to_mont=True)
                return self._ct(d, a, scale=a.scale * b.scale)
            if isinstance(b, Plaintext):
                pm = w.to_mont(b.data, ring.q, ring.pinv, ring.r2)
            elif isinstance(b, PlaintextRingt):
                pm = w.to_mont(self._lift_ringt_ntt(b, level), ring.q, ring.pinv, ring.r2)
            elif isinstance(b, PlaintextMul):
                pm = b.data[..., :level + 1, :]
            else:
                raise TypeError(type(b))
            # a plaintext with batch dimensions meets both ciphertext components
            data = w.mont_mul(a.data, pm.unsqueeze(-3), ring.q, ring.pinv)
            return self._ct(data, a, scale=a.scale * b.scale)

    def relinearize(self, ct3: Ciphertext, rlk) -> Ciphertext:
        with span('ckks.relinearize'):
            level = ct3.level
            ring = self.ring(level)
            c2 = ntt_mod.intt(ct3.data[..., 2, :, :].contiguous(), ring)
            e0, e1 = self.switcher.switch(c2, rlk, level, output_ntt=True)
            c0 = _u.addmod(ct3.data[..., 0, :, :], e0, ring.q)
            c1 = _u.addmod(ct3.data[..., 1, :, :], e1, ring.q)
            return self._ct(torch.stack([c0, c1], dim=-3), ct3)

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Divide by the last prime with exact rounding (INTT, divide-and-
        round, NTT over the shorter chain); the scale shrinks by q_ℓ."""
        with span('ckks.rescale'):
            level = ct.level
            coeff = ntt_mod.intt(ct.data.contiguous(), self.ring(level))
            with span('ckks.divround'):
                coeff = self.rescaler(level)(coeff)
            data = ntt_mod.ntt(coeff, self.ring(level - 1))
            return self._ct(data, ct, level=level - 1, scale=ct.scale / self.q[level])

    def mul_monomial(self, ct: Ciphertext, k: int) -> Ciphertext:
        """ct·X^k: exact, with no level spent and no scale change. In the NTT
        domain X^k is the column of its evaluations at the ring's roots, made
        once a (k, level) by the ring's own NTT of the monomial, kept on the
        device in Montgomery form, and taken as a pointwise product;
        ``mul_monomial_plain`` is its twin on the coefficients. X^{n/2}
        multiplies every slot by i."""
        level = ct.level
        ring = self.ring(level)
        col = self._monomials.get((k, level))
        if col is None:
            one = torch.zeros((level + 1, self.n), dtype=torch.int64, device=self.device)
            one[:, k % self.n] = 1
            mono = ntt_mod.ntt(one, ring)
            if (k // self.n) % 2:
                mono = _u.negmod(mono, ring.q)
            col = self._monomials[(k, level)] = ring.word.to_mont(mono, ring.q, ring.pinv,
                                                                  ring.r2)
        return self._ct(ring.word.mont_mul(ct.data, col, ring.q, ring.pinv), ct)

    def drop_level(self, ct: Ciphertext, levels: int = 1) -> Ciphertext:
        return self._ct(ct.data[..., :ct.level + 1 - levels, :], ct, level=ct.level - levels)

    def _switch_back(self, c0, c1_ntt, ksk, level: int, like) -> Ciphertext:
        """(c0 + e0, e1) with (e0, e1) the key switch of the NTT-domain c1."""
        ring = self.ring(level)
        e0, e1 = self.switcher.switch(ntt_mod.intt(c1_ntt.contiguous(), ring), ksk, level,
                                      output_ntt=True)
        return self._ct(torch.stack([_u.addmod(c0, e0, ring.q), e1], dim=-3), like)

    def _auto_ntt(self, x, galois_elt: int):
        """σ_g on NTT-domain polynomials (a sharded view overrides it)."""
        return apply_automorphism_ntt(x, self.n, galois_elt)

    def apply_galois(self, ct: Ciphertext, galois_elt: int, glk) -> Ciphertext:
        with span('ckks.apply_galois'):
            c0 = self._auto_ntt(ct.data[..., 0, :, :], galois_elt)
            c1 = self._auto_ntt(ct.data[..., 1, :, :], galois_elt)
            return self._switch_back(c0, c1, glk, ct.level, ct)

    def key_switch(self, ct: Ciphertext, ksk) -> Ciphertext:
        """Re-key a ciphertext: decrypts under s_new given ``ksk`` encrypting
        s_old under s_new (bootstrapping's dense↔sparse hops)."""
        return self._switch_back(ct.data[..., 0, :, :], ct.data[..., 1, :, :], ksk, ct.level, ct)

    def bootstrap(self, ct: Ciphertext, keys) -> Ciphertext:
        """The task runtime's bootstrap node: the context's bootstrapper with
        ``keys`` {'rlk', 'glk', 'swk'}."""
        btp = self.bootstrapper
        if btp is None:
            raise RuntimeError('engine has no bootstrapper; use CkksBtpContext')
        swk = keys.get('swk', {})
        return btp(ct, keys['rlk'], keys['glk'], swk_dts=swk.get('swk_dts'),
                   swk_std=swk.get('swk_std'))

    def rns_sp_decomp(self, ct: Ciphertext) -> DecomposedCiphertext:
        """Hoisted-rotation precompute: c1's digit decomposition, mod-up and
        NTT, paid once for every later rotation of this ciphertext."""
        c1 = ntt_mod.intt(ct.data[..., 1, :, :].contiguous(), self.ring(ct.level))
        digits = self.switcher.decompose_modup_ntt(c1, ct.level)
        return DecomposedCiphertext(c0=ct.data[..., 0, :, :], digits=digits, level=ct.level,
                                    is_ntt=True, scale=ct.scale)

    def apply_galois_decomposed(self, dct: DecomposedCiphertext, galois_elt: int, glk,
                                **_ignored) -> Ciphertext:
        """Hoisted rotation: σ_g permutes the NTT-domain digits directly."""
        level = dct.level
        ring = self.ring(level)
        c0 = self._auto_ntt(dct.c0, galois_elt)
        digits = self._auto_ntt(dct.digits, galois_elt)
        e0, e1 = self.switcher.switch_from_digits(digits, glk, level, output_ntt=True)
        return Ciphertext(data=torch.stack([_u.addmod(c0, e0, ring.q), e1], dim=-3),
                          level=level, is_ntt=True, scale=dct.scale)

    def rotate(self, ct: Ciphertext, step: int, glk) -> Ciphertext:
        return self.apply_galois(ct, galois_elt_col(step, self.n), glk)

    def conjugate(self, ct: Ciphertext, glk) -> Ciphertext:
        return self.apply_galois(ct, galois_elt_row(self.n), glk)

    def mult_scalar(self, ct: Ciphertext, scalar: float) -> Ciphertext:
        """Multiply by a real scalar encoded at the default scale."""
        enc = int(round(scalar * self.params.scale))
        ring = self.ring(ct.level)
        sm = self.mont_col(enc, ct.level)
        return self._ct(ring.word.mont_mul(ct.data, sm, ring.q, ring.pinv), ct,
                        scale=ct.scale * self.params.scale)


def mul_monomial_plain(data, k: int, ring):
    """``CkksEngine.mul_monomial``'s twin on NTT-domain data (..., L, n):
    back to the coefficients, the negacyclic shift by k (a coefficient that
    wraps past X^n changes sign), and forward again."""
    n = data.shape[-1]
    coeff = ntt_mod.intt(data.contiguous(), ring)
    k %= 2 * n
    neg = k >= n
    k %= n
    shifted = torch.roll(coeff, k, dims=-1)
    wrapped = torch.zeros(n, dtype=torch.bool, device=data.device)
    wrapped[:k] = True
    if neg:
        wrapped = ~wrapped
    shifted = torch.where(wrapped, _u.negmod(shifted, ring.q), shifted)
    return ntt_mod.ntt(shifted.contiguous(), ring)
