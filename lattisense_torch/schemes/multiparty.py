"""Multiparty (threshold) BFV protocols on tensors.

Port of ``lattisense_tpu/schemes/multiparty.py`` (reference parity:
fhe_ops_lib/fhe_lib_v2.h:710-829 — DBfvContext, CkgContext, RkgContext,
RtgContext, E2sContext, S2eContext, RefreshContext,
RefreshAndPermuteContext). The joint secret is s = Σ_i s_i. Transport is
the application's problem: shares expose ``serialize()`` /
``deserialize()``, whose bytes equal the JAX package's.

Sampling stays on the host, in NumPy, with every draw in the reference's
order on each party's ``CryptoRng``, so the same seeds give the same shares
bit for bit at either machine word. The NTTs and modular products of each
share run on the party's device: kernel B1 (32-bit word) or B5 (64-bit
word) on the card, their plain twins on the CPU. Collective keys are the
scheme's ``PublicKey`` / ``KeySwitchKey`` carriers on that device and drive
the batched main path like keys made by one party.

Common reference polynomials (CRPs) come from a public seed through
``utils.serialize.expand_uniform``: every party derives the same CRPs.
"""

import math

import numpy as np
import torch

from .. import resolve_device
from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..utils.csprng import CryptoRng
from ..utils.serialize import _emit, _host, _pack_rns, _parse, _unpack_rns, expand_uniform
from .encoding import bfv_encode_slots
from .galois import apply_automorphism_coeff
from .keys import (SecretKey, _gamma_times_p, as_tensor, lift_to, sample_gaussian,
                   sample_ternary)
from .types import Ciphertext, KeySwitchKey, PublicKey


def _e_ntt(rng, moduli, n, ring, device):
    """NTT of a fresh σ = 3.2 error over ``moduli``."""
    return ntt_mod.ntt(lift_to(sample_gaussian(rng, n), moduli, device), ring)


def _crps(crp_seed: int, moduli, n: int, count: int, device):
    """``count`` CRPs over ``moduli``, one per seed crp_seed + d: (count, L, n)."""
    return as_tensor(np.stack([expand_uniform(crp_seed + d, moduli, n).astype(np.int64)
                               for d in range(count)]), device)


def _modsum(datas, q):
    """Σ of share tensors mod q, in share order."""
    acc = datas[0]
    for d in datas[1:]:
        acc = _u.addmod(acc, d, q)
    return acc


def _split_key(k0s, k1s, Lq: int, Lp: int) -> KeySwitchKey:
    """Per-digit (k0, k1) over Q∪P, Montgomery form → the hybrid key."""
    key = torch.stack([torch.stack([k0, k1]) for k0, k1 in zip(k0s, k1s)])
    return KeySwitchKey(key_q=key[:, :, :Lq].contiguous(), key_p=key[:, :, Lq:].contiguous(),
                        level=Lq - 1, sp_level=Lp - 1)


class _Share:
    """A residue share with a self-describing byte serialization (the JAX
    package's format: the header's shape and moduli, then the bit-packed
    limbs)."""

    kind = 'share'

    def __init__(self, data: torch.Tensor, moduli: tuple[int, ...]):
        self.data = data
        self.moduli = tuple(int(m) for m in moduli)

    def serialize(self) -> bytes:
        header = {'kind': self.kind, 'shape': list(self.data.shape),
                  'moduli': [str(m) for m in self.moduli]}
        return _emit(header, _pack_rns(_host(self.data), self.moduli))

    @classmethod
    def deserialize(cls, blob: bytes, device=None) -> '_Share':
        header, body = _parse(blob)
        if header['kind'] != cls.kind:
            raise ValueError(f"expected {cls.kind} share, got {header['kind']}")
        moduli = tuple(int(m) for m in header['moduli'])
        data, _ = _unpack_rns(body, 0, tuple(header['shape']), moduli)
        return cls(as_tensor(data.astype(np.int64), resolve_device(device)), moduli)


class PublicKeyShare(_Share):
    kind = 'ckg'


class RelinKeyShareRound1(_Share):
    kind = 'rkg1'


class RelinKeyShareRound2(_Share):
    kind = 'rkg2'


class GaloisKeyShare(_Share):
    kind = 'rtg'


class DecryptionShare(_Share):
    kind = 'e2s'


class EncryptionShare(_Share):
    kind = 's2e'


class RefreshShare(_Share):
    kind = 'refresh'


class DBfvParty:
    """One party's local state: its additive secret-key share s_i
    (reference DBfvContext, fhe_lib_v2.h:710).

    ``sigma_smudging`` is the flooding-noise deviation added to every
    published partial decryption (E2S, S2E and refresh shares), so that
    h_i = c1·s_i + e_i − Δ·M_i statistically hides s_i and the ciphertext
    noise. The default 2^30 gives about 30 bits of statistical smudging
    over the base σ = 3.2 noise; it must stay far below Δ/(2·parties) for
    decryption to be right. ``device`` is where the party's share
    arithmetic runs (the card unless ``device='cpu'``)."""

    def __init__(self, params, seed=None, sigma_smudging: float = 2.0 ** 30, device=None):
        self.params = params
        self.device = resolve_device(device)
        self.rng = CryptoRng(seed)
        self.sigma_smudging = float(sigma_smudging)
        self.sk = SecretKey(sample_ternary(self.rng, params.n))
        self.q = tuple(params.q)
        self.p = tuple(params.p)
        self.qp = self.q + self.p
        self.n = params.n


# ---------------------------------------------------------------------------
# CKG — collective public-key generation (fhe_lib_v2.h:726)
# ---------------------------------------------------------------------------

class CkgProtocol:
    def __init__(self, params, crp_seed: int, device=None):
        self.params = params
        self.device = resolve_device(device)
        self.q = tuple(params.q)
        self.wb = params.word_bits
        self.ring = get_rns_ring(self.q, params.n, self.device, self.wb)
        self.crp = _crps(crp_seed, self.q, params.n, 1, self.device)[0]

    def gen_share(self, party: DBfvParty) -> PublicKeyShare:
        ring = self.ring
        s = party.sk.ntt_form(self.q, party.n, self.device, self.wb)
        as_ = ring.word.mulmod(self.crp, s, ring.q, ring.pinv, ring.r2)
        e = _e_ntt(party.rng, self.q, party.n, ring, self.device)
        return PublicKeyShare(_u.negmod(_u.addmod(as_, e, ring.q), ring.q), self.q)

    def aggregate(self, shares: list[PublicKeyShare]) -> PublicKey:
        b = _modsum([s.data for s in shares], self.ring.q)
        return PublicKey(data=torch.stack([b, self.crp]))


# ---------------------------------------------------------------------------
# RKG — 2-round collective relinearization-key generation (fhe_lib_v2.h:739)
# ---------------------------------------------------------------------------

class _KeyProtocol:
    """What RKG and RTG share: the Q∪P ring, β digit CRPs and P·γ_d."""

    def __init__(self, params, crp_seed: int, device):
        self.params = params
        self.device = resolve_device(device)
        self.q = tuple(params.q)
        self.p = tuple(params.p)
        self.qp = self.q + self.p
        self.n = params.n
        self.alpha = len(self.p)
        self.beta = (len(self.q) + self.alpha - 1) // self.alpha
        self.wb = params.word_bits
        self.ring = get_rns_ring(self.qp, self.n, self.device, self.wb)
        self.crp = _crps(crp_seed, self.qp, self.n, self.beta, self.device)   # (β, L+P, n)
        pg = np.zeros((self.beta, len(self.qp), 1), dtype=np.int64)
        pg[:, :len(self.q), 0] = _gamma_times_p(self.q, self.p, self.alpha)
        self.pg = as_tensor(pg, self.device)                                 # (β, L+P, 1)

    def _mulmod(self, a, b):
        r = self.ring
        return r.word.mulmod(a, b, r.q, r.pinv, r.r2)

    def _s_ntt(self, party):
        return party.sk.ntt_form(self.qp, self.n, self.device, self.wb)

    def _aggregate(self, shares):
        return _modsum([s.data for s in shares], self.ring.q)

    def _to_mont(self, x):
        r = self.ring
        return r.word.to_mont(x, r.q, r.pinv, r.r2)


class RkgProtocol(_KeyProtocol):
    """Lattigo-style protocol: the joint rlk encrypts P·γ_d·s² under s
    without any party learning s. Round 1 uses an ephemeral u_i per party."""

    def __init__(self, params, crp_seed: int, device=None):
        super().__init__(params, crp_seed, device)
        self._ephemeral: dict[int, SecretKey] = {}

    def gen_share_round1(self, party: DBfvParty) -> RelinKeyShareRound1:
        ring = self.ring
        u = SecretKey(sample_ternary(party.rng, self.n))
        self._ephemeral[id(party)] = u
        u_ntt = u.ntt_form(self.qp, self.n, self.device, self.wb)
        s_ntt = self._s_ntt(party)
        pgs = self._mulmod(self.pg, s_ntt[None])                           # P·γ_d·s
        h = []
        for d in range(self.beta):
            ua = self._mulmod(self.crp[d], u_ntt)
            e0 = _e_ntt(party.rng, self.qp, self.n, ring, self.device)
            h0 = _u.addmod(_u.submod(pgs[d], ua, ring.q), e0, ring.q)
            sa = self._mulmod(self.crp[d], s_ntt)
            e1 = _e_ntt(party.rng, self.qp, self.n, ring, self.device)
            h.append(torch.stack([h0, _u.addmod(sa, e1, ring.q)]))
        return RelinKeyShareRound1(torch.stack(h), self.qp)

    def aggregate_round1(self, shares: list[RelinKeyShareRound1]) -> RelinKeyShareRound1:
        return RelinKeyShareRound1(self._aggregate(shares), self.qp)

    def gen_share_round2(self, party: DBfvParty,
                         round1: RelinKeyShareRound1) -> RelinKeyShareRound2:
        ring = self.ring
        u = self._ephemeral.pop(id(party))
        u_ntt = u.ntt_form(self.qp, self.n, self.device, self.wb)
        s_ntt = self._s_ntt(party)
        us = _u.submod(u_ntt, s_ntt, ring.q)
        out = []
        for d in range(self.beta):
            e0 = _e_ntt(party.rng, self.qp, self.n, ring, self.device)
            o0 = _u.addmod(self._mulmod(s_ntt, round1.data[d, 0]), e0, ring.q)
            e1 = _e_ntt(party.rng, self.qp, self.n, ring, self.device)
            out.append(torch.stack([o0, _u.addmod(self._mulmod(us, round1.data[d, 1]), e1,
                                                  ring.q)]))
        return RelinKeyShareRound2(torch.stack(out), self.qp)

    def aggregate_round2(self, shares: list[RelinKeyShareRound2],
                         round1: RelinKeyShareRound1) -> KeySwitchKey:
        acc = self._aggregate(shares)
        k0 = self._to_mont(_u.addmod(acc[:, 0], acc[:, 1], self.ring.q))
        k1 = self._to_mont(round1.data[:, 1])
        return _split_key(k0, k1, len(self.q), len(self.p))


# ---------------------------------------------------------------------------
# RTG — collective rotation-key generation (fhe_lib_v2.h:754)
# ---------------------------------------------------------------------------

class RtgProtocol(_KeyProtocol):
    def __init__(self, params, galois_elt: int, crp_seed: int, device=None):
        super().__init__(params, crp_seed, device)
        self.galois_elt = galois_elt

    def gen_share(self, party: DBfvParty) -> GaloisKeyShare:
        ring = self.ring
        s_ntt = self._s_ntt(party)
        s_rot = apply_automorphism_coeff(
            lift_to(party.sk.coeffs, self.qp, self.device), ring.q, self.n,
            self.galois_elt)
        pgs = self._mulmod(self.pg, ntt_mod.ntt(s_rot, ring)[None])        # P·γ_d·σ_g(s)
        h = []
        for d in range(self.beta):
            as_ = self._mulmod(self.crp[d], s_ntt)
            e = _e_ntt(party.rng, self.qp, self.n, ring, self.device)
            h.append(_u.addmod(_u.submod(pgs[d], as_, ring.q), e, ring.q))
        return GaloisKeyShare(torch.stack(h), self.qp)

    def aggregate(self, shares: list[GaloisKeyShare]) -> KeySwitchKey:
        k0 = self._to_mont(self._aggregate(shares))
        return _split_key(k0, self._to_mont(self.crp), len(self.q), len(self.p))


# ---------------------------------------------------------------------------
# E2S / S2E — encryption ↔ additive secret shares (fhe_lib_v2.h:769,788)
# ---------------------------------------------------------------------------

def _delta_m(eng, level: int, ring, values):
    """Δ·M over Q_ℓ for a slot vector M over Z_t (the slot-encoded mask)."""
    m_poly = bfv_encode_slots(values, eng.t, eng.n)
    m = as_tensor(np.broadcast_to(m_poly, (level + 1, eng.n)), eng.device)
    return ring.word.mont_mul(m, eng.delta_mont(level), ring.q, ring.pinv)


def _smudge(party: DBfvParty, moduli, device):
    """The smudging noise of a published share, σ = ``sigma_smudging``
    (above a 31-bit prime: ``lift_to`` reduces it exactly)."""
    return lift_to(sample_gaussian(party.rng, party.n, sigma=party.sigma_smudging), moduli,
                   device)


class E2sProtocol:
    """ct → additive shares over Z_t: each party keeps a uniform mask M_i
    and publishes a masked partial decryption; the aggregator's residual
    plus all masks sums to m (mod t)."""

    def __init__(self, engine, level: int):
        self.engine = engine
        self.level = level
        self.q = tuple(engine.q[:level + 1])
        self.ring = engine.ring(level)
        self.wb = engine.params.word_bits

    def gen_share(self, party: DBfvParty, ct: Ciphertext):
        """→ (public DecryptionShare, private mask M_i over Z_t slots)."""
        eng, ring = self.engine, self.ring
        mask = party.rng.integers(0, eng.t, eng.n, dtype=np.uint64)
        delta_m = _delta_m(eng, self.level, ring, mask)
        c1_ntt = ntt_mod.ntt(ct.data[1].contiguous(), ring)
        s_ntt = party.sk.ntt_form(self.q, eng.n, eng.device, self.wb)
        c1s = ntt_mod.intt(ring.word.mulmod(c1_ntt, s_ntt, ring.q, ring.pinv, ring.r2), ring)
        e = _smudge(party, self.q, eng.device)
        h = _u.submod(_u.addmod(c1s, e, ring.q), delta_m, ring.q)
        return DecryptionShare(h, self.q), mask

    def aggregate(self, ct: Ciphertext, shares: list[DecryptionShare]) -> np.ndarray:
        """The aggregator's residual share m_agg = m − Σ M_i (mod t, slots)."""
        acc = _modsum([ct.data[0]] + [s.data for s in shares], self.ring.q)
        return self.engine.decode(eng_decrypt_poly(self.engine, acc, self.level))


def eng_decrypt_poly(eng, acc, level):
    """Round Δ·x + e → x mod t by exact CRT composition (host, Python
    integers), as (n,) uint64."""
    acc = _host(acc)
    q_mods = eng.q[:level + 1]
    Q = math.prod(q_mods)
    X = np.zeros(eng.n, dtype=object)
    for i, qi in enumerate(q_mods):
        Qi = Q // qi
        X = X + acc[i].astype(object) * (Qi * pow(Qi, -1, qi))
    X = X % Q
    return np.array([((2 * eng.t * int(x) + Q) // (2 * Q)) % eng.t for x in X],
                    dtype=np.uint64)


class S2eProtocol:
    """Additive shares over Z_t → a ciphertext under the joint key
    (fhe_lib_v2.h:788); the CRP c1 comes from a shared seed."""

    def __init__(self, engine, level: int, crp_seed: int):
        self.engine = engine
        self.level = level
        self.q = tuple(engine.q[:level + 1])
        self.ring = engine.ring(level)
        self.wb = engine.params.word_bits
        self.crp_ntt = _crps(crp_seed, self.q, engine.n, 1, engine.device)[0]

    def gen_share(self, party: DBfvParty, mask: np.ndarray) -> EncryptionShare:
        eng, ring = self.engine, self.ring
        delta_m = _delta_m(eng, self.level, ring, mask)
        s_ntt = party.sk.ntt_form(self.q, eng.n, eng.device, self.wb)
        as_ = ntt_mod.intt(ring.word.mulmod(self.crp_ntt, s_ntt, ring.q, ring.pinv, ring.r2),
                           ring)
        e = _smudge(party, self.q, eng.device)
        return EncryptionShare(_u.submod(_u.addmod(delta_m, e, ring.q), as_, ring.q), self.q)

    def aggregate(self, shares: list[EncryptionShare],
                  residual: np.ndarray | None = None) -> Ciphertext:
        acc = _modsum([s.data for s in shares], self.ring.q)
        if residual is not None:
            acc = _u.addmod(acc, _delta_m(self.engine, self.level, self.ring, residual),
                            self.ring.q)
        c1 = ntt_mod.intt(self.crp_ntt, self.ring)
        return Ciphertext(data=torch.stack([acc, c1]), level=self.level)


# ---------------------------------------------------------------------------
# Collective refresh (+ permute) — fhe_lib_v2.h:801,814
# ---------------------------------------------------------------------------

class RefreshProtocol:
    """E2S ∘ S2E with per-party masks: resets the noise without a full
    decryption. ``permutation`` (a slot index map) gives the
    refresh-and-permute variant: out_slot[k] = in_slot[perm[k]]."""

    def __init__(self, engine, level: int, crp_seed: int,
                 permutation: np.ndarray | None = None):
        self.engine = engine
        self.e2s = E2sProtocol(engine, level)
        self.s2e = S2eProtocol(engine, level, crp_seed)
        self.perm = permutation

    def gen_share(self, party: DBfvParty, ct: Ciphertext) -> RefreshShare:
        dec_share, mask = self.e2s.gen_share(party, ct)
        out_mask = mask if self.perm is None else mask[self.perm]
        enc_share = self.s2e.gen_share(party, out_mask)
        return RefreshShare(torch.stack([dec_share.data, enc_share.data]), dec_share.moduli)

    def finalize(self, ct: Ciphertext, shares: list[RefreshShare]) -> Ciphertext:
        dec_shares = [DecryptionShare(s.data[0], s.moduli) for s in shares]
        enc_shares = [EncryptionShare(s.data[1], s.moduli) for s in shares]
        residual = self.e2s.aggregate(ct, dec_shares)
        if self.perm is not None:
            residual = residual[self.perm]
        return self.s2e.aggregate(enc_shares, residual)
