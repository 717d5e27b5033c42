"""Key generation for BFV: NumPy sampling, tensor arithmetic.

Port of ``lattisense_tpu/schemes/keys.py``. Every random draw goes through
the same sampler calls, in the same order, as the reference, on a
``utils.csprng.CryptoRng``: the same seed gives the same secret, public,
relinearization and Galois keys, at either machine word (``word_bits``;
keys are NTT + Montgomery with R = 2^word_bits). Samples become int64
tensors on the target device only after sampling; the NTTs and modular
products then run there (kernel B1 or B5 on the card).

Distributions: uniform ternary secret, rounded Gaussian errors (σ = 3.2),
uniform ring elements drawn per RNS limb. Hybrid key-switching keys: β =
ceil(Lq/α) digits with α = |P| special primes; digit d encrypts P·γ_d·s'
with γ_d = (Q/Q_d)·[(Q/Q_d)^-1]_{Q_d}.
"""

import math

import numpy as np
import torch

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import get_rns_ring
from .galois import apply_automorphism_coeff
from .types import KeySwitchKey, PublicKey

SIGMA = 3.2


def lift_signed(coeffs, moduli) -> np.ndarray:
    """Signed small coefficients (n,) → RNS (L, n) int64 residues."""
    c = np.asarray(coeffs, dtype=np.int64)
    out = np.empty((len(moduli), len(c)), dtype=np.int64)
    for i, q in enumerate(moduli):
        out[i] = np.mod(c, np.int64(q))
    return out


def lift_to(coeffs, moduli, device) -> torch.Tensor:
    """``lift_signed`` made on ``device``: the (n,) coefficients cross to it
    once and are reduced there, an (L, n) int64 tensor."""
    c = torch.from_numpy(np.ascontiguousarray(coeffs, dtype=np.int64)).to(device)
    q = torch.tensor([int(m) for m in moduli], dtype=torch.int64, device=c.device)
    return torch.remainder(c.unsqueeze(0), q.reshape(-1, 1))


def sample_ternary(rng, n: int, h: int | None = None) -> np.ndarray:
    """Uniform ternary secret; with ``h`` the sparse secret of Hamming weight
    h (the bootstrapping contexts' second secret), drawn as the reference
    draws it: h distinct positions, then their signs."""
    if h is None:
        return rng.integers(-1, 2, size=n, dtype=np.int64)
    coeffs = np.zeros(n, dtype=np.int64)
    idx = rng.choice(n, size=h, replace=False)
    coeffs[idx] = rng.choice(np.array([-1, 1], dtype=np.int64), size=h)
    return coeffs


def sample_gaussian(rng, n: int, sigma: float = SIGMA) -> np.ndarray:
    return np.round(rng.normal(0.0, sigma, size=n)).astype(np.int64)


def sample_uniform_rns(rng, moduli, n: int) -> np.ndarray:
    """Uniform per-limb residues, drawn as the reference draws them (a u64
    stream per limb), as (L, n) int64."""
    out = np.empty((len(moduli), n), dtype=np.int64)
    for i, q in enumerate(moduli):
        out[i] = rng.integers(0, int(q), size=n, dtype=np.uint64)
    return out


def as_tensor(arr, device):
    """An int64 host array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).to(device)


class SecretKey:
    def __init__(self, coeffs: np.ndarray):
        self.coeffs = np.asarray(coeffs, dtype=np.int64)     # (n,) in {-1, 0, 1}
        self._ntt_cache: dict = {}

    def ntt_form(self, moduli, n: int, device, word_bits: int = 32):
        """NTT of s over ``moduli`` as an int64 (L, n) tensor on ``device``."""
        key = (tuple(moduli), n, torch.device(device), word_bits)
        if key not in self._ntt_cache:
            ring = get_rns_ring(moduli, n, device, word_bits)
            self._ntt_cache[key] = ntt_mod.ntt(lift_to(self.coeffs, moduli, device),
                                               ring)
        return self._ntt_cache[key]


def gen_public_key(rng, sk: SecretKey, q_moduli: tuple[int, ...], n: int, device,
                   word_bits: int = 32) -> PublicKey:
    """pk = (b, a) with b = -(a·s + e), in the NTT domain over the full Q."""
    ring = get_rns_ring(q_moduli, n, device, word_bits)
    s_ntt = sk.ntt_form(q_moduli, n, device, word_bits)
    a = as_tensor(sample_uniform_rns(rng, q_moduli, n), device)
    e_ntt = ntt_mod.ntt(lift_to(sample_gaussian(rng, n), q_moduli, device), ring)
    as_ = ring.word.mulmod(a, s_ntt, ring.q, ring.pinv, ring.r2)
    b = _u.negmod(_u.addmod(as_, e_ntt, ring.q), ring.q)
    return PublicKey(data=torch.stack([b, a]))


def _gamma_times_p(q_moduli: tuple[int, ...], p_moduli: tuple[int, ...], alpha: int) -> np.ndarray:
    """[P·γ_d]_{q_i} for each digit d (zero mod every special prime)."""
    Q = math.prod(q_moduli)
    P = math.prod(p_moduli)
    L = len(q_moduli)
    beta = (L + alpha - 1) // alpha
    consts = np.zeros((beta, L), dtype=np.int64)
    for d in range(beta):
        Qd = math.prod(q_moduli[d * alpha:(d + 1) * alpha])
        gamma = (Q // Qd) * pow(Q // Qd, -1, Qd)
        for i, qi in enumerate(q_moduli):
            consts[d, i] = (P * gamma) % qi
    return consts


def gen_keyswitch_key(rng, sk: SecretKey, target_ntt_fn, q_moduli: tuple[int, ...],
                      p_moduli: tuple[int, ...], n: int, device,
                      word_bits: int = 32) -> KeySwitchKey:
    """Key switching s' → s; ``target_ntt_fn(moduli)`` returns the NTT form
    of s' over ``moduli``. Output keys are NTT + Montgomery."""
    qp = tuple(q_moduli) + tuple(p_moduli)
    ring = get_rns_ring(qp, n, device, word_bits)
    w = ring.word
    Lq, Lp = len(q_moduli), len(p_moduli)
    alpha = Lp
    beta = (Lq + alpha - 1) // alpha
    s_ntt = sk.ntt_form(qp, n, device, word_bits)
    t_ntt = target_ntt_fn(qp)
    consts = _gamma_times_p(tuple(q_moduli), tuple(p_moduli), alpha)
    key_q, key_p = [], []
    for d in range(beta):
        a = as_tensor(sample_uniform_rns(rng, qp, n), device)
        e_ntt = ntt_mod.ntt(lift_to(sample_gaussian(rng, n), qp, device), ring)
        as_ = w.mulmod(a, s_ntt, ring.q, ring.pinv, ring.r2)
        b = _u.negmod(_u.addmod(as_, e_ntt, ring.q), ring.q)
        # + P·γ_d·s' (zero on the p limbs)
        pg = np.zeros((Lq + Lp, 1), dtype=np.int64)
        pg[:Lq, 0] = consts[d]
        term = w.mulmod(as_tensor(pg, device), t_ntt, ring.q, ring.pinv, ring.r2)
        b = _u.addmod(b, term, ring.q)
        bm = w.to_mont(b, ring.q, ring.pinv, ring.r2)
        am = w.to_mont(a, ring.q, ring.pinv, ring.r2)
        key_q.append(torch.stack([bm[:Lq], am[:Lq]]))
        key_p.append(torch.stack([bm[Lq:], am[Lq:]]))
    return KeySwitchKey(key_q=torch.stack(key_q), key_p=torch.stack(key_p),
                        level=Lq - 1, sp_level=Lp - 1)


def gen_relin_key(rng, sk: SecretKey, q_moduli, p_moduli, n: int, device,
                  word_bits: int = 32) -> KeySwitchKey:
    """Relinearization key: s' = s^2."""
    def s2_ntt(moduli):
        ring = get_rns_ring(moduli, n, device, word_bits)
        s = sk.ntt_form(moduli, n, device, word_bits)
        return ring.word.mulmod(s, s, ring.q, ring.pinv, ring.r2)
    return gen_keyswitch_key(rng, sk, s2_ntt, q_moduli, p_moduli, n, device, word_bits)


def gen_galois_key(rng, sk: SecretKey, galois_elt: int, q_moduli, p_moduli, n: int,
                   device, word_bits: int = 32) -> KeySwitchKey:
    """Galois key for element g: s' = σ_g(s)."""
    def sg_ntt(moduli):
        ring = get_rns_ring(moduli, n, device, word_bits)
        s_rns = lift_to(sk.coeffs, moduli, device)
        return ntt_mod.ntt(apply_automorphism_coeff(s_rns, ring.q, n, galois_elt), ring)
    return gen_keyswitch_key(rng, sk, sg_ntt, q_moduli, p_moduli, n, device, word_bits)
