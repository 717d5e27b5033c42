"""FHE data carriers: plain dataclasses holding int64 tensors.

Ports of the carriers of ``lattisense_tpu/schemes/types.py``, without the
JAX pytree registration. A ciphertext's ``data`` may carry leading batch
dimensions: (B, degree+1, L, n). ``scale`` is the CKKS scale (host
metadata; BFV leaves it at 1.0).

- Plaintext      : BFV Δ·m over Q_ℓ, coefficient domain; CKKS Δ·m, NTT domain.
- PlaintextRingt : one component (BFV m mod t; CKKS small signed scaled
                   integer coefficients), lifted to the chain at op time.
- PlaintextMul   : NTT + Montgomery form over Q_ℓ, the cheapest ct·pt multiply.
"""

from dataclasses import dataclass, field
from typing import Any


@dataclass
class Plaintext:
    data: Any                 # (L, n): Δ·m over Q_ℓ
    level: int
    is_ntt: bool = False
    scale: float = 1.0        # CKKS only


@dataclass
class PlaintextRingt:
    data: Any                 # (n,): BFV m mod t; CKKS signed int64 coefficients
    scale: float = 1.0        # CKKS only


@dataclass
class PlaintextMul:
    data: Any                 # (L, n): NTT + Montgomery form of m over Q_ℓ
    level: int
    scale: float = 1.0        # CKKS only


@dataclass
class Ciphertext:
    data: Any                 # (..., degree+1, L, n)
    level: int
    is_ntt: bool = False
    is_mform: bool = False
    scale: float = 1.0        # CKKS only

    @property
    def degree(self) -> int:
        return self.data.shape[-3] - 1


@dataclass
class DecomposedCiphertext:
    """A ciphertext whose c1 is already digit-decomposed, mod-upped and in the
    NTT domain, for hoisted rotations: the expensive half of every key switch
    is paid once and shared by all rotations of this ciphertext."""
    c0: Any                   # (..., L, n), in the source ciphertext's domain
    digits: Any               # (..., β, L+|P|, n), NTT domain over Q_ℓ ∪ P
    level: int
    is_ntt: bool = False      # domain of c0
    is_mform: bool = False
    scale: float = 1.0

    degree = 1


@dataclass
class KeySwitchKey:
    """Hybrid key-switching key: β digits over Q_full ∪ P, NTT+Montgomery."""
    key_q: Any                # (β, 2, Lq_full, n)
    key_p: Any                # (β, 2, |P|, n)
    level: int = -1
    sp_level: int = -1


@dataclass
class PublicKey:
    data: Any                 # (2, Lq_full, n), NTT domain


@dataclass
class GaloisKeys:
    keys: dict = field(default_factory=dict)   # galois element -> KeySwitchKey
