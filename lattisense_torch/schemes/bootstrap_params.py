"""CKKS bootstrapping parameters: the reference profiles and the BSGS split.

The port's copy of what bootstrapping needs from the JAX package's frontend
(``lattisense_tpu/frontend/bootstrap_params.py`` and the bootstrap profiles
of ``frontend/custom_task.py``), which the port does not import:

- ``find_best_bsgs_split``: the baby-step window of a linear transform. The
  bootstrapper (``schemes/bootstrap.py``) splits its CoeffsToSlots and
  SlotsToCoeffs matrices with it, so a compiled task's signature, made by the
  frontend, registers exactly the Galois keys a bootstrap uses;
- ``EncodingMatrixParams.rotations`` and ``rotations_for_bootstrapping``: the
  slot rotations the frontend predicts for a profile;
- ``toy_profile()`` and ``full_profile()``: the standard bootstrapping chain
  (Lattigo's N16QP1546H192H32: 25 q and 5 p primes of 40-61 bits, scale
  2^40) at n = 8192 and at n = 2^16, with their CoeffsToSlots, SlotsToCoeffs
  and EvalMod fields.
"""

import math
from dataclasses import dataclass
from enum import Enum, auto


class LinearTransformType(Enum):
    CoeffsToSlots = auto()
    SlotsToCoeffs = auto()


class SineType(Enum):
    Sin = auto()
    Cos1 = auto()
    Cos2 = auto()


@dataclass
class EvalModParams:
    """EvalMod: the homomorphic reduction mod q by a scaled sine or cosine,
    with double-angle and arcsine corrections."""

    q: int
    level_start: int
    scaling_factor: float
    sine_type: SineType
    message_ratio: float
    k: int
    sine_deg: int
    double_angle: int
    arcsine_deg: int

    def depth(self) -> int:
        if self.sine_type == SineType.Cos1:
            d = math.ceil(math.log2(max(self.sine_deg, 2 * self.k - 1) + 1))
        else:
            d = math.ceil(math.log2(self.sine_deg + 1))
        return int(d) + self.double_angle + int(math.ceil(math.log2(self.arcsine_deg + 1)))


def _bsgs_split_counts(diag_index, slots: int, n1: int):
    """Distinct giant (n1-aligned) and baby rotations for the window n1."""
    giants, babies = set(), set()
    for rot in diag_index:
        rot &= slots - 1
        giants.add(((rot // n1) * n1) & (slots - 1))
        babies.add(rot & (n1 - 1))
    return len(giants), len(babies)


def find_best_bsgs_split(diag_index, max_n: int, max_ratio: float) -> int:
    """The smallest power-of-two n1 whose baby / giant count ratio reaches
    ``max_ratio``."""
    n1 = 1
    while n1 < max_n:
        nb1, nb2 = _bsgs_split_counts(diag_index, max_n, n1)
        ratio = (nb2 - 1) / (nb1 - 1)
        if ratio == max_ratio:
            return n1
        if ratio > max_ratio:
            return n1 // 2
        n1 <<= 1
    return 1


@dataclass
class EncodingMatrixParams:
    """The factorized DFT of CoeffsToSlots or SlotsToCoeffs."""

    linear_transform_type: LinearTransformType
    repack_imag_2_real: bool
    level_start: int
    bit_reversed: bool
    bsgs_ratio: float
    scaling_factor: list
    log_n: int = 0
    log_slots: int = 0

    def depth(self, actual: bool = True) -> int:
        if actual:
            return len(self.scaling_factor)
        return sum(len(lvl) for lvl in self.scaling_factor)

    def _stage_rot(self, level: int, n_mask: int) -> int:
        """The base rotation of one radix-2 DFT level."""
        cts_natural = (self.linear_transform_type == LinearTransformType.CoeffsToSlots
                       and not self.bit_reversed)
        stc_reversed = (self.linear_transform_type == LinearTransformType.SlotsToCoeffs
                        and self.bit_reversed)
        if cts_natural or stc_reversed:
            return (1 << (level - 1)) & n_mask
        return (1 << (self.log_slots - level)) & n_mask

    def _merge_schedule(self) -> list[int]:
        """How many radix-2 levels each factorized matrix absorbs."""
        max_depth = self.depth(actual=False)
        merge = [0] * max_depth
        remaining = self.log_slots
        for i in range(max_depth):
            d = math.ceil(remaining / (max_depth - i))
            if self.linear_transform_type == LinearTransformType.CoeffsToSlots:
                merge[i] = d
            else:
                merge[max_depth - i - 1] = d
            remaining -= d
        return merge

    def _expand(self, vec: dict, level: int, n_mask: int) -> dict:
        rot = self._stage_rot(level, n_mask)
        new = {}
        for i in vec:
            new[i] = True
            new[(i + rot) & n_mask] = True
            new[(i - rot) & n_mask] = True
        return new

    def dft_index_map(self) -> dict:
        """{matrix index: {rotation: True}}: the nonzero diagonals of each
        factorized DFT matrix."""
        merge = self._merge_schedule()
        sparse = self.log_slots < self.log_n - 1
        stc = self.linear_transform_type == LinearTransformType.SlotsToCoeffs
        out: dict = {}
        level = self.log_slots
        for i in range(len(merge)):
            if sparse and stc and i == 0 and self.repack_imag_2_real:
                # the first StC matrix also repacks imag into real: doubled slots
                vec = {0: True, (1 << self.log_slots): True}
                n_mask = (2 << self.log_slots) - 1
                vec = self._expand(vec, level, n_mask)
                nxt = level - 1
                for _ in range(merge[i] - 1):
                    vec = self._expand(vec, nxt, n_mask)
                    nxt -= 1
            else:
                rot = self._stage_rot(level, (1 << self.log_slots) - 1)
                vec = {0: True, rot: True, ((1 << self.log_slots) - rot): True}
                n_mask = (1 << self.log_slots) - 1
                nxt = level - 1
                for _ in range(merge[i] - 1):
                    vec = self._expand(vec, nxt, n_mask)
                    nxt -= 1
            out[i] = vec
            level -= merge[i]
        return out

    def rotations(self) -> list[int]:
        """Every slot rotation (Galois key) the transform needs."""
        rots: list[int] = []
        slots = 1 << self.log_slots
        dslots = slots
        sparse = self.log_slots < self.log_n - 1
        stc = self.linear_transform_type == LinearTransformType.SlotsToCoeffs
        if sparse and self.repack_imag_2_real:
            dslots <<= 1
            if self.linear_transform_type == LinearTransformType.CoeffsToSlots:
                rots.append(slots)
        for i, pvec in self.dft_index_map().items():
            n1 = find_best_bsgs_split(pvec, dslots, self.bsgs_ratio)
            repack = stc and sparse and i == 0 and self.repack_imag_2_real
            if len(pvec) < 3:
                for j in pvec:
                    if j not in rots:
                        rots.append(j)
                continue
            for j in pvec:
                giant = (j // n1) * n1
                giant &= (2 * slots - 1) if repack else (slots - 1)
                if giant != 0 and giant not in rots:
                    rots.append(giant)
                baby = j & (n1 - 1)
                if baby != 0 and baby not in rots:
                    rots.append(baby)
        return rots


# The standard Lattigo bootstrapping chain (N16QP1546H192H32), a public
# parameter set; the toy profile runs it at n = 8192.
BTP_Q = (
    0x10000000006E0001,
    0x10000140001, 0xFFFFE80001, 0xFFFFC40001, 0x100003E0001, 0xFFFFB20001,
    0x10000500001, 0xFFFF940001, 0xFFFF8A0001, 0xFFFF820001,
    0x7FFFE60001, 0x7FFFE40001, 0x7FFFE00001,
    0xFFFFFFFFF840001, 0x1000000000860001, 0xFFFFFFFFF6A0001, 0x1000000000980001,
    0xFFFFFFFFF5A0001, 0x1000000000B00001, 0x1000000000CE0001, 0xFFFFFFFFF2A0001,
    0x100000000060001, 0xFFFFFFFFF00001, 0xFFFFFFFFD80001, 0x1000000002A0001,
)
BTP_P = (
    0x1FFFFFFFFFE00001, 0x1FFFFFFFFFC80001, 0x1FFFFFFFFFB40001,
    0x1FFFFFFFFF500001, 0x1FFFFFFFFF420001,
)


@dataclass
class BtpProfile:
    """One bootstrapping profile: the chain, the scale, the slots and the
    CoeffsToSlots / SlotsToCoeffs / EvalMod fields of the reference's
    ``CkksBtpParam``."""

    n: int
    q: tuple = BTP_Q
    p: tuple = BTP_P
    scale: float = float(1 << 40)
    slots: int = 0
    cts_params: EncodingMatrixParams = None
    stc_params: EncodingMatrixParams = None
    eval_mod_params: EvalModParams = None
    btp_output_level: int = 9

    def __post_init__(self):
        self.slots = self.slots or self.n // 2
        self.max_level = len(self.q) - 1

    def rotations_for_bootstrapping(self) -> list[int]:
        return bootstrap_rotations(self.n, self.slots, self.cts_params, self.stc_params)


def bootstrap_rotations(n: int, slots: int, cts_params, stc_params) -> list[int]:
    """The slot rotations a bootstrap needs (the frontend's prediction,
    ``frontend/custom_task.py`` ``CkksBtpParam.rotations_for_bootstrapping``):
    the SubSum steps, then CoeffsToSlots' and SlotsToCoeffs' BSGS rotations."""
    log_n = int(math.log2(n))
    log_slots = int(math.log2(slots))
    for pp in (cts_params, stc_params):
        pp.log_n = log_n
        pp.log_slots = log_slots
    rots = [1 << i for i in range(log_slots, log_n - 1)]
    rots += cts_params.rotations()
    rots += stc_params.rotations()
    return list(set(rots))


def _profile(n: int) -> BtpProfile:
    return BtpProfile(
        n=n,
        stc_params=EncodingMatrixParams(
            linear_transform_type=LinearTransformType.SlotsToCoeffs,
            repack_imag_2_real=True, level_start=12, bsgs_ratio=2.0, bit_reversed=False,
            scaling_factor=[[0x7FFFE60001], [0x7FFFE40001], [0x7FFFE00001]]),
        eval_mod_params=EvalModParams(
            q=0x10000000006E0001, level_start=20, sine_type=SineType.Cos1,
            message_ratio=256.0, k=16, sine_deg=30, double_angle=3, arcsine_deg=0,
            scaling_factor=1 << 60),
        cts_params=EncodingMatrixParams(
            linear_transform_type=LinearTransformType.CoeffsToSlots,
            repack_imag_2_real=True, level_start=24, bsgs_ratio=2.0, bit_reversed=False,
            scaling_factor=[[0x100000000060001], [0xFFFFFFFFF00001], [0xFFFFFFFFD80001],
                            [0x1000000002A0001]]))


def toy_profile() -> BtpProfile:
    """The reference's toy bootstrap profile: the standard chain at n = 8192."""
    return _profile(8192)


def full_profile() -> BtpProfile:
    """The reference's full bootstrap profile: the standard chain at n = 2^16."""
    return _profile(1 << 16)


def reference_run(name: str) -> dict:
    """The JAX package's bootstrap runs of its three profiles
    (tests/test_bootstrap.py), as the port's ``CkksParams`` and
    ``BootstrapConfig`` fields: ``toy`` (:133-166, the toy profile, k = 20,
    sine_deg = 39, the profile's depths, EvalMod scale and message ratio),
    ``full`` (:228-252, the same at n = 2^16) and ``w32``
    (``CkksParams.create_tpu_btp_param(65536)``, :299-323: 48 q and 4 p
    31-bit primes, two limbs a level, the arcsine at ratio 8, the input
    encoded at level 1 and scale 2^40). Each with its secret weight h, seed,
    message seed, input level and scale, and the test's bounds on the
    decoded error and the output level."""
    from ..params import CkksParams
    from .bootstrap import BootstrapConfig
    run = dict(h=192, seed=77, msg_seed=7)
    if name in ('toy', 'full'):
        prof = toy_profile() if name == 'toy' else full_profile()
        n = prof.n
        em = prof.eval_mod_params
        run.update(
            params=CkksParams.create_custom(n, list(prof.q), list(prof.p), slots=n // 2,
                                            scale=prof.scale),
            config=BootstrapConfig(cts_depth=prof.cts_params.depth(),
                                   stc_depth=prof.stc_params.depth(), k=20, sine_deg=39,
                                   double_angle=em.double_angle,
                                   em_scale=float(em.scaling_factor),
                                   message_ratio=em.message_ratio),
            level=0, scale=prof.scale, max_err=1e-3 if name == 'toy' else 5e-2, min_level=5)
    elif name == 'w32':
        tpu = CkksParams.create_tpu_btp_param(1 << 16)
        n = tpu.n
        run.update(
            params=CkksParams.create_custom(n, list(tpu.q), list(tpu.p), slots=n // 2,
                                            scale=tpu.scale, word_bits=32),
            config=BootstrapConfig(cts_depth=3, stc_depth=3, k=20, sine_deg=39, double_angle=3,
                                   message_ratio=8.0, arcsine=True),
            level=1, scale=float(1 << 40), max_err=2e-5, min_level=8)
    else:
        raise ValueError(f'unknown bootstrap run {name!r}: toy, full or w32')
    return run
