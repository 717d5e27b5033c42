"""The bootstrap's reference: what Lattigo's N16QP1546H192H32 bootstrapping
parameters imply, written out from the parameters alone.

- ``evalmod``: the float64 EvalMod function the bootstrap approximates, the
  Chebyshev series of degree ``sine_deg`` of the scaled cosine
  cos(2π(2K·2^r·y − 1/4)/2^r) on [-2^-(r+1), 2^-(r+1)], then r double angles
  v → 2v² − 1 (Bossuat, Mouchet, Troncoso-Pastoriza, Hubaux, EUROCRYPT 2021).
- ``published_levels``: the level budget of the published plan:
  CoeffsToSlots ``cts_depth``, EvalMod ⌈log2(deg+1)⌉ + r, SlotsToCoeffs
  ``stc_depth``, and nothing for the merge of the two halves (×i is the
  monomial X^{n/2}) or for the return to the input's scale.
- ``dft_groups``: each CoeffsToSlots or SlotsToCoeffs group's diagonal
  offsets and its baby-step giant-step split, from the radix-2 stages of the
  slots' DFT merged ``depth`` ways and the split rule of the parameters'
  ``bsgs_ratio``.
- ``chebyshev_products``: the ciphertext products and constant products of
  the published plan's Chebyshev evaluation, level by level.
- ``float8_e4m3``: the control, the message rounded through float8-e4m3.

Plain NumPy and PyTorch; nothing here imports the program.
"""

import numpy as np
import torch


def evalmod_coeffs(k: int, double_angle: int, degree: int) -> np.ndarray:
    """The Chebyshev coefficients (degree + 1) of the scaled cosine on its
    interval, mapped to [-1, 1], from the Chebyshev nodes."""
    r = double_angle
    a = 1.0 / 2 ** (r + 1)
    j = np.arange(degree + 1)
    nodes = np.cos(np.pi * (j + 0.5) / (degree + 1))
    vals = np.cos(2 * np.pi * (2.0 * k * 2 ** r * a * nodes - 0.25) / 2 ** r)
    coeffs = np.array([2.0 / (degree + 1) * np.sum(vals * np.cos(np.pi * i * (j + 0.5) /
                                                                  (degree + 1)))
                       for i in range(degree + 1)])
    coeffs[0] /= 2.0
    return coeffs


def chebyshev(coeffs, x):
    """Σ c_i·T_i(x) by Clenshaw's recurrence, x in [-1, 1]."""
    x = np.asarray(x, dtype=np.float64)
    b1 = b2 = np.zeros_like(x)
    for c in coeffs[:0:-1]:
        b1, b2 = 2 * x * b1 - b2 + c, b1
    return x * b1 - b2 + coeffs[0]


def evalmod(y, k: int, double_angle: int, degree: int):
    """The series at y (on [-2^-(r+1), 2^-(r+1)]), then the double angles."""
    a = 1.0 / 2 ** (double_angle + 1)
    v = chebyshev(evalmod_coeffs(k, double_angle, degree), np.asarray(y) / a)
    for _ in range(double_angle):
        v = 2 * v * v - 1
    return v


def chebyshev_depth(degree: int) -> int:
    """⌈log2(deg + 1)⌉."""
    return int(degree).bit_length()


def published_levels(b: dict) -> dict:
    """The levels each stage of the published plan spends, for the
    configuration's ``bootstrap`` settings."""
    return {'raise': 0, 'cts': b['cts_depth'],
            'evalmod': chebyshev_depth(b['sine_deg']) + b['double_angle'],
            'stc': b['stc_depth']}


def merge_schedule(log_s: int, depth: int) -> list[int]:
    """log_s radix-2 stages over ``depth`` groups, the later groups no
    larger than the earlier."""
    out, left = [], log_s
    for i in range(depth):
        d = -(-left // (depth - i))
        out.append(d)
        left -= d
    return out


def _split(offsets: set, slots: int, ratio: float) -> int:
    """The baby window n1: the smallest power of two whose baby / giant
    count ratio reaches ``ratio`` (the one before, where it passes it)."""
    n1 = 1
    while n1 < slots:
        giants = len({(o // n1) * n1 for o in offsets})
        babies = len({o % n1 for o in offsets})
        r = (babies - 1) / (giants - 1)
        if r == ratio:
            return n1
        if r > ratio:
            return n1 // 2
        n1 <<= 1
    return 1


def dft_groups(slots: int, depth: int, cts: bool, ratio: float) -> list[dict]:
    """Each group of the transform in the order applied: its diagonal
    offsets (``diagonals``), the baby window ``n1``, and the rotations it
    runs: ``babies`` (hoisted, one decomposition a group) and ``giants``.
    CoeffsToSlots runs the inverse stages from distance slots/2 down to 1;
    SlotsToCoeffs the forward stages from 1 up, merged the other way."""
    log_s = slots.bit_length() - 1
    if cts:
        dists, sched = [slots >> (i + 1) for i in range(log_s)], merge_schedule(log_s, depth)
    else:
        dists, sched = [1 << i for i in range(log_s)], merge_schedule(log_s, depth)[::-1]
    out, i = [], 0
    for cnt in sched:
        offs = {0}
        for d in dists[i:i + cnt]:
            offs = {(o + e) % slots for o in offs for e in (0, d, -d)}
        i += cnt
        n1 = _split(offs, slots, ratio)
        out.append({'diagonals': len(offs), 'n1': n1,
                    'babies': len({o % n1 for o in offs} - {0}),
                    'giants': len({(o // n1) * n1 for o in offs} - {0})})
    return out


def chebyshev_products(degree: int) -> dict:
    """The published plan's Chebyshev evaluation of a pre-normalized operand
    at level 0 (levels count down from it, as negatives): ``mult`` the
    levels at which two ciphertexts multiply (each then relinearized and
    rescaled), ``const`` the levels of the constant products, ``rescale``
    the levels of the rescales that close the leaves. The basis: T_i at
    level -⌈log2 i⌉ for the babies i ≤ 2^bl, bl = ⌈m/2⌉ with m the bits of
    the degree, and for the giants 2^(bl+1) .. 2^(m-1); each one product of
    two basis entries. The series: a leaf where every term's entry sits a
    level above its target, else the split at the largest power of two."""
    m = max(int(degree).bit_length(), 1)
    bl = (m + 1) // 2
    keys = sorted(set(range(1, (1 << bl) + 1)) | {1 << g for g in range(bl, m)})
    depth = {i: -(i - 1).bit_length() for i in keys}
    out = {'mult': [depth[i] + 1 for i in keys if i > 1], 'const': [], 'rescale': []}

    def terms(lo, hi):
        return [i for i in range(lo, hi + 1)]

    def rec(deg, target):
        up = target + 1
        if all(i in depth and depth[i] >= up for i in terms(1, deg)):
            out['const'] += [up] * deg
            out['rescale'].append(up)
            return
        g = 1 << (deg.bit_length() - 1)
        if deg - g >= 1:
            rec(deg - g, up)
            out['mult'].append(up)
        else:
            out['const'].append(up)
            out['rescale'].append(up)
        if g - 1 >= 1:
            rec(g - 1, target)

    rec(degree, -chebyshev_depth(degree))
    return out


def float8_e4m3(x) -> np.ndarray:
    """Complex x with each part rounded to float8-e4m3 (3 mantissa bits)."""
    def r(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64)).to(
            torch.float8_e4m3fn).double().numpy()
    return r(x.real) + 1j * r(x.imag)
