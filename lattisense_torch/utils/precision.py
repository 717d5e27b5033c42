"""CKKS precision statistics: a copy of ``lattisense_tpu/utils/precision.py``
(no JAX there; the port keeps its own copy).

After the reference's fhe_ops_lib/precision.{h,cpp}: Lattigo-style
PrecisionStats — min/max/mean/median delta and log2 precision for
real/imag/L2, the error STD in the slot (freq) and coefficient (time)
domains, and the precision CDF. CKKS results are held to these bounds, not
compared bit for bit.
"""

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Stats:
    real: float = 0.0
    imag: float = 0.0
    l2: float = 0.0


@dataclass
class DistEntry:
    prec: float
    count: int


@dataclass
class PrecisionStats:
    max_delta: Stats = field(default_factory=Stats)
    min_delta: Stats = field(default_factory=Stats)
    max_precision: Stats = field(default_factory=Stats)
    min_precision: Stats = field(default_factory=Stats)
    mean_delta: Stats = field(default_factory=Stats)
    mean_precision: Stats = field(default_factory=Stats)
    median_delta: Stats = field(default_factory=Stats)
    median_precision: Stats = field(default_factory=Stats)
    std_freq: float = 0.0
    std_time: float = 0.0
    real_dist: list = field(default_factory=list)
    imag_dist: list = field(default_factory=list)
    l2_dist: list = field(default_factory=list)
    cdf_resol: int = 500

    def __str__(self) -> str:
        def row(name, s):
            return f'│{name:<9}│ {s.real:5.2f} │ {s.imag:5.2f} │ {s.l2:5.2f} │'
        lines = [
            '┌─────────┬───────┬───────┬───────┐',
            '│  Log2   │ REAL  │ IMAG  │  L2   │',
            '├─────────┼───────┼───────┼───────┤',
            row('MIN Prec', self.min_precision),
            row('MAX Prec', self.max_precision),
            row('AVG Prec', self.mean_precision),
            row('MED Prec', self.median_precision),
            '└─────────┴───────┴───────┴───────┘',
            f'Err STD Slots  : {np.log2(max(self.std_freq, 1e-300)):5.2f} Log2',
            f'Err STD Coeffs : {np.log2(max(self.std_time, 1e-300)):5.2f} Log2',
        ]
        return '\n'.join(lines)


def _delta_to_precision(delta: Stats) -> Stats:
    return Stats(np.log2(1.0 / max(delta.real, 1e-16)),
                 np.log2(1.0 / max(delta.imag, 1e-16)),
                 np.log2(1.0 / max(delta.l2, 1e-16)))


def _calc_cdf(precs: np.ndarray, resol: int) -> list[DistEntry]:
    if precs.size == 0:
        return []
    lo, hi = precs.min(), precs.max()
    out = []
    sorted_precs = np.sort(precs)
    for i in range(resol):
        cur = lo + (hi - lo) * i / resol
        out.append(DistEntry(cur, int(np.searchsorted(sorted_precs, cur,
                                                      side='right'))))
    return out


def get_precision_stats(want, test, scale: float | None = None,
                        n: int | None = None) -> PrecisionStats:
    """Compare expected vs decrypted complex slot vectors
    (reference: PrecisionAnalyzer::GetPrecisionStats)."""
    want = np.asarray(want, dtype=np.complex128)
    test = np.asarray(test, dtype=np.complex128)
    if want.shape != test.shape:
        raise ValueError('Input vectors must have the same size')
    diff = test - want
    d_real = np.maximum(np.abs(diff.real), 1e-16)
    d_imag = np.maximum(np.abs(diff.imag), 1e-16)
    d_l2 = np.maximum(np.abs(diff), 1e-16)

    p = PrecisionStats()
    p.max_delta = Stats(d_real.max(), d_imag.max(), d_l2.max())
    p.min_delta = Stats(d_real.min(), d_imag.min(), d_l2.min())
    p.mean_delta = Stats(d_real.mean(), d_imag.mean(), d_l2.mean())
    p.median_delta = Stats(float(np.median(d_real)), float(np.median(d_imag)),
                           float(np.median(d_l2)))
    p.min_precision = _delta_to_precision(p.max_delta)
    p.max_precision = _delta_to_precision(p.min_delta)
    p.mean_precision = _delta_to_precision(p.mean_delta)
    p.median_precision = _delta_to_precision(p.median_delta)

    # error STD in the slot domain (freq) and coefficient domain (time):
    # the canonical embedding is a scaled isometry, std_time = std_freq/sqrt(n)
    err = diff - diff.mean()
    p.std_freq = float(np.sqrt(np.mean(np.abs(err) ** 2)))
    slots = want.size
    p.std_time = p.std_freq / np.sqrt((n or 2 * slots) / (2 * slots)) \
        if slots else 0.0

    p.real_dist = _calc_cdf(np.log2(1.0 / d_real), p.cdf_resol)
    p.imag_dist = _calc_cdf(np.log2(1.0 / d_imag), p.cdf_resol)
    p.l2_dist = _calc_cdf(np.log2(1.0 / d_l2), p.cdf_resol)
    return p
