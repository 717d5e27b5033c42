"""The frozen yardstick equals the work functions the kernels' bring-up
measured with (``chip_smoke.py``), at the shapes of PERF.md's kernel table,
and the integer peak is 64 a clock an SM."""

import importlib.util
import os

import pytest

from portbench import work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N, N32K, N64K = 16384, 32768, 65536


@pytest.fixture(scope='module')
def smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHAPES = [
    ('ntt_work', (32 * 4 * 8 + 32 * 4 * 11 + 32 * 2 * 12, 19, N)),
    ('ntt_work', (37 * 12, 12, N64K)),
    ('ntt_work', (32 * 22, 22, N32K)),
    ('behz_work', (128, 8, 11, N)),
    ('behz_work', (128, 22, 25, N32K)),
    ('behz_work', (16, 22, 25, N64K)),
    ('ksw_work', (32, 8, 4, 2, N)),
    ('ksw_work', (32, 22, 6, 4, N32K)),
    ('ksw_work', (32, 11, 3, 4, N, True)),
    ('ksw_work', (2, 48, 4, 12, N64K)),
    ('finish_work', (96, 8, 11, N)),
    ('finish_work', (96, 22, 25, N32K)),
    ('ntt64_work', (32 * 4 * 4 + 32 * 4 * 6 + 32 * 2 * 6, 10, N, False)),
    ('ntt64_work', (32 * 3 * 4 + 32 * 3 * 6 + 32 * 2 * 6, 10, N, True)),
    ('ntt64_work', (37 * 12, 12, N64K, True)),
    ('bconv64_work', (64, 2, 4, N)),
    ('bconv64_work', (128, 12, 14, N32K)),
    ('ksw64_work', (32, 2, 6, N)),
    ('ksw64_work', (32, 4, 15, N32K)),
]


@pytest.mark.parametrize('fn,args', SHAPES, ids=[f'{f}{a}' for f, a in SHAPES])
def test_copies_match_chip_smoke(smoke, fn, args):
    assert getattr(work, fn)(*args) == getattr(smoke, fn)(*args)


def test_constants_match_chip_smoke(smoke):
    for k in ('OPS_SHOUP', 'OPS_ADDSUB', 'OPS_MONT', 'OPS_BUTTERFLY', 'OPS64_SHOUP',
              'OPS64_ADDSUB', 'OPS64_MONT', 'OPS64_BUTTERFLY', 'PEAK_BYTES_S'):
        assert getattr(work, k) == getattr(smoke, k)
    assert work.INT32_PER_CLOCK_SM == smoke.IMAD_PER_CLOCK_SM == 64


def test_b3_bound_at_both_peaks(smoke):
    """B3 at (32,8,16384): 0.052 ms against the float32 rate that PERF.md's
    "(ops)" shares used, 0.209 ms against the integer rate."""
    w = work.ksw_work(32, 8, 4, 2, N)
    assert smoke.bound(*w) == (pytest.approx(0.0522, abs=1e-4), 'operations')
    peak = work.int32_peak(132, 1.98e9)
    assert peak == 64 * 132 * 1.98e9
    assert work.least_s(w, peak) * 1e3 == pytest.approx(0.2088, abs=1e-3)


def test_composites_add_their_parts():
    B, L, T, n = 32, 8, 11, N
    mult = work.bfv_mult_work(B, L, T, n)
    assert mult[1] == (work.behz_work(4 * B, L, T, n)[1] + work.finish_work(3 * B, L, T, n)[1]
                       + B * (L + T) * n * (4 * work.OPS_MONT + work.OPS_ADDSUB))
    assert mult[0] == 8.0 * n * (7 * B * L + 2 * (L + T))
    relin = work.bfv_relin_work(B, L, 4, n)
    ksw = work.ksw_work(B, L, 4, 2, n)
    assert relin == (ksw[0] + 16.0 * B * L * n, ksw[1] + 2.0 * B * L * n * work.OPS_ADDSUB)
    # a key switch of more limbs is more work, on both words
    assert work.ckks_relin_work(B, 10, 5, N64K)[1] > work.ckks_relin_work(B, 5, 5, N64K)[1] > 0
    assert work.ckks_rescale_work(B, 10, N64K)[1] > work.ckks_mult_work(B, 10, N64K)[1] > 0


def test_least_time_takes_the_slower_bound():
    peak = work.int32_peak(132, 1.98e9)
    assert work.least_s((3.35e12, 0.0), peak) == 1.0
    assert work.least_s((0.0, peak * 2), peak) == 2.0
    assert work.least_s((3.35e12, peak * 2), peak) == 2.0
