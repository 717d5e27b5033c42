"""lattisense_torch's bootstrap under the published level plan
(``BootstrapConfig(level_plan='published')``), on the CPU.

The plan departs from the JAX package's on purpose, so these tests hold it
to plain math and to its level count, not to the JAX package: the Chebyshev
series at ⌈log2(deg+1)⌉ levels against the benchmark's float64 EvalMod
series (``portbench/reference/bootstrap.py``), ×X^{n/2} against the plain
negacyclic shift and against i·m, and a whole bootstrap of a batch through
``make_batched_step`` with Lattigo's N16QP1546H192H32 settings (CoeffsToSlots
4, Chebyshev degree 30, 3 double angles, SlotsToCoeffs 3) on a 20-prime
64-bit chain at n = 128: its output level, scale, message, spans and
``min_levels``.
"""

import numpy as np
import pytest
import torch

from lattisense_torch.core.modring import gen_ntt_primes
from lattisense_torch.parallel.batch import ckks_bootstrap, make_batched_step
from lattisense_torch.params import CkksParams
from lattisense_torch.runtime import CkksBtpContext, CkksContext
from lattisense_torch.schemes import bootstrap_params as bp
from lattisense_torch.schemes import poly_eval as pe
from lattisense_torch.schemes.bootstrap import BootstrapConfig, CkksBootstrapper
from lattisense_torch.schemes.ckks import mul_monomial_plain
from lattisense_torch.schemes.types import Ciphertext
from lattisense_torch.utils import observability as obs
from portbench.reference import bootstrap as ref_btp

N = 128
CFG = dict(cts_depth=4, stc_depth=3, k=16, sine_deg=30, double_angle=3)
SPENT = 4 + 5 + 3 + 3                      # CoeffsToSlots, ⌈log2 31⌉, double angles, StC


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope='module')
def small():
    """n = 64, a 61-bit base and ten 50-bit primes at scale 2^50."""
    n = 64
    big = gen_ntt_primes(n, 61, 2)
    mids = gen_ntt_primes(n, 50, 10)
    params = CkksParams.create_custom(n, [big[0]] + mids, [big[1]], scale=float(1 << 50))
    return CkksContext.create_random_context(params, seed=5, device='cpu')


def chain(n: int = N, primes: int = 19):
    q0 = gen_ntt_primes(n, 61, 1)
    p = gen_ntt_primes(n, 61, 3, exclude=tuple(q0))
    return CkksParams.create_custom(n, q0 + gen_ntt_primes(n, 60, primes), p[1:],
                                    slots=n // 2, scale=float(1 << 45))


@pytest.fixture(scope='module')
def btp_ctx():
    return CkksBtpContext.create_random_context(
        chain(), seed=71, h=32, btp_config=BootstrapConfig(**CFG, level_plan='published'),
        device='cpu', output_level=19 - SPENT)


@pytest.mark.parametrize('degree', [7, 15, 30])
def test_chebyshev_spends_log_depth(small, degree):
    """The series of the configuration's cosine at ``degree`` lands
    ⌈log2(deg+1)⌉ levels down, on the plan's scale, and decodes to the
    float64 series. Tolerance 1e-5: at scale 2^50 each basis entry carries
    ~2^-40 of noise and rounding, the largest coefficients of these series
    are below 2, and the sum over 31 terms and five rescales stays under
    1e-8; 1e-5 leaves room for that and none for a wrong coefficient (the
    smallest coefficient that matters is above 1e-4)."""
    coeffs = ref_btp.evalmod_coeffs(16, 3, degree)
    ev = pe.ChebyshevEvaluator(small.engine, coeffs, -1.0, 1.0, pre_normalized=True,
                               plan='published')
    top, anchor = small.params.max_level, small.params.scale
    x = np.random.default_rng(degree).uniform(-1, 1, small.params.slots)
    ct = small.encrypt(small.encode(x, top, scale=ev.planned_scale(top, anchor)))
    out = ev(ct, small.rlk, anchor=anchor)
    want = int(np.ceil(np.log2(degree + 1)))
    assert top - out.level == want == ev.levels_spent() == ref_btp.chebyshev_depth(degree)
    assert out.scale == ev.planned_scale(out.level, anchor)
    got = small.decrypt_decode(out)
    assert np.abs(got - ref_btp.chebyshev(coeffs, x)).max() < 1e-5
    # the reference plan spends one level more at each of these degrees
    ref = pe.ChebyshevEvaluator(small.engine, coeffs, -1.0, 1.0, pre_normalized=True)
    assert ref.levels_spent() == want + 1


def test_monomial_is_the_negacyclic_shift(small):
    """×X^k in the NTT domain equals the shift of the coefficients bit for
    bit, across the wrap (k ≥ n negates); ×X^{n/2} decodes to i·m."""
    eng = small.engine
    n, level = small.params.n, small.params.max_level
    m = (np.random.default_rng(1).uniform(-1, 1, small.params.slots)
         + 1j * np.random.default_rng(2).uniform(-1, 1, small.params.slots))
    ct = small.encrypt(small.encode(m, level))
    ring = eng.ring(level)
    for k in (1, 5, n // 2, n - 1, n + 3, 2 * n - 1):
        got = eng.mul_monomial(ct, k)
        assert torch.equal(got.data, mul_monomial_plain(ct.data, k, ring))
        assert (got.level, got.scale) == (ct.level, ct.scale)
    coeffs = eng.decrypt(small.sk, ct)
    shifted = eng.decrypt(small.sk, eng.mul_monomial(ct, 3))
    assert np.array_equal(shifted[3:], coeffs[:-3]) and np.array_equal(shifted[:3], -coeffs[-3:])
    i_m = small.decrypt_decode(eng.mul_monomial(ct, n // 2))
    assert np.abs(i_m - 1j * m).max() < 1e-6


def test_published_bootstrap_of_a_batch(btp_ctx):
    """Two ciphertexts through ``make_batched_step(engine, ckks_bootstrap, 0,
    1)``: the output at max_level − (4 + ⌈log2 31⌉ + 3 + 3) = 4, at the
    caller's scale, each within 1e-4 of its message. The JAX package's
    bound at its own n = 256 fixtures is 5e-3; this chain reads ~3e-6, and
    1e-4 leaves room for the seed and none for a lost bit of the plan. The
    spans: ``btp.bootstrap`` under ``step`` with its four stages, whose
    levels add up to 15, and ``min_levels()`` is what was spent."""
    ctx = btp_ctx
    btp = ctx.engine.bootstrapper
    assert btp.min_levels() == SPENT
    rng = np.random.default_rng(3)
    msgs = [rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2) for _ in range(2)]
    a = torch.stack([ctx.encrypt(ctx.encode(m, 0)).data for m in msgs])
    keys = {'rlk': ctx.rlk, 'glk': ctx.glk.keys, 'swk': dict(ctx.swk)}
    step = make_batched_step(ctx.engine, ckks_bootstrap, 0, 1, is_ntt=True)
    obs.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = step(a, keys)
    level = ctx.params.max_level - SPENT
    assert out.shape == (2, 2, level + 1, N)
    for data, m in zip(out, msgs):
        ct = Ciphertext(data=data, level=level, is_ntt=True, scale=ctx.params.scale)
        assert np.abs(ctx.decrypt_decode(ct) - m).max() < 1e-4
    spans = obs.spans()
    obs.reset()
    byname = {s['name']: s for s in spans if s['name'].startswith('btp.')}
    root = byname['btp.bootstrap']
    assert spans[root['parent']]['name'] == 'step'
    assert root['attrs'] == {'batch': 2, 'plan': 'published', 'level_in': 0,
                             'level_out': level}
    stages = ['btp.raise', 'btp.cts', 'btp.evalmod', 'btp.stc']
    assert [s['name'] for s in spans if s['parent'] == root['id']] == stages
    assert [byname[s]['attrs']['levels'] for s in stages] == [0, 4, 8, 3]
    assert sum(byname[s]['attrs']['levels'] for s in stages) == SPENT == btp.min_levels()
    assert {s['name'] for s in spans} >= {'lt.apply', 'ckks.apply_galois'}
    lt = next(s for s in spans if s['name'] == 'lt.apply')
    assert set(lt['attrs']) == {'diagonals', 'n1', 'hoisted'}


def test_published_segments_and_folded_steer(btp_ctx):
    """No steer and no steering product: the segments end with SlotsToCoeffs,
    whose last group lands on the caller's scale, and the merge spends no
    level."""
    btp = btp_ctx.engine.bootstrapper
    names = [name for name, _ in btp.segments(float(1 << 40))]
    assert names[-4:] == ['merge', 'stc0', 'stc1', 'stc2'] and 'steer' not in names
    assert [s for s in names if s.startswith('evalmod')] == ['evalmod_b', 'evalmod_g',
                                                             'evalmod_e', 'evalmod_da']


def test_a_chain_too_short_raises(btp_ctx):
    """Asked for one level more than the plan leaves, the bootstrapper
    refuses at construction; an unknown plan too."""
    eng = btp_ctx.engine
    with pytest.raises(ValueError, match='below the 5 asked for'):
        CkksBootstrapper(eng, BootstrapConfig(**CFG, level_plan='published'), output_level=5)
    with pytest.raises(ValueError, match='unknown level plan'):
        CkksBootstrapper(eng, BootstrapConfig(**CFG, level_plan='lattigo'))


def test_evalmod_depth_describes_the_published_plan():
    """The frontend's ``EvalModParams.depth()`` (Lattigo's figure) is what
    the published plan's EvalMod spends at the full profile's settings; the
    reference plan spends one more."""
    em = bp.full_profile().eval_mod_params
    coeffs = ref_btp.evalmod_coeffs(em.k, em.double_angle, em.sine_deg)
    for plan, extra in (('published', 0), ('reference', 1)):
        ev = pe.ChebyshevEvaluator(None, coeffs, -1.0, 1.0, pre_normalized=True, plan=plan)
        assert ev.levels_spent() + em.double_angle == em.depth() + extra
