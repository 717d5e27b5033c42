"""``CkksBootstrapper.min_levels()`` under the default (reference) level plan
is what a bootstrap spends, on the CPU: a whole bootstrap with Lattigo's
N16QP1546H192H32 settings on a 20-prime 64-bit chain at n = 128, whose
output level is the chain's top less ``min_levels()``. The plan's values
stay the JAX package's, bit for bit (``tests/test_torch_bootstrap.py``);
here only its count is held, beside the published plan's
(``tests/test_torch_btp_published.py``).
"""

import numpy as np
import pytest
import torch

from lattisense_torch.core.modring import gen_ntt_primes
from lattisense_torch.params import CkksParams
from lattisense_torch.runtime import CkksBtpContext
from lattisense_torch.schemes.bootstrap import BootstrapConfig

N = 128
CFG = dict(cts_depth=4, stc_depth=3, k=16, sine_deg=30, double_angle=3)


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_reference_plan_spends_min_levels():
    """4 (CoeffsToSlots) + 6 (the Chebyshev series) + 3 (double angles) + 1
    (×i as a constant product) + 3 (SlotsToCoeffs) + 1 (the steer) = 18;
    the default plan is the reference one. The message comes back within
    the JAX package's bound at its own fixtures, 5e-3."""
    assert BootstrapConfig().level_plan == 'reference'
    q0 = gen_ntt_primes(N, 61, 1)
    p = gen_ntt_primes(N, 61, 3, exclude=tuple(q0))
    params = CkksParams.create_custom(N, q0 + gen_ntt_primes(N, 60, 19), p[1:], slots=N // 2,
                                      scale=float(1 << 45))
    ctx = CkksBtpContext.create_random_context(params, seed=72, h=32,
                                               btp_config=BootstrapConfig(**CFG),
                                               device='cpu', output_level=1)
    btp = ctx.engine.bootstrapper
    assert btp.min_levels() == 18
    rng = np.random.default_rng(4)
    m = rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
    ct = ctx.encrypt(ctx.encode(m, 0))
    out = ctx.bootstrap(ct)
    assert out.level == params.max_level - btp.min_levels() and out.scale == ct.scale
    assert np.abs(ctx.decrypt_decode(out) - m).max() < 5e-3
    assert [name for name, _ in btp.segments(ct.scale)][-1] == 'steer'
