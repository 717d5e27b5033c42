"""The CUDA kernels of lattisense_torch against their plain PyTorch twins.

These need the card (a CUDA kernel has no CPU mode) and skip without one.
The file imports no JAX, so it also runs where only PyTorch is installed:
``python -m pytest --noconftest tests/test_torch_cuda.py`` on the card.
"""

import numpy as np
import pytest
import torch

from lattisense_torch.core import u64 as tu
from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_torch.ops import behz_cuda, ntt_cuda
from lattisense_torch.params import BfvParams
from lattisense_torch.parallel.batch import bfv_mult_relin, key_tree, make_batched_step
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes.bfv import BfvEngine
from lattisense_torch.schemes.types import KeySwitchKey

CPU = torch.device('cpu')


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernel has no CPU mode)')
    return torch.device('cuda', torch.cuda.current_device())


def residues(seed, moduli, n, lead=()):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.integers(0, q, (*lead, n), dtype=np.int64)
                                      for q in moduli], axis=-2))


@pytest.mark.parametrize('n,rows', [(256, 3), (16384, 12)])
def test_b1_kernel_matches_plain(cuda, n, rows):
    chain = tuple(gen_ntt_primes(n, 31, rows))
    ring_c, ring_g = get_rns_ring(chain, n, CPU), get_rns_ring(chain, n, cuda)
    x = residues(7, chain, n, (4,))
    before = dict(ntt_cuda.launches)
    f = ntt_cuda.ntt32_fwd(x.to(cuda), ring_g)
    fm = ntt_cuda.ntt32_fwd(x.to(cuda), ring_g, to_mont=True)
    i = ntt_cuda.ntt32_inv(f, ring_g)
    torch.cuda.synchronize()
    assert torch.equal(f.cpu(), ntt_cuda.ntt_plain(x, ring_c))
    assert torch.equal(fm.cpu(), ntt_cuda.ntt_plain(x, ring_c, to_mont=True))
    assert torch.equal(i.cpu(), x)
    assert ntt_cuda.launches['ntt32_fwd'] == before['ntt32_fwd'] + 2
    assert ntt_cuda.launches['ntt32_inv'] == before['ntt32_inv'] + 1
    with pytest.raises(ValueError):
        ntt_cuda.ntt32_fwd(x.to(cuda).transpose(0, 1), ring_g)


def test_b2_kernel_matches_plain(cuda):
    n = 1024
    chain = tuple(gen_ntt_primes(n, 31, 6))
    params = BfvParams.create_custom(n, 65537, list(chain[:5]), [chain[5]])
    bz_c, bz_g = BfvEngine(params, CPU).behz(4), BfvEngine(params, cuda).behz(4)
    x = residues(8, bz_c.ring_q.moduli, n, (2, 4))
    fq, fa = behz_cuda.behz_prep32(x.to(cuda), bz_g)
    torch.cuda.synchronize()
    want_fq, want_fa = behz_cuda.behz_prep_plain(x, bz_c)
    assert torch.equal(fq.cpu(), want_fq) and torch.equal(fa.cpu(), want_fa)
    assert torch.equal(tu.from_mont(fq.cpu(), bz_c.ring_q.q, bz_c.ring_q.pinv),
                       ntt_cuda.ntt_plain(x, bz_c.ring_q))


def test_batched_mult_relin_card_matches_cpu(cuda):
    n = 4096
    chain = gen_ntt_primes(n, 31, 6)
    params = BfvParams.create_custom(n, 65537, chain[:4], chain[4:])
    ctx = BfvContext.create_random_context(params, seed=5, device=cuda)
    rng = np.random.default_rng(5)
    ma, mb = rng.integers(0, params.t, (2, 2, n))
    a = torch.stack([ctx.encrypt(ctx.encode(m, 3)).data for m in ma])
    b = torch.stack([ctx.encrypt(ctx.encode(m, 3)).data for m in mb])
    out = make_batched_step(ctx.engine, bfv_mult_relin, 3)(a, b, key_tree(ctx))
    keys = {'rlk': KeySwitchKey(key_q=ctx.rlk.key_q.cpu(), key_p=ctx.rlk.key_p.cpu())}
    want = make_batched_step(BfvEngine(params, CPU), bfv_mult_relin, 3)(a.cpu(), b.cpu(), keys)
    assert torch.equal(out.cpu(), want)
