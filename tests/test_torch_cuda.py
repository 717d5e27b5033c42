"""The CUDA kernels of lattisense_torch against their plain PyTorch twins.

These need the card (a CUDA kernel has no CPU mode) and skip without one.
Each kernel is checked at a small shape and at the main path's shape, with
its launch count and its refusal of bad input.
The file imports no JAX, so it also runs where only PyTorch is installed:
``python -m pytest --noconftest tests/test_torch_cuda.py`` on the card.
"""

import numpy as np
import pytest
import torch

from lattisense_torch.core import u64 as tu
from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_torch.ops import behz_cuda, ksw_cuda, ntt_cuda
from lattisense_torch.params import BfvParams
from lattisense_torch.parallel.batch import (bfv_mult_relin, key_tree, make_batched_step,
                                             make_rotate_step)
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes.bfv import BfvEngine
from lattisense_torch.schemes.galois import galois_elt_col
from lattisense_torch.schemes.keyswitch import KeySwitcher
from lattisense_torch.schemes.types import Ciphertext, KeySwitchKey

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


def random_key(seed, q, p, n):
    """A key-switching key of random residues (any values in [0, q) are a
    valid input of the switch) at full level."""
    beta = (len(q) + len(p) - 1) // len(p)
    return KeySwitchKey(key_q=residues(seed, q, n, (beta, 2)),
                        key_p=residues(seed + 1, p, n, (beta, 2)))


@pytest.mark.parametrize('n,nq,npp,levels,lead', [
    (256, 5, 2, (4, 3, 2), (3,)),        # alpha = 2, ragged last digit at levels 4 and 2
    (16384, 10, 4, (7, 4), (4,)),        # the headline chain: level 7 (beta = 2, T = 12)
])
def test_b3_kernel_matches_plain(cuda, n, nq, npp, levels, lead):
    chain = gen_ntt_primes(n, 31, nq + npp)
    q, p = tuple(chain[:nq]), tuple(chain[nq:])
    sw_c, sw_g = KeySwitcher(q, p, n, CPU), KeySwitcher(q, p, n, cuda)
    key_c = random_key(11, q, p, n)
    key_g = KeySwitchKey(key_q=key_c.key_q.to(cuda), key_p=key_c.key_p.to(cuda))
    for level in levels:
        x = residues(12 + level, q[:level + 1], n, lead)
        for output_ntt in (False, True):
            before = {**ntt_cuda.launches, **ksw_cuda.launches}
            e0, e1 = ksw_cuda.ksw_switch32(x.to(cuda), key_g, sw_g, level, output_ntt)
            torch.cuda.synchronize()
            w0, w1 = sw_c.switch_plain(x, key_c, level, output_ntt)
            assert torch.equal(e0.cpu(), w0) and torch.equal(e1.cpu(), w1), (level, output_ntt)
            assert ksw_cuda.launches['ksw_switch32'] == before['ksw_switch32'] + 1
            assert ntt_cuda.launches['ntt32_fwd'] == before['ntt32_fwd'] + 1 + output_ntt
            assert ntt_cuda.launches['ntt32_inv'] == before['ntt32_inv'] + 1
    # a strided view (the relinearize path's ct3.data[..., 2, :, :]) is copied
    level = levels[0]
    x3 = residues(5, q[:level + 1], n, (2, 3))
    got = ksw_cuda.ksw_switch32(x3.to(cuda)[:, 2], key_g, sw_g, level)
    want = sw_c.switch_plain(x3[:, 2], key_c, level)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_b3_wrapper_rejects_bad_input(cuda):
    n = 256
    chain = gen_ntt_primes(n, 31, 7)
    q, p = tuple(chain[:5]), tuple(chain[5:])
    sw = KeySwitcher(q, p, n, cuda)
    key = random_key(3, q, p, n)
    key = KeySwitchKey(key_q=key.key_q.to(cuda), key_p=key.key_p.to(cuda))
    x = residues(4, q[:4], n, (2,)).to(cuda)
    before = dict(ksw_cuda.launches)
    with pytest.raises(ValueError):
        ksw_cuda.ksw_switch32(x, key, sw, 2)                       # wrong level for L = 4
    with pytest.raises(TypeError):
        ksw_cuda.ksw_switch32(x.to(torch.int32), key, sw, 3)
    with pytest.raises(ValueError):
        ksw_cuda.ksw_switch32(x.cpu(), key, sw, 3)                 # tensor off the switcher
    with pytest.raises(ValueError):
        bad = KeySwitchKey(key_q=key.key_q.transpose(0, 1).contiguous().transpose(0, 1),
                           key_p=key.key_p)
        ksw_cuda.ksw_switch32(x, bad, sw, 3)                       # key not contiguous
    assert ksw_cuda.launches == before


@pytest.mark.parametrize('n,nq,npp,level,lead', [
    (1024, 5, 1, 4, (2, 3)),
    (16384, 10, 4, 7, (4, 3)),           # the headline: (B, 3, 8, n) and (B, 3, 11, n)
])
def test_b4_kernel_matches_plain(cuda, n, nq, npp, level, lead):
    chain = gen_ntt_primes(n, 31, nq + npp)
    params = BfvParams.create_custom(n, 65537, list(chain[:nq]), list(chain[nq:]))
    bz_c, bz_g = BfvEngine(params, CPU).behz(level), BfvEngine(params, cuda).behz(level)
    dq = residues(9, bz_c.ring_q.moduli, n, lead)
    da = residues(10, bz_c.ring_aux.moduli, n, lead)
    before = {**ntt_cuda.launches, **behz_cuda.launches}
    got = behz_cuda.behz_finish32(dq.to(cuda), da.to(cuda), bz_g)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), behz_cuda.behz_finish_plain(dq, da, bz_c))
    assert behz_cuda.launches['behz_finish32'] == before['behz_finish32'] + 1
    assert ntt_cuda.launches['ntt32_inv'] == before['ntt32_inv'] + 2
    with pytest.raises(ValueError):
        behz_cuda.behz_finish32(dq.to(cuda).transpose(0, 1), da.to(cuda).transpose(0, 1), bz_g)
    with pytest.raises(ValueError):
        behz_cuda.behz_finish32(dq.to(cuda)[:1], da.to(cuda), bz_g)
    assert behz_cuda.launches['behz_finish32'] == before['behz_finish32'] + 1


def test_batched_rotate_card_matches_cpu(cuda):
    n = 4096
    chain = gen_ntt_primes(n, 31, 6)
    params = BfvParams.create_custom(n, 65537, chain[:4], chain[4:])
    ctx = BfvContext.create_random_context(params, seed=6, device=cuda)
    elt = galois_elt_col(1, n)
    ctx.gen_galois_keys_for_elements([elt])
    rng = np.random.default_rng(6)
    msgs = rng.integers(0, params.t, (2, n))
    a = torch.stack([ctx.encrypt(ctx.encode(m, 3)).data for m in msgs])
    keys = key_tree(ctx, galois_elts=[elt])
    before = dict(ksw_cuda.launches)
    out = make_batched_step(ctx.engine, make_rotate_step(elt), 3, n_inputs=1)(a, keys)
    assert ksw_cuda.launches['ksw_switch32'] == before['ksw_switch32'] + 1
    glk = ctx.glk.keys[elt]
    keys_c = {'glk': {elt: KeySwitchKey(key_q=glk.key_q.cpu(), key_p=glk.key_p.cpu())}}
    want = make_batched_step(BfvEngine(params, CPU), make_rotate_step(elt), 3,
                             n_inputs=1)(a.cpu(), keys_c)
    assert torch.equal(out.cpu(), want)
    half = n // 2
    for i, m in enumerate(msgs):
        got = ctx.decrypt_decode(Ciphertext(data=out[i], level=3))
        assert np.array_equal(got, np.concatenate([np.roll(m[:half], -1),
                                                   np.roll(m[half:], -1)]))
