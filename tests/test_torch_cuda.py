"""The CUDA kernels of lattisense_torch against their plain PyTorch twins.

These need the card (a CUDA kernel has no CPU mode) and skip without one.
Each kernel is checked at a small shape and at the main path's shape, with
its launch count and its refusal of bad input; the NTTs B1 and B5 and the
kernels built on B1's row loop (B2, B3, B4) at every n they take (B1 and B5
run their cluster kernel above their row kernel's cap, at 2^15 and 2^16;
B3 its cluster route there), B6
through each of its instances and its fold, bit for bit; and the
compiled-task runtime on each committed task directory (card against CPU,
graph replay against eager, a second key set through the same task); and
CKKS: every engine op, the batched step at both words and the rotation, and
the CKKS task directories (a second set of input scales capturing its own
graph), card against CPU bit for bit; the n=2^16 repairs (B1-r4/perm, B2,
B3, B4 against their twins, a CKKS relinearization and rotation on
``create_tpu_param(65536)``) and the n=256 bootstrap at both words in every
task mode; B8, the tensor product, at both cells' shapes against its twin and
on a warm BFV and CKKS step; threshold BFV at n=16384 on both words (every share, collective
key and E2S / S2E / refresh output, card against CPU), ``ForeignTask`` on the
card against the CPU, and the memory monitor's device column; the MXU NTT on
both routes against B5 and with its gate on in a batched step, and worlds of
2 ranks sharing the card over gloo (the limb-TP pipeline, the op-sharded
step, the task replayed as graphs cut at each collective) against the
single-card step; a model of the model zoo at n=1024 (card against CPU, eager
and replayed) and an example runner at ``--toy`` on the card.
The file imports no JAX, so it also runs where only PyTorch is installed:
``python -m pytest --noconftest tests/test_torch_cuda.py`` on the card.
"""

import time

import numpy as np
import pytest
import torch

from lattisense_torch.core import u64 as tu
from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_torch.ops import behz_cuda, cuda_build, ksw_cuda, ntt64_cuda, ntt_cuda
from lattisense_torch.params import BfvParams
from lattisense_torch.parallel.batch import (bfv_mult_relin, key_tree, make_batched_step,
                                             make_rotate_step)
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes.bfv import BfvEngine
from lattisense_torch.schemes.galois import galois_elt_col
from lattisense_torch.schemes.keys import SecretKey
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


def card_residues(ring, lead, seed):
    """A (*lead, L, n) stack of residues made on the card from a seed."""
    gen = torch.Generator(device=ring.device).manual_seed(seed)
    x = torch.randint(0, 1 << 62, (*lead, len(ring.moduli), ring.n), generator=gen,
                      device=ring.device)
    return x % ring.q


def row_cases(logn):
    """(L, lead) stacks of 1 row, a prime count of rows, and counts that are
    no multiple of the rows a persistent block takes (the grid is at most 32
    blocks per SM, so 4812 rows exceed it at every n up to 2^12)."""
    return [(1, ()), (1, (13,)), (12, (37,))] + ([(12, (401,))] if logn <= 12 else [])


def misaligned(x):
    """A copy of x that starts 8 bytes past a 16-byte boundary."""
    return torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape).copy_(x)


@pytest.mark.parametrize('logn', range(1, 17))
def test_b1_kernel_matches_plain(cuda, logn):
    """Every n B1 takes, L = 1 and L = 12, both epilogues of each direction;
    above 2^14 one launch of the cluster kernel a call, counted apart too."""
    n = 1 << logn
    chain = tuple(gen_ntt_primes(n, 31, 12))
    before, calls = dict(ntt_cuda.launches), 0
    for L, lead in row_cases(logn):
        ring = get_rns_ring(chain[:L], n, cuda)
        x = card_residues(ring, lead, 7 + logn)
        f = ntt_cuda.ntt32_fwd(x, ring)
        fm = ntt_cuda.ntt32_fwd(x, ring, to_mont=True)
        i = ntt_cuda.ntt32_inv(x, ring)
        im = torch.empty_like(x)
        ntt_cuda.launch(fm, im, ring, inverse=True, from_mont=True)
        fa = ntt_cuda.ntt32_fwd(misaligned(x), ring)
        ia = misaligned(torch.zeros_like(x))
        ntt_cuda.launch(f, ia, ring, inverse=True)
        calls += 3
        torch.cuda.synchronize()
        assert torch.equal(f, ntt_cuda.ntt_plain(x, ring)), (L, lead)
        assert torch.equal(fm, ntt_cuda.ntt_plain(x, ring, to_mont=True)), (L, lead)
        assert torch.equal(i, ntt_cuda.intt_plain(x, ring)), (L, lead)
        assert torch.equal(im, x) and torch.equal(ia, x) and torch.equal(fa, f), (L, lead)
    cluster = calls if logn > ntt_cuda.ROW_MAX_LOGN else 0
    assert ntt_cuda.launches['ntt32_fwd'] == before['ntt32_fwd'] + calls
    assert ntt_cuda.launches['ntt32_inv'] == before['ntt32_inv'] + calls
    assert ntt_cuda.launches['ntt32_fwd_cluster'] == before['ntt32_fwd_cluster'] + cluster
    assert ntt_cuda.launches['ntt32_inv_cluster'] == before['ntt32_inv_cluster'] + cluster
    assert not [k for k in ntt_cuda.launches if k.endswith('_cols')]     # no columns kernel
    with pytest.raises(ValueError):
        ntt_cuda.ntt32_fwd(x.transpose(0, 1), ring)


@pytest.mark.parametrize('logn', [15, 16])
def test_b1_cluster_sub_rows_match_plain(cuda, logn):
    """B1's cluster kernel over its sub-rows of 2^SUB_LOGN: (37, 12, n) and
    an odd row count, both epilogues of each direction, one cluster launch a
    call, and the clusters that fit the card; the C entries refuse any other
    sub-row size."""
    n = 1 << logn
    chain = tuple(gen_ntt_primes(n, 31, 12))
    assert ntt_cuda.cluster_fit(logn, False) > 0 and ntt_cuda.cluster_fit(logn, True) > 0
    for L, lead in ((12, (37,)), (3, (5,))):
        ring = get_rns_ring(chain[:L], n, cuda)
        x = card_residues(ring, lead, 11 + L)
        before = dict(ntt_cuda.launches)
        got = []
        for inverse, to_mont, from_mont in ((False, False, False), (False, True, False),
                                            (True, False, False), (True, False, True)):
            y = torch.empty_like(x)
            ntt_cuda.launch(x, y, ring, inverse, to_mont, from_mont)
            got.append(y)
        torch.cuda.synchronize()
        want = [ntt_cuda.ntt_plain(x, ring), ntt_cuda.ntt_plain(x, ring, to_mont=True),
                ntt_cuda.intt_plain(x, ring),
                ntt_cuda.intt_plain(tu.from_mont(x, ring.q, ring.pinv), ring)]
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (L, lead)
        assert ntt_cuda.launches['ntt32_fwd_cluster'] == before['ntt32_fwd_cluster'] + 2
        assert ntt_cuda.launches['ntt32_inv_cluster'] == before['ntt32_inv_cluster'] + 2
    from lattisense_torch.ops import cuda_build
    lib = cuda_build.load('ntt32', ntt_cuda._SIGNATURES)
    tabs = ntt_cuda.cluster_tables(ring, ntt_cuda.cluster_depth(logn))
    for logs in (ntt_cuda.SUB_LOGN - 1, ntt_cuda.SUB_LOGN + 1):
        assert lib.ntt32_cluster_launch(
            x.data_ptr(), x.data_ptr(), x.numel() // n, L, logn, logs, 0, tabs['fwd'].data_ptr(),
            tabs['cols_fwd'].data_ptr(), tabs['cols_q'].data_ptr(), None, None,
            torch.cuda.current_stream().cuda_stream) != 0
        assert ntt_cuda.launches['ntt32_fwd_cluster'] == before['ntt32_fwd_cluster'] + 2


def test_b2_kernel_matches_plain(cuda):
    n = 1024
    chain = tuple(gen_ntt_primes(n, 31, 6))
    params = BfvParams.create_custom(n, 65537, list(chain[:5]), [chain[5]], word_bits=32)
    bz_c, bz_g = BfvEngine(params, CPU).behz(4), BfvEngine(params, cuda).behz(4)
    x = residues(8, bz_c.ring_q.moduli, n, (2, 4))
    fq, fa = behz_cuda.behz_prep32(x.to(cuda), bz_g)
    torch.cuda.synchronize()
    want_fq, want_fa = behz_cuda.behz_prep_plain(x, bz_c)
    assert torch.equal(fq.cpu(), want_fq) and torch.equal(fa.cpu(), want_fa)
    assert torch.equal(tu.from_mont(fq.cpu(), bz_c.ring_q.q, bz_c.ring_q.pinv),
                       ntt_cuda.ntt_plain(x, bz_c.ring_q))


def b2_matches_plain(cuda, params, levels, leads):
    """B2 at each level and lead against ``behz_prep_plain`` on the card, one
    count a call (above 2^14 also under ``behz32_prep_cluster``, its cluster
    route) and no launch of B1's entries; a misaligned view of the input
    too."""
    eng = BfvEngine(params, cuda)
    cluster = int(behz_cuda.route(params.n) == 'cluster')
    for level in levels:
        bz = eng.behz(level)
        for lead in leads:
            x = card_residues(bz.ring_q, lead, 3 * level + len(lead))
            want = behz_cuda.behz_prep_plain(x, bz)
            before = {**ntt_cuda.launches, **behz_cuda.launches}
            fq, fa = behz_cuda.behz_prep32(x, bz)
            assert torch.equal(fq, want[0]) and torch.equal(fa, want[1]), (level, lead)
            assert behz_cuda.launches['behz_prep32'] == before['behz_prep32'] + 1
            assert behz_cuda.launches['behz32_prep_cluster'] == before['behz32_prep_cluster'] + cluster
            assert behz_cuda.launches['behz32_finish_cluster'] == before['behz32_finish_cluster']
            assert all(ntt_cuda.launches[k] == before[k] for k in ntt_cuda.launches)
        fq, fa = behz_cuda.behz_prep32(misaligned(x), bz)
        assert torch.equal(fq, want[0]) and torch.equal(fa, want[1]), level


@pytest.mark.parametrize('logn', range(1, 17))
def test_b2_every_n_matches_plain(cuda, logn):
    """Every n B2 takes, L = 5 and L = 2, batch 1 and an odd batch: the row
    loop up to 2^14, the cluster route at 2^15 and 2^16."""
    n = 1 << logn
    chain = gen_ntt_primes(n, 31, 6)
    params = BfvParams.create_custom(n, 65537, list(chain[:5]), [chain[5]], word_bits=32)
    b2_matches_plain(cuda, params, (4, 1), ((1,), (3,), (2, 3)))


def test_b2_every_level_of_the_headline_chain(cuda):
    """create_tpu_param(16384): levels 0..9 (L + T = 5..23 rows), batch 1
    and 5."""
    b2_matches_plain(cuda, BfvParams.create_tpu_param(16384), range(10), ((1,), (5,)))


def test_b2_limb_maxima_and_refusals(cuda):
    """L = 32, the extension's largest instance, with the aux basis of that
    chain; the refusal of L = 33, of a non-contiguous stack and of an int32
    one, each before any launch; n = 2^16 (the cluster route) against the
    twin, and the refusal of n = 2^17."""
    n = 1024
    chain = gen_ntt_primes(n, 31, 34)
    params = BfvParams.create_custom(n, 65537, list(chain[:33]), [chain[33]], word_bits=32)
    b2_matches_plain(cuda, params, (15, 31), ((3,),))
    eng = BfvEngine(params, cuda)
    x = card_residues(eng.behz(32).ring_q, (1,), 0)
    wide = torch.cat([x, x], dim=-1)[..., ::2]
    before = {**ntt_cuda.launches, **behz_cuda.launches}
    with pytest.raises(ValueError):
        behz_cuda.behz_prep32(x, eng.behz(32))
    with pytest.raises(ValueError):
        behz_cuda.behz_prep32(wide[:, :31], eng.behz(30))
    with pytest.raises(TypeError):
        behz_cuda.behz_prep32(x[:, :31].to(torch.int32), eng.behz(30))
    big = 1 << 17
    chain17 = gen_ntt_primes(big, 31, 3)
    bz17 = BfvEngine(BfvParams.create_custom(big, 65537, chain17[:2], chain17[2:], word_bits=32),
                     cuda).behz(1)
    with pytest.raises(ValueError):
        behz_cuda.behz_prep32(card_residues(bz17.ring_q, (1,), 1), bz17)
    assert {**ntt_cuda.launches, **behz_cuda.launches} == before
    chain16 = gen_ntt_primes(1 << 16, 31, 3)
    b2_b4_cluster_match_plain(cuda, BfvParams.create_custom(1 << 16, 65537, chain16[:2],
                                                            chain16[2:], word_bits=32),
                              (1,), ((1,),))


def b2_b4_cluster_match_plain(cuda, params, levels, leads):
    """B2 and B4 on their cluster route (n = 2^15, 2^16) against their twins
    on the card, a misaligned view too: one count a call each, under the
    wrapper's name and under ``behz32_prep_cluster`` /
    ``behz32_finish_cluster``, and no launch of B1's entries."""
    eng = BfvEngine(params, cuda)
    assert behz_cuda.route(params.n) == 'cluster'
    for level in levels:
        bz = eng.behz(level)
        for lead in leads:
            x = card_residues(bz.ring_q, lead, 5 * level + len(lead))
            dq = card_residues(bz.ring_q, lead, 5 * level + len(lead) + 1)
            da = card_residues(bz.ring_aux, lead, 5 * level + len(lead) + 2)
            want_p = behz_cuda.behz_prep_plain(x, bz)
            want_f = behz_cuda.behz_finish_plain(dq, da, bz)
            before = {**ntt_cuda.launches, **behz_cuda.launches}
            fq, fa = behz_cuda.behz_prep32(x, bz)
            out = behz_cuda.behz_finish32(dq, da, bz)
            assert torch.equal(fq, want_p[0]) and torch.equal(fa, want_p[1]), (level, lead)
            assert torch.equal(out, want_f), (level, lead)
            for k in ('behz_prep32', 'behz_finish32', 'behz32_prep_cluster',
                      'behz32_finish_cluster'):
                assert behz_cuda.launches[k] == before[k] + 1, k
            assert all(ntt_cuda.launches[k] == before[k] for k in ntt_cuda.launches)
            fq, fa = behz_cuda.behz_prep32(misaligned(x), bz)
            assert torch.equal(fq, want_p[0]) and torch.equal(fa, want_p[1]), level
            assert torch.equal(behz_cuda.behz_finish32(misaligned(dq), misaligned(da), bz),
                               want_f), level


def test_b2_b4_n65536_match_plain(cuda):
    """A custom 31-bit BFV chain at n = 2^16 (as ``BfvParams.create_custom``
    builds one): L = 6 and L = 1, batch 1 and an odd batch."""
    n = 1 << 16
    chain = gen_ntt_primes(n, 31, 8)
    params = BfvParams.create_custom(n, 65537, list(chain[:6]), list(chain[6:]), word_bits=32)
    b2_b4_cluster_match_plain(cuda, params, (5, 0), ((1,), (3,)))


def test_b2_b4_every_level_of_the_32k_chain(cuda):
    """create_tpu_param(32768), ``w32_32k_path``'s chain: every level 0..21
    (L + T = 4..47 rows) at batch 1, and the path's level at an odd batch
    of 3 polynomials, through the cluster route; the C entries' row-loop
    cap is B1's row kernel's, and both cluster kernels fit the card at
    2^15 and 2^16."""
    lib = cuda_build.load('behz32', behz_cuda._SIGNATURES)
    assert lib.behz32_max_logn() == behz_cuda.ROWS_MAX_LOGN == ntt_cuda.ROW_MAX_LOGN
    for n in (1 << 15, 1 << 16):
        assert behz_cuda.cluster_fit(n, False) > 0 and behz_cuda.cluster_fit(n, True) > 0
    params = BfvParams.create_tpu_param(1 << 15)
    b2_b4_cluster_match_plain(cuda, params, range(len(params.q)), ((1,),))
    b2_b4_cluster_match_plain(cuda, params, (len(params.q) - 1,), ((3,),))


def test_b2_b4_limb_maxima_n65536(cuda):
    """L = 32 (``behz32_max_limbs``) at n = 2^16 with its chain's aux basis
    (T <= ``behz32_max_aux``), batch 1 and 2, through the cluster route; at
    L = 33 both refuse before any launch."""
    lib = cuda_build.load('behz32', behz_cuda._SIGNATURES)
    n = 1 << 16
    chain = gen_ntt_primes(n, 31, 34)
    params = BfvParams.create_custom(n, 65537, list(chain[:33]), [chain[33]], word_bits=32)
    eng = BfvEngine(params, cuda)
    bz = eng.behz(lib.behz32_max_limbs() - 1)
    assert len(bz.ring_q.moduli) == lib.behz32_max_limbs()
    assert len(bz.ring_aux.moduli) <= lib.behz32_max_aux()
    b2_b4_cluster_match_plain(cuda, params, (lib.behz32_max_limbs() - 1,), ((1,), (2,)))
    big = eng.behz(lib.behz32_max_limbs())
    x = card_residues(big.ring_q, (1,), 2)
    da = card_residues(big.ring_aux, (1,), 3)
    before = dict(behz_cuda.launches)
    with pytest.raises(ValueError):
        behz_cuda.behz_prep32(x, big)
    with pytest.raises(ValueError):
        behz_cuda.behz_finish32(x, da, big)
    assert behz_cuda.launches == before


@pytest.mark.parametrize('word_bits', [32, 64])
def test_decrypt_rounding_on_the_card(cuda, word_bits):
    """BFV decryption's rounding in machine words (``round_t_over_q``) on
    the card equals the CPU's, which the CPU tests hold against big
    integers: the n=32768 chains' top levels, t = 65537 and 2^31 - 1, with
    residues 0, 1 and q - 1 in every limb."""
    from lattisense_torch.schemes.bfv import round_t_over_q
    params = (BfvParams.create_tpu_param(1 << 15) if word_bits == 32
              else BfvParams.create(1 << 15))
    moduli, n = tuple(params.q), params.n
    ring_c, ring_g = (get_rns_ring(moduli, n, d, word_bits) for d in (CPU, cuda))
    acc = residues(9, moduli, n)
    acc[:, 0], acc[:, 1] = 0, 1
    acc[:, 2] = torch.tensor([q - 1 for q in moduli])
    for t in (65537, (1 << 31) - 1):
        assert torch.equal(round_t_over_q(acc.to(cuda), ring_g, t).cpu(),
                           round_t_over_q(acc, ring_c, t)), t


def test_batched_mult_relin_card_matches_cpu(cuda):
    n = 4096
    chain = gen_ntt_primes(n, 31, 6)
    params = BfvParams.create_custom(n, 65537, chain[:4], chain[4:], word_bits=32)
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
            # the fused route runs its own NTTs: B1 only for the output NTT
            assert ntt_cuda.launches['ntt32_fwd'] == before['ntt32_fwd'] + output_ntt
            assert ntt_cuda.launches['ntt32_inv'] == before['ntt32_inv']
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
    params = BfvParams.create_custom(n, 65537, list(chain[:nq]), list(chain[nq:]), word_bits=32)
    bz_c, bz_g = BfvEngine(params, CPU).behz(level), BfvEngine(params, cuda).behz(level)
    dq = residues(9, bz_c.ring_q.moduli, n, lead)
    da = residues(10, bz_c.ring_aux.moduli, n, lead)
    before = {**ntt_cuda.launches, **behz_cuda.launches}
    got = behz_cuda.behz_finish32(dq.to(cuda), da.to(cuda), bz_g)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), behz_cuda.behz_finish_plain(dq, da, bz_c))
    assert behz_cuda.launches['behz_finish32'] == before['behz_finish32'] + 1
    assert ntt_cuda.launches['ntt32_inv'] == before['ntt32_inv']     # fused: no B1 launch
    with pytest.raises(ValueError):
        behz_cuda.behz_finish32(dq.to(cuda).transpose(0, 1), da.to(cuda).transpose(0, 1), bz_g)
    with pytest.raises(ValueError):
        behz_cuda.behz_finish32(dq.to(cuda)[:1], da.to(cuda), bz_g)
    assert behz_cuda.launches['behz_finish32'] == before['behz_finish32'] + 1


# ---------------------------------------------------------------------------
# B3 and B4 through both routes
# ---------------------------------------------------------------------------

def card_key(ksk, dev):
    return KeySwitchKey(key_q=ksk.key_q.to(dev), key_p=ksk.key_p.to(dev))


def b3_both_routes(cuda, q, p, n, levels, leads):
    """B3 through the route that takes n (the fused route up to 2^14, the
    cluster route above) called by name, and through the wrapper, at each
    level, lead and output_ntt, against ``switch_plain`` on the card."""
    sw = KeySwitcher(q, p, n, cuda)
    key = card_key(random_key(70 + n.bit_length(), q, p, n), cuda)
    route = ksw_cuda.switch_route(n)
    for level in levels:
        for lead in leads:
            x = card_residues(get_rns_ring(q[:level + 1], n, cuda), lead, level + 3 * len(lead))
            for output_ntt in (False, True):
                want = sw.switch_plain(x, key, level, output_ntt)
                got = ksw_cuda._switch(x, key, sw, level, output_ntt, route)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
                    (route, level, lead, output_ntt)
                got = ksw_cuda.ksw_switch32(x, key, sw, level, output_ntt)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return sw, key


@pytest.mark.parametrize('logn', range(1, 17))
def test_b3_routes_match_plain(cuda, logn):
    """Every n B1 takes, alpha = 2 with a ragged last digit (level 4) and
    without (level 3), batch 1 and an odd batch, both outputs; each route
    refuses the n of the other."""
    n = 1 << logn
    chain = tuple(gen_ntt_primes(n, 31, 7))
    sw, key = b3_both_routes(cuda, chain[:5], chain[5:], n, (4, 3), ((1,), (3,)))
    x = card_residues(get_rns_ring(chain[:4], n, cuda), (1,), 1)
    other = 'fused' if ksw_cuda.switch_route(n) == 'cluster' else 'cluster'
    before = dict(ksw_cuda.launches)
    with pytest.raises(ValueError):
        ksw_cuda._switch(x, key, sw, 3, False, other)
    assert ksw_cuda.launches == before


def test_b3_every_level_of_the_headline_chain(cuda):
    """create_tpu_param(16384): levels 0..9 (beta 1..3, a ragged last digit
    at levels 4..6 and 8), batch 1 and 5."""
    params = BfvParams.create_tpu_param(16384)
    b3_both_routes(cuda, tuple(params.q), tuple(params.p), params.n, range(len(params.q)),
                   ((1,), (5,)))


def test_b3_alpha_maximum_and_refusals(cuda):
    n = 1024
    chain = tuple(gen_ntt_primes(n, 31, 19))
    # alpha = 8, the kernels' maximum: level 9 has a ragged second digit
    b3_both_routes(cuda, chain[:10], chain[10:18], n, (9, 0), ((3,),))
    q, p = chain[:10], chain[10:19]                                 # alpha = 9
    sw = KeySwitcher(q, p, n, cuda)
    key = card_key(random_key(3, q, p, n), cuda)
    x = card_residues(get_rns_ring(q[:4], n, cuda), (2,), 1)
    before = dict(ksw_cuda.launches)
    for route in ('fused', 'cluster'):
        with pytest.raises(ValueError):
            ksw_cuda._switch(x, key, sw, 3, False, route)
    with pytest.raises(ValueError):
        ksw_cuda.ksw_switch32(x, key, sw, 3)
    assert ksw_cuda.launches == before


def b4_matches_plain(cuda, params, levels, leads):
    """B4 at each level and lead against ``behz_finish_plain`` on the card,
    one count a call (above 2^14 also under ``behz32_finish_cluster``, its
    cluster route) and no launch of B1's entries; a misaligned view of the
    inputs too."""
    eng = BfvEngine(params, cuda)
    cluster = int(behz_cuda.route(params.n) == 'cluster')
    for level in levels:
        bz = eng.behz(level)
        for lead in leads:
            dq = card_residues(bz.ring_q, lead, 2 * level + len(lead))
            da = card_residues(bz.ring_aux, lead, 2 * level + len(lead) + 1)
            want = behz_cuda.behz_finish_plain(dq, da, bz)
            before = {**ntt_cuda.launches, **behz_cuda.launches}
            assert torch.equal(behz_cuda.behz_finish32(dq, da, bz), want), (level, lead)
            assert behz_cuda.launches['behz_finish32'] == before['behz_finish32'] + 1
            assert (behz_cuda.launches['behz32_finish_cluster']
                    == before['behz32_finish_cluster'] + cluster)
            assert behz_cuda.launches['behz32_prep_cluster'] == before['behz32_prep_cluster']
            assert all(ntt_cuda.launches[k] == before[k] for k in ntt_cuda.launches)
        got = behz_cuda.behz_finish32(misaligned(dq), misaligned(da), bz)
        assert torch.equal(got, want), level


@pytest.mark.parametrize('logn', range(1, 17))
def test_b4_every_n_matches_plain(cuda, logn):
    """Every n B4 takes, L = 5 and L = 2, batch 1 and an odd batch: the row
    loops up to 2^14, the cluster route at 2^15 and 2^16."""
    n = 1 << logn
    chain = gen_ntt_primes(n, 31, 6)
    params = BfvParams.create_custom(n, 65537, list(chain[:5]), [chain[5]], word_bits=32)
    b4_matches_plain(cuda, params, (4, 1), ((1,), (3,), (2, 3)))


def test_b4_every_level_of_the_headline_chain(cuda):
    """create_tpu_param(16384): levels 0..9 (L + T = 5..23 rows), batch 1
    and 5."""
    b4_matches_plain(cuda, BfvParams.create_tpu_param(16384), range(10), ((1,), (5,)))


def test_b4_limb_maxima_and_refusals(cuda):
    """L = 32, the scale-back's largest instance (T = 34), and the refusal of
    L = 33."""
    n = 1024
    chain = gen_ntt_primes(n, 31, 34)
    params = BfvParams.create_custom(n, 65537, list(chain[:33]), [chain[33]], word_bits=32)
    b4_matches_plain(cuda, params, (15, 31), ((3,),))
    bz = BfvEngine(params, cuda).behz(32)
    dq, da = card_residues(bz.ring_q, (1,), 0), card_residues(bz.ring_aux, (1,), 1)
    before = dict(behz_cuda.launches)
    with pytest.raises(ValueError):
        behz_cuda.behz_finish32(dq, da, bz)
    assert behz_cuda.launches == before


def test_batched_rotate_card_matches_cpu(cuda):
    n = 4096
    chain = gen_ntt_primes(n, 31, 6)
    params = BfvParams.create_custom(n, 65537, chain[:4], chain[4:], word_bits=32)
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


# ---------------------------------------------------------------------------
# B1-r4 and the perm-layout entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [256, 16384, 65536])
def test_b1_r4_and_perm_entries_match_plain(cuda, n):
    chain = tuple(gen_ntt_primes(n, 31, 4))
    ring_c, ring_g = get_rns_ring(chain, n, CPU), get_rns_ring(chain, n, cuda)
    x = residues(21, chain, n, (3,))
    f = ntt_cuda.ntt_plain(x, ring_c)
    before = dict(ntt_cuda.launches)
    got = {'ntt32_fwd_r4': ntt_cuda.ntt32_fwd_r4(x.to(cuda), ring_g),
           'ntt32_inv_r4': ntt_cuda.ntt32_inv_r4(f.to(cuda), ring_g),
           'ntt32_fwd_perm': ntt_cuda.ntt32_fwd_perm(x.to(cuda), ring_g),
           'ntt32_inv_perm': ntt_cuda.ntt32_inv_perm(ntt_cuda.perm_layout(f).to(cuda), ring_g)}
    torch.cuda.synchronize()
    want = {'ntt32_fwd_r4': f, 'ntt32_inv_r4': x, 'ntt32_fwd_perm': ntt_cuda.perm_layout(f),
            'ntt32_inv_perm': x}
    for name, g in got.items():
        assert torch.equal(g.cpu(), want[name]), name
        assert ntt_cuda.launches[name] == before[name] + 1, name
    assert (ntt_cuda.launches['ntt32_fwd'], ntt_cuda.launches['ntt32_inv']) == \
        (before['ntt32_fwd'], before['ntt32_inv'])


# ---------------------------------------------------------------------------
# the 64-bit word: B5, B6, B7
# ---------------------------------------------------------------------------

def chain64(n, count):
    """55- to 61-bit NTT primes, the widths of the u64 chains."""
    out = []
    for bits in (61, 59, 57, 55):
        out += gen_ntt_primes(n, bits, 2, exclude=tuple(out))
    return tuple(out[:count])


@pytest.mark.parametrize('logn', range(1, 17))
def test_b5_kernel_matches_plain(cuda, logn):
    """Every n B5 takes, L = 1 and L = 12, both epilogues of each direction,
    and the reference's five names; at 2^15 and 2^16 through the cluster
    kernel, whose launches count under ``ntt64_*_cluster`` in place of the
    row kernel's."""
    from lattisense_torch.ops import ntt64_cuda
    n = 1 << logn
    chain = tuple(p for bits in (61, 59, 57, 55) for p in gen_ntt_primes(n, bits, 3))
    before, calls = dict(ntt64_cuda.launches), 0
    for L, lead in row_cases(logn):
        ring = get_rns_ring(chain[:L], n, cuda, 64)
        x = card_residues(ring, lead, 31 + logn)
        f = ntt64_cuda.ntt64_fwd(x, ring)
        fm = ntt64_cuda.ntt64_fwd(x, ring, to_mont=True)
        i = ntt64_cuda.ntt64_inv(x, ring)
        im = ntt64_cuda.ntt64_inv(fm, ring, from_mont=True)
        ia = ntt64_cuda.ntt64_inv(misaligned(f), ring)
        calls += 2
        torch.cuda.synchronize()
        assert torch.equal(f, ntt64_cuda.ntt64_plain(x, ring)), (L, lead)
        assert torch.equal(fm, ntt64_cuda.ntt64_plain(x, ring, to_mont=True)), (L, lead)
        assert torch.equal(i, ntt64_cuda.intt64_plain(x, ring)), (L, lead)
        assert torch.equal(im, x) and torch.equal(ia, x), (L, lead)
    inv = calls + len(row_cases(logn))
    split = logn > ntt64_cuda.ROW_MAX_LOGN
    assert ntt64_cuda.launches == {'ntt64_fwd': before['ntt64_fwd'] + (not split) * calls,
                                   'ntt64_inv': before['ntt64_inv'] + (not split) * inv,
                                   'ntt64_fwd_cluster': before['ntt64_fwd_cluster'] + split * calls,
                                   'ntt64_inv_cluster': before['ntt64_inv_cluster'] + split * inv}
    for alias in (ntt64_cuda.ntt_fused64, ntt64_cuda.ntt_fused):
        assert torch.equal(alias(x, ring), f)
    for alias in (ntt64_cuda.intt_fused64, ntt64_cuda.intt_fused, ntt64_cuda.intt_fused_impl):
        assert torch.equal(alias(f, ring), x)
    with pytest.raises(ValueError):
        ntt64_cuda.ntt64_fwd(x, get_rns_ring(gen_ntt_primes(n, 31, len(chain[:L])), n, cuda))


def test_b6_kernel_matches_plain(cuda):
    from lattisense_torch.core.rns import BasisConv
    from lattisense_torch.ops import bconv_cuda
    n = 16384
    primes = chain64(n, 8)
    src, dst = primes[:4], primes[4:8] + (gen_ntt_primes(n, 59, 1, exclude=primes)[0],)
    conv_c, conv_g = BasisConv(src, dst, CPU, 64), BasisConv(src, dst, cuda, 64)
    y = conv_c.decompose(residues(41, src, n, (32, 4)))
    before = dict(bconv_cuda.launches)
    got = bconv_cuda.bconv64_convert(y.to(cuda), conv_g)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), bconv_cuda.bconv64_plain(y, conv_c.qhat_dst_mont,
                                                           conv_c.dst_q, conv_c.dst_pinv))
    # grouped: two digits of two limbs each, every digit its own constants
    sw = KeySwitcher(primes[:4], primes[4:6], n, cuda, 64)
    ring_qp, _, _, _, qhat_conv, _ = sw._level_pre(3)
    yd = residues(42, primes[:4], n, (32,)).reshape(32, 2, 2, n)
    raw = bconv_cuda.bconv64_raw(yd.to(cuda), qhat_conv, ring_qp.q, ring_qp.pinv)
    torch.cuda.synchronize()
    want = bconv_cuda.bconv64_plain(yd, qhat_conv.cpu(), ring_qp.q.cpu(), ring_qp.pinv.cpu())
    assert torch.equal(raw.cpu(), want) and raw.shape == (32, 2, 6, n)
    assert bconv_cuda.launches == {'bconv64_convert': before['bconv64_convert'] + 1,
                                   'bconv64_raw': before['bconv64_raw'] + 1}
    with pytest.raises(ValueError):
        bconv_cuda.bconv64_convert(y[..., :3, :].to(cuda), conv_g)          # L = 3 for 4 limbs
    small = tuple(gen_ntt_primes(n, 31, 3))
    with pytest.raises(ValueError):                                         # a 32-bit holder
        bconv_cuda.bconv64_convert(y[..., :2, :].to(cuda), BasisConv(small[:2], small[2:], cuda))
    assert bconv_cuda.launches['bconv64_convert'] == before['bconv64_convert'] + 1


@pytest.mark.parametrize('bits,L,T,groups,top,instance,fold', [
    (57, 4, 6, 1, False, 'specific', 4),     # the extension and scale_and_back's Q -> aux
    (59, 5, 5, 1, True, 'specific', 5),      # Shenoy's B -> Q u m_sk
    (55, 2, 4, 1, False, 'specific', 2),     # RoundDivP's P -> Q
    (57, 2, 6, 2, True, 'specific', 2),      # the key switch's mod-up, two digits
    (57, 3, 6, 1, False, 'generic', 3),
    (61, 10, 4, 1, True, 'generic', 8),      # ten 61-bit sources: a fold past the eighth term
    (57, 6, 5, 3, True, 'generic', 4),       # raw at the word's guard: a fold past the fourth
    (55, 32, 3, 1, True, 'generic', 32),
], ids=['extend', 'shenoy', 'round_div_p', 'modup', 'generic', 'fold8', 'fold4_groups3',
        'L32'])
def test_b6_instances_and_fold_match_plain(cuda, bits, L, T, groups, top, instance, fold):
    """Every compile-time (L, T) instance, the generic one, and the fold,
    through ``bconv64_convert`` (groups = 1: a BasisConv, its sources
    decomposed or all q - 1) or ``bconv64_raw`` (groups > 1: every group its
    own constants, residues up to the word's guard 2^62 - 1), at n = 2048."""
    from lattisense_torch.core.rns import BasisConv
    from lattisense_torch.ops import bconv_cuda
    n = 2048
    src = tuple(gen_ntt_primes(n, bits, L))
    dst = tuple(gen_ntt_primes(n, 59 if bits != 59 else 57, T, exclude=src))
    before = dict(bconv_cuda.launches)
    if groups == 1:
        conv_c, conv_g = BasisConv(src, dst, CPU, 64), BasisConv(src, dst, cuda, 64)
        assert bconv_cuda.instance(L, T, max(src) - 1) == instance
        assert bconv_cuda.lazy_fold(L, max(src) - 1) == fold
        y = conv_c.decompose(residues(L + T, src, n, (5,)))
        if top:
            y[1:3] = torch.tensor(src).reshape(-1, 1) - 1
        got = bconv_cuda.bconv64_convert(y.to(cuda), conv_g)
        want = bconv_cuda.bconv64_plain(y, conv_c.qhat_dst_mont, conv_c.dst_q, conv_c.dst_pinv)
        name = 'bconv64_convert'
    else:
        assert bconv_cuda.instance(L, T, bconv_cuda.WORD_GUARD) == instance
        assert bconv_cuda.lazy_fold(L, bconv_cuda.WORD_GUARD) == fold
        gen = torch.Generator().manual_seed(L + T)
        y = torch.randint(0, 1 << 62, (5, groups, L, n), generator=gen)
        if top:
            y[1:3] = bconv_cuda.WORD_GUARD
        convs = [BasisConv(src, dst, CPU, 64) for _ in range(groups)]
        C = torch.stack([(c.qhat_dst_mont + g) % c.dst_q for g, c in enumerate(convs)])
        dq, dpinv = convs[0].dst_q, convs[0].dst_pinv
        got = bconv_cuda.bconv64_raw(y.to(cuda), C.to(cuda), dq.to(cuda), dpinv.to(cuda))
        want = bconv_cuda.bconv64_plain(y, C, dq, dpinv)
        name = 'bconv64_raw'
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert bconv_cuda.launches[name] == before[name] + 1


@pytest.mark.parametrize('levels', [(3, 2)])
def test_b7_kernel_matches_plain(cuda, levels):
    from lattisense_torch.ops import ksw64_cuda
    n = 16384
    chain = chain64(n, 8)
    q, p = chain[:6], chain[6:]
    key_c = random_key(51, q, p, n)
    key_g = KeySwitchKey(key_q=key_c.key_q.to(cuda), key_p=key_c.key_p.to(cuda))
    for level in levels:                               # level 2: the second digit is ragged
        sw_c, sw_g = KeySwitcher(q, p, n, CPU, 64), KeySwitcher(q, p, n, cuda, 64)
        beta, T = sw_c.beta(level), level + 1 + len(p)
        d = residues(52 + level, sw_c.ring_qp(level).moduli, n, (32, beta))
        before = dict(ksw64_cuda.launches)
        got = ksw64_cuda.ksw_inner64(d.to(cuda), key_g, level, sw_g.ring_qp(level))
        torch.cuda.synchronize()
        want = ksw64_cuda.ksw_inner64_plain(d, key_c, level, sw_c.ring_qp(level))
        assert got.shape == (32, 2, T, n) and torch.equal(got.cpu(), want), level
        assert ksw64_cuda.launches['ksw_inner64'] == before['ksw_inner64'] + 1
        # the whole 64-bit key switch: B6, B5, B7, B5, B6 against the plain composition
        x = residues(60 + level, q[:level + 1], n, (4,))
        for output_ntt in (False, True):
            e = sw_g.switch(x.to(cuda), key_g, level, output_ntt)
            w = sw_c.switch_plain(x, key_c, level, output_ntt)
            assert torch.equal(e[0].cpu(), w[0]) and torch.equal(e[1].cpu(), w[1])


def test_batched_u64_card_matches_cpu(cuda):
    """mult_relin and rotate_col at BfvParams.create(16384), level 3, B=2:
    the card's kernels against the port's plain path on the CPU."""
    from lattisense_torch.ops import bconv_cuda, ksw64_cuda, ntt64_cuda
    params = BfvParams.create(16384)
    ctx = BfvContext.create_random_context(params, seed=8, device=cuda)
    elt = galois_elt_col(1, params.n)
    ctx.gen_galois_keys_for_elements([elt])
    rng = np.random.default_rng(8)
    ma, mb = rng.integers(0, params.t, (2, 2, params.n))
    a = torch.stack([ctx.encrypt(ctx.encode(m, 3)).data for m in ma])
    b = torch.stack([ctx.encrypt(ctx.encode(m, 3)).data for m in mb])
    keys = key_tree(ctx, galois_elts=[elt])
    counts = (ntt64_cuda.launches, bconv_cuda.launches, ksw64_cuda.launches, ntt_cuda.launches)
    before = [dict(c) for c in counts]
    out = make_batched_step(ctx.engine, bfv_mult_relin, 3)(a, b, keys)
    rot = make_batched_step(ctx.engine, make_rotate_step(elt), 3, n_inputs=1)(a, keys)
    for k in ('ntt64_fwd', 'ntt64_inv'):
        assert ntt64_cuda.launches[k] > before[0][k]
    assert bconv_cuda.launches['bconv64_convert'] > before[1]['bconv64_convert']
    assert bconv_cuda.launches['bconv64_raw'] > before[1]['bconv64_raw']
    assert ksw64_cuda.launches['ksw_inner64'] == before[2]['ksw_inner64'] + 2
    assert ntt_cuda.launches == before[3]
    cpu_keys = {'rlk': KeySwitchKey(key_q=ctx.rlk.key_q.cpu(), key_p=ctx.rlk.key_p.cpu()),
                'glk': {elt: KeySwitchKey(key_q=keys['glk'][elt].key_q.cpu(),
                                          key_p=keys['glk'][elt].key_p.cpu())}}
    eng_c = BfvEngine(params, CPU)
    want = make_batched_step(eng_c, bfv_mult_relin, 3)(a.cpu(), b.cpu(), cpu_keys)
    want_rot = make_batched_step(eng_c, make_rotate_step(elt), 3, n_inputs=1)(a.cpu(), cpu_keys)
    assert torch.equal(out.cpu(), want) and torch.equal(rot.cpu(), want_rot)
    half = params.n // 2
    for i in range(2):
        assert np.array_equal(ctx.decrypt_decode(Ciphertext(data=out[i], level=3)),
                              (ma[i] * mb[i]) % params.t)
        assert np.array_equal(ctx.decrypt_decode(Ciphertext(data=rot[i], level=3)),
                              np.concatenate([np.roll(ma[i][:half], -1),
                                              np.roll(ma[i][half:], -1)]))


# ---------------------------------------------------------------------------
# the split's limits, and the n=32768 u64 path
# ---------------------------------------------------------------------------

def test_split_refusals(cuda):
    """B1 and B5 refuse 2^17, before any launch. At 2^16 B1's r4 / perm
    entries (B1's cluster kernel, the perm entries with their transpose
    pass), B4 and B3's cluster route run and equal their twins; B3's fused
    route refuses 2^16."""
    from lattisense_torch.ops import ntt64_cuda
    counts = (ntt_cuda.launches, ntt64_cuda.launches, behz_cuda.launches, ksw_cuda.launches)
    before = [dict(c) for c in counts]
    n17 = 1 << 17
    r17 = get_rns_ring(gen_ntt_primes(n17, 31, 1), n17, cuda)
    r17_64 = get_rns_ring(gen_ntt_primes(n17, 59, 1), n17, cuda, 64)
    x17, x17_64 = card_residues(r17, (1,), 1), card_residues(r17_64, (1,), 2)
    for fn, x, ring in ((ntt_cuda.ntt32_fwd, x17, r17), (ntt_cuda.ntt32_inv, x17, r17),
                        (ntt64_cuda.ntt64_fwd, x17_64, r17_64),
                        (ntt64_cuda.ntt64_inv, x17_64, r17_64)):
        with pytest.raises(ValueError):
            fn(x, ring)
    n = 1 << 16
    chain = gen_ntt_primes(n, 31, 5)
    r16 = get_rns_ring(chain[:2], n, cuda)
    x = card_residues(r16, (1,), 3)
    sw = KeySwitcher(tuple(chain[:3]), tuple(chain[3:]), n, cuda)
    key = card_key(random_key(6, tuple(chain[:3]), tuple(chain[3:]), n), cuda)
    xq = card_residues(get_rns_ring(chain[:3], n, cuda), (1,), 7)
    with pytest.raises(ValueError):
        ksw_cuda._switch(xq, key, sw, 2, False, 'fused')
    assert [dict(c) for c in counts] == before
    f = ntt_cuda.ntt_plain(x, r16)
    for fn, arg, want in ((ntt_cuda.ntt32_fwd_r4, x, f), (ntt_cuda.ntt32_inv_r4, f, x),
                          (ntt_cuda.ntt32_fwd_perm, x, ntt_cuda.perm_layout(f)),
                          (ntt_cuda.ntt32_inv_perm, ntt_cuda.perm_layout(f), x)):
        assert torch.equal(fn(arg, r16), want), fn.__name__
        assert ntt_cuda.launches[fn.__name__] == before[0][fn.__name__] + 1
    params = BfvParams.create_custom(n, 65537, chain[:3], chain[3:], word_bits=32)
    b2_b4_cluster_match_plain(cuda, params, (2,), ((1,),))
    assert ksw_cuda.switch_route(n) == 'cluster'
    for output_ntt in (False, True):
        got = ksw_cuda.ksw_switch32(xq, key, sw, 2, output_ntt)
        want = sw.switch_plain(xq, key, 2, output_ntt)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), output_ntt


def b3_at_n65536(cuda, params, levels, batch):
    """B3's cluster route at n = 2^16 on ``params``' chain against
    ``switch_plain`` on the card, at each level, both outputs, with a random
    key of the chain's shape: one count a call, and B1 only for the output
    NTT (one cluster launch)."""
    q, p, n = tuple(params.q), tuple(params.p), params.n
    sw = KeySwitcher(q, p, n, cuda, 32)
    gen = torch.Generator(device=cuda).manual_seed(11)
    beta = (len(q) + len(p) - 1) // len(p)

    def rnd(moduli, lead):
        m = torch.tensor(moduli, dtype=torch.int64, device=cuda).reshape(-1, 1)
        return torch.randint(0, 1 << 62, (*lead, len(moduli), n), generator=gen, device=cuda) % m
    key = KeySwitchKey(key_q=rnd(q, (beta, 2)), key_p=rnd(p, (beta, 2)))
    for level in levels:
        x = rnd(q[:level + 1], (batch,))
        for output_ntt in (False, True):
            before = {**ntt_cuda.launches, **ksw_cuda.launches}
            got = ksw_cuda.ksw_switch32(x, key, sw, level, output_ntt)
            after = {**ntt_cuda.launches, **ksw_cuda.launches}
            want = sw.switch_plain(x, key, level, output_ntt)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
                (level, output_ntt)
            assert after == {**before, 'ksw_switch32': before['ksw_switch32'] + 1,
                             'ntt32_fwd': before['ntt32_fwd'] + output_ntt,
                             'ntt32_fwd_cluster': before['ntt32_fwd_cluster'] + output_ntt}


@pytest.mark.parametrize('profile', ['tpu_btp', 'tpu_65536'])
def test_b3_n65536_matches_plain(cuda, profile):
    """B3 at n = 2^16 on the 31-bit profiles that need it: the bootstrap
    chain of ``CkksParams.create_tpu_btp_param()`` (48 q, 4 p: alpha 4, beta
    up to 12, T up to 52) at its top level and a low one, and
    ``create_tpu_param(65536)`` (44 q, 7 p) at its top level; batch 2."""
    from lattisense_torch.params import CkksParams
    if profile == 'tpu_btp':
        params = CkksParams.create_tpu_btp_param(1 << 16)
        b3_at_n65536(cuda, params, (len(params.q) - 1, 3), 2)
    else:
        params = CkksParams.create_tpu_param(1 << 16)
        b3_at_n65536(cuda, params, (len(params.q) - 1,), 2)


def test_ckks_n65536_w32_card_matches_cpu(cuda):
    """A CKKS relinearization and a rotation on a CUDA context of
    ``CkksParams.create_tpu_param(65536)`` (44 q, 7 p 31-bit primes), at the
    top level, against the same ops on a CPU context holding the same keys,
    bit for bit, at the profile's scale 2^30 and at 2^40. At 2^30 the
    rotation's error peaks on the slots where the all-ones polynomial's
    embedding peaks: the key switch's mod-up digits have a mean of about
    alpha*Q_j/2 a coefficient, which multiplies each key error by
    sum_k X^k (held against the reference at n = 1024 in
    ``tests/test_torch_ckks.py``), so the bound there is 1e-2 plus that
    embedding over its peak; at 2^40 every slot is within 1e-2."""
    from lattisense_torch.params import CkksParams
    from lattisense_torch.runtime import CkksContext
    from lattisense_torch.schemes.encoding import ckks_decode_values
    params = CkksParams.create_tpu_param(1 << 16)
    assert params.scale == 2.0 ** 30
    ctx = CkksContext.create_random_context(params, seed=13, device=cuda)
    elt = galois_elt_col(1, params.n)
    ctx.gen_galois_keys_for_elements([elt])
    twin = CkksContext.from_arrays(params, ctx.sk.coeffs, ctx.pk.data.cpu(), ctx.rlk.key_q.cpu(),
                                   ctx.rlk.key_p.cpu(), device=CPU)
    twin.add_galois_key_arrays(elt, ctx.glk.keys[elt].key_q.cpu(), ctx.glk.keys[elt].key_p.cpu())
    rng = np.random.default_rng(13)
    ma, mb = rng.uniform(-1, 1, (2, params.slots))
    level = params.max_level
    ones = np.abs(ckks_decode_values(np.ones(params.n, dtype=np.int64), params.n, params.slots,
                                     1.0))
    for scale in (params.scale, 2.0 ** 40):
        a, b = (ctx.encrypt(ctx.encode(m, level, scale=scale)) for m in (ma, mb))
        relin = ctx.relinearize(ctx.mult(a, b))
        rot = ctx.rotate_cols(a, 1)
        ac, bc = (Ciphertext(data=v.data.cpu(), level=level, is_ntt=True, scale=v.scale)
                  for v in (a, b))
        assert torch.equal(relin.data.cpu(), twin.relinearize(twin.mult(ac, bc)).data)
        assert torch.equal(rot.data.cpu(), twin.rotate_cols(ac, 1).data)
        assert np.abs(ctx.decrypt_decode(ctx.rescale(relin)) - ma * mb).max() < 1e-2
        err = np.abs(ctx.decrypt_decode(rot) - np.roll(ma, -1))
        top = np.argsort(err)[::-1][:3]
        print(f'scale 2^{np.log2(scale):.0f}: rotation error on slots {top.tolist()}: '
              f'{err[top].tolist()}, median {np.median(err)}')
        if scale == params.scale:
            assert np.all(err < 1e-2 + ones / ones[0]), err.max()
            assert ones[top[0]] >= np.sort(ones)[-3]
        else:
            assert err.max() < 1e-2


def test_batched_u64_32k_card_matches_cpu(cuda):
    """mult_relin and rotate_col at BfvParams.create(32768), level 11 (the
    chain's full width), B=1: B5 through its cluster kernel (counted under
    ``ntt64_*_cluster``, never its row kernel, and no columns route), B6 and
    B7 on the card against the port's plain path on the CPU, and no 32-bit
    kernel."""
    from lattisense_torch.ops import bconv_cuda, ksw64_cuda, ntt64_cuda
    level = 11
    params = BfvParams.create(32768)
    ctx = BfvContext.create_random_context(params, seed=9, device=cuda)
    elt = galois_elt_col(1, params.n)
    ctx.gen_galois_keys_for_elements([elt])
    rng = np.random.default_rng(9)
    ma, mb = rng.integers(0, params.t, (2, 1, params.n))
    a = torch.stack([ctx.encrypt(ctx.encode(m, level)).data for m in ma])
    b = torch.stack([ctx.encrypt(ctx.encode(m, level)).data for m in mb])
    keys = key_tree(ctx, galois_elts=[elt])
    counts = (ntt64_cuda.launches, bconv_cuda.launches, ksw64_cuda.launches, ntt_cuda.launches)
    before = [dict(c) for c in counts]
    out = make_batched_step(ctx.engine, bfv_mult_relin, level)(a, b, keys)
    rot = make_batched_step(ctx.engine, make_rotate_step(elt), level, n_inputs=1)(a, keys)
    for k in ('ntt64_fwd_cluster', 'ntt64_inv_cluster'):
        assert ntt64_cuda.launches[k] > before[0][k], k
    for k in ('ntt64_fwd', 'ntt64_inv'):
        assert ntt64_cuda.launches[k] == before[0][k], k
    assert not [k for k in ntt64_cuda.launches if k.endswith('_cols')]
    assert bconv_cuda.launches['bconv64_convert'] > before[1]['bconv64_convert']
    assert ksw64_cuda.launches['ksw_inner64'] == before[2]['ksw_inner64'] + 2
    assert ntt_cuda.launches == before[3]
    cpu_keys = {'rlk': KeySwitchKey(key_q=ctx.rlk.key_q.cpu(), key_p=ctx.rlk.key_p.cpu()),
                'glk': {elt: KeySwitchKey(key_q=keys['glk'][elt].key_q.cpu(),
                                          key_p=keys['glk'][elt].key_p.cpu())}}
    eng_c = BfvEngine(params, CPU)
    want = make_batched_step(eng_c, bfv_mult_relin, level)(a.cpu(), b.cpu(), cpu_keys)
    want_rot = make_batched_step(eng_c, make_rotate_step(elt), level, n_inputs=1)(a.cpu(),
                                                                                  cpu_keys)
    assert torch.equal(out.cpu(), want) and torch.equal(rot.cpu(), want_rot)
    assert np.array_equal(ctx.decrypt_decode(Ciphertext(data=out[0], level=level)),
                          (ma[0] * mb[0]) % params.t)


# ---------------------------------------------------------------------------
# B5's cluster kernel and B7 at the n=32768 path's shapes
# ---------------------------------------------------------------------------

def u64_32k_rings(cuda):
    """The rings of the u64 n=32768 path: q and aux of create(32768)'s BEHZ
    at level 11, and its key switch's Q_11 u P."""
    eng = BfvEngine(BfvParams.create(32768), cuda)
    bz, sw = eng.behz(11), eng.switcher
    return bz.ring_q, bz.ring_aux, sw.ring_qp(11), sw.beta(11)


@pytest.mark.parametrize('logn', [15, 16])
def test_b5_cluster_matches_plain(cuda, logn):
    """The cluster kernel against its twin on the card at the path's stacks
    (n=2^15: the forward's (32,4,12|14|15,n), the inverse's (32,3,12|14,n)
    and (32,2,15,n); n=2^16: (37,12,n)) and at an odd row count, both
    directions, with and without to_mont / from_mont; one launch a call."""
    from lattisense_torch.ops import ntt64_cuda
    n = 1 << logn
    if logn == 15:
        rq, ra, rqp, beta = u64_32k_rings(cuda)
        fwd = [(rq, (32, 4)), (ra, (32, 4)), (rqp, (32, beta)), (rq, (7,))]
        inv = [(rq, (32, 3)), (ra, (32, 3)), (rqp, (32, 2)), (rqp, (3,))]
    else:
        ring = get_rns_ring([p for bits in (61, 60) for p in gen_ntt_primes(n, bits, 6)], n,
                            cuda, 64)
        fwd = inv = [(ring, (37,)), (get_rns_ring(ring.moduli[:3], n, cuda, 64), (7,))]
    for calls, inverse in ((fwd, False), (inv, True)):
        for i, (ring, lead) in enumerate(calls):
            x = card_residues(ring, lead, 90 + i)
            before = dict(ntt64_cuda.launches)
            if inverse:
                got = [ntt64_cuda.ntt64_inv(x, ring), ntt64_cuda.ntt64_inv(x, ring, from_mont=True)]
                want = [ntt64_cuda.intt64_plain(x, ring), ntt64_cuda.intt64_plain(x, ring, True)]
                name = 'ntt64_inv_cluster'
            else:
                got = [ntt64_cuda.ntt64_fwd(x, ring), ntt64_cuda.ntt64_fwd(x, ring, to_mont=True)]
                want = [ntt64_cuda.ntt64_plain(x, ring), ntt64_cuda.ntt64_plain(x, ring, True)]
                name = 'ntt64_fwd_cluster'
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (inverse, lead)
            assert ntt64_cuda.launches == {**before, name: before[name] + 2}


def test_b5_cluster_refusals(cuda):
    """The cluster kernel refuses n = 2^17, a non-contiguous stack at its
    launch (the wrappers hand it a contiguous copy), and, at its C entry, a
    sub-row size other than the one it was built for; each before any
    launch."""
    from lattisense_torch.ops import cuda_build, ntt64_cuda
    before = dict(ntt64_cuda.launches)
    n17 = 1 << 17
    r17 = get_rns_ring(gen_ntt_primes(n17, 59, 1), n17, cuda, 64)
    for fn in (ntt64_cuda.ntt64_fwd, ntt64_cuda.ntt64_inv):
        with pytest.raises(ValueError):
            fn(card_residues(r17, (1,), 1), r17)
    n = 1 << 15
    ring = get_rns_ring(gen_ntt_primes(n, 59, 2), n, cuda, 64)
    x = card_residues(ring, (3,), 2)
    strided = card_residues(ring, (4,), 4)[::2]        # every other (2, n) stack
    y = torch.empty(strided.shape, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ntt64_cuda.launch(strided, y, ring, inverse=False)
    lib = cuda_build.load('ntt64', ntt64_cuda._SIGNATURES)
    tabs = ntt64_cuda._tables(ring)
    for logs in (ntt64_cuda.SUB_LOGN - 1, ntt64_cuda.SUB_LOGN + 1):
        assert lib.ntt64_cluster_launch(
            x.data_ptr(), x.data_ptr(), 3, 2, 15, logs, 0, tabs['fwd'].data_ptr(),
            tabs['cols_fwd'].data_ptr(), tabs['cols_q'].data_ptr(), None, None,
            torch.cuda.current_stream().cuda_stream) != 0
    assert ntt64_cuda.launches == before
    assert ntt64_cuda.cluster_fit(15, False) > 0 and ntt64_cuda.cluster_fit(16, True) > 0
    # a non-contiguous stack through the public wrapper: a contiguous copy
    xs = card_residues(ring, (2, 3), 3).transpose(0, 1)
    assert torch.equal(ntt64_cuda.ntt64_fwd(xs, ring), ntt64_cuda.ntt64_plain(xs.contiguous(), ring))


@pytest.mark.parametrize('n,nq,npp,level,G', [
    (16384, 6, 2, 3, 32),         # the u64 path: digits (32, 2, 6, n)
    (32768, 12, 3, 11, 32),       # the n=32768 path: digits (32, 4, 15, n)
    (32768, 12, 3, 11, 7),        # G no multiple of the chunk
    (2048, 9, 1, 8, 5),           # beta = 9: the run-time-beta instance
])
def test_b7_path_shapes_match_plain(cuda, n, nq, npp, level, G):
    """B7 against its twin on the card at both path shapes, at a polynomial
    count that is no multiple of its chunk, and past its compile-time betas;
    the constants of the thread map agree with the library's."""
    from lattisense_torch.ops import cuda_build, ksw64_cuda
    if n >= 16384:
        params = BfvParams.create(n)
        q, p = tuple(params.q), tuple(params.p)
    else:
        q, p = tuple(gen_ntt_primes(n, 59, nq)), tuple(gen_ntt_primes(n, 61, npp))
    sw_c, sw_g = KeySwitcher(q, p, n, CPU, 64), KeySwitcher(q, p, n, cuda, 64)
    beta = sw_c.beta(level)
    key_c = random_key(81, q, p, n)
    key_g = card_key(key_c, cuda)
    d = residues(82, sw_c.ring_qp(level).moduli, n, (G, beta))
    before = ksw64_cuda.launches['ksw_inner64']
    got = ksw64_cuda.ksw_inner64(d.to(cuda), key_g, level, sw_g.ring_qp(level))
    torch.cuda.synchronize()
    assert got.shape == (G, 2, level + 1 + len(p), n)
    assert torch.equal(got.cpu(), ksw64_cuda.ksw_inner64_plain(d, key_c, level, sw_c.ring_qp(level)))
    assert ksw64_cuda.launches['ksw_inner64'] == before + 1
    lib = cuda_build.load('ksw64', ksw64_cuda._SIGNATURES)
    assert (lib.ksw64_chunk(), lib.ksw64_threads()) == (ksw64_cuda.CHUNK, ksw64_cuda.THREADS)
    assert (beta > lib.ksw64_max_beta()) == (nq == 9)


# ---------------------------------------------------------------------------
# B8: the NTT-domain tensor product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('bits,n,L,lead,a_to_mont', [
    (64, 65536, 10, (32,), False), (64, 65536, 10, (32,), True),     # the CKKS cell's
    (32, 16384, 8, (32,), False), (32, 16384, 11, (32,), False),     # the BFV cell's q, aux
    (64, 8, 5, (3, 3), True), (32, 2, 3, (7,), False)])
def test_b8_kernel_matches_plain(cuda, bits, n, L, lead, a_to_mont):
    """B8 against its plain twin on the card, bit for bit: at the 64-bit word
    on two separate ciphertext stacks, at the 32-bit word on the halves of one
    (..., 4, L, n) stack read in place; a misaligned copy of a gives the same;
    one launch a call."""
    from lattisense_torch.ops import tensor_cuda
    ring = get_rns_ring(gen_ntt_primes(n, 60 if bits == 64 else 31, L), n, cuda, bits)
    if bits == 64:
        a, b = card_residues(ring, (*lead, 2), 1), card_residues(ring, (*lead, 2), 2)
    else:
        f = card_residues(ring, (*lead, 4), 3)
        a, b = f[..., :2, :, :], f[..., 2:, :, :]
    key = f'tensor{bits}'
    before = tensor_cuda.launches[key]
    got = tensor_cuda.tensor_product_cuda(a, b, ring, a_to_mont)
    assert tensor_cuda.launches[key] == before + 1
    want = tensor_cuda.tensor_product_plain(a, b, ring, a_to_mont)
    torch.cuda.synchronize()
    assert got.shape == (*lead, 3, L, n) and torch.equal(got, want)
    assert torch.equal(tensor_cuda.tensor_product_cuda(misaligned(a), b, ring, a_to_mont), want)
    assert tensor_cuda.launches[key] == before + 2


@pytest.mark.parametrize('bits', [32, 64])
def test_b8_on_sharded_ring_views(cuda, bits):
    """B8 on the sharded engine's ring views: a coefficient-sharded view
    (``ShardedRing``, whose ``n`` is the full degree) on a shard of n / 2
    coefficients, one launch, bit for bit against the plain twin; a view
    that holds no limb at the level (``_NoRows``), an empty product and no
    launch."""
    from lattisense_torch.ops import tensor_cuda
    from lattisense_torch.parallel.sharded_engine import ShardedRing, _NoRows
    n, L = 16384, 4
    host = get_rns_ring(gen_ntt_primes(n, 60 if bits == 64 else 31, L), n, cuda, bits)
    f = card_residues(host, (8, 4), 4)[..., n // 2:].contiguous()
    a, b = f[..., :2, :, :], f[..., 2:, :, :]
    key = f'tensor{bits}'
    before = tensor_cuda.launches[key]
    got = tensor_cuda.tensor_product_cuda(a, b, ShardedRing(host, object()), True)
    assert tensor_cuda.launches[key] == before + 1
    want = tensor_cuda.tensor_product_plain(a, b, host, True)
    torch.cuda.synchronize()
    assert got.shape == (8, 3, L, n // 2) and torch.equal(got, want)
    empty = a[..., :0, :]
    got = tensor_cuda.tensor_product_cuda(empty, empty, _NoRows(n, cuda, bits))
    assert got.shape == (8, 3, 0, n // 2) and tensor_cuda.launches[key] == before + 1


def test_b8_on_the_products_steps(cuda):
    """After warm-up, a BFV mult_relin step (w32) and a CKKS
    mult_relin_rescale step (u64) launch B8 (two and one a step) and build
    no table."""
    from lattisense_torch.ops import tensor_cuda
    from lattisense_torch.parallel.batch import ckks_mult_relin_rescale
    from lattisense_torch.runtime import CkksContext
    from lattisense_torch.utils import observability as obs
    n = 4096
    chain = gen_ntt_primes(n, 31, 6)
    params = BfvParams.create_custom(n, 65537, chain[:4], chain[4:], word_bits=32)
    ctx = BfvContext.create_random_context(params, seed=5, device=cuda)
    m = np.random.default_rng(5).integers(0, params.t, (4, n))
    a, b = (torch.stack([ctx.encrypt(ctx.encode(v, 3)).data for v in pair])
            for pair in (m[:2], m[2:]))
    bfv_step = make_batched_step(ctx.engine, bfv_mult_relin, 3)
    cparams, level = ckks_chain('u64')
    cctx = CkksContext.create_random_context(cparams, seed=9, device=cuda)
    msgs = ckks_msgs(9, 4, cparams.slots)
    ca, cb = (torch.stack([cctx.encrypt(cctx.encode(v, level)).data for v in pair])
              for pair in (msgs[:2], msgs[2:]))
    ckks_step = make_batched_step(cctx.engine, ckks_mult_relin_rescale, level, is_ntt=True)
    steps = ((bfv_step, (a, b, key_tree(ctx))), (ckks_step, (ca, cb, key_tree(cctx))))
    for step, args in steps:
        step(*args)
    before, tables = dict(tensor_cuda.launches), obs.counters()['tables_built']
    for step, args in steps:
        step(*args)
    torch.cuda.synchronize()
    assert tensor_cuda.launches == {**before, 'tensor32': before['tensor32'] + 2,
                                    'tensor64': before['tensor64'] + 1}
    assert obs.counters()['tables_built'] == tables


# ---------------------------------------------------------------------------
# the compiled-task runtime on the committed task directories
# ---------------------------------------------------------------------------

def task_context(params, elts, seed, dev):
    ctx = BfvContext.create_random_context(params, seed=seed, device=dev)
    ctx.gen_galois_keys_for_elements(elts)
    return ctx


def cpu_twin(ctx):
    """A CPU context holding ``ctx``'s keys."""
    twin = type(ctx).from_arrays(ctx.params, ctx.sk.coeffs, ctx.pk.data.cpu(),
                                 ctx.rlk.key_q.cpu(), ctx.rlk.key_p.cpu(), device=CPU)
    for elt, k in ctx.glk.keys.items():
        twin.add_galois_key_arrays(elt, k.key_q.cpu(), k.key_p.cpu())
    return twin


def flat_outputs(out):
    def flat(v):
        return [e for x in v for e in flat(x)] if isinstance(v, list) else [v]
    return [v for k in sorted(out) for v in flat(out[k])]


def on_cpu(v):
    if isinstance(v, list):
        return [on_cpu(e) for e in v]
    import dataclasses
    return dataclasses.replace(v, data=v.data.cpu())


def task_arguments(name, ctx, seed):
    """(online, offline, expected slots by output) of a committed task."""
    from lattisense_torch.runtime import tasks
    t, n = ctx.params.t, ctx.params.n
    if name == tasks.MULT_RELIN:
        rng = np.random.default_rng(seed)
        ma, mb = rng.integers(0, t, (2, tasks.MULT_RELIN_COUNT, n))
        enc = [[ctx.encrypt(ctx.encode(m, 7)) for m in ms] for ms in (ma, mb)]
        return (tasks.mult_relin_arguments(*enc), {},
                {f'z{k}': [(ma[k] * mb[k]) % t] for k in range(len(ma))})
    level = 7 if name == tasks.MIX_W32 else 3
    msgs = tasks.mix_messages(t, n, seed)
    online, offline = tasks.mix_arguments(ctx, level, msgs)
    expected = {k: v if isinstance(v, list) else [v]
                for k, v in tasks.mix_expected(msgs, t).items()}
    return online, offline, expected


@pytest.mark.parametrize('name', ['bfv_mult_relin_x32_w32_n16384_l7', 'bfv_ops_mix_w32_n16384_l7',
                                  'bfv_ops_mix_u64_n16384_l3'])
def test_task_fixture_card_matches_cpu(cuda, name):
    """A committed task on the card: eager equals the port's CPU run bit for
    bit, the graph replay equals eager (twice, the second replaying the
    captured graph), the mult_relin task fuses to 2 steps; a second context
    with other keys through the same task object gets its own results (a new
    graph), and the first context's graph still replays right after it."""
    import json
    import os
    from lattisense_torch.runtime import FheTask, tasks
    d = tasks.task_dir(name)
    params = BfvParams.create(16384) if 'u64' in name else BfvParams.create_tpu_param(16384)
    with open(os.path.join(d, 'task_signature.json')) as f:
        elts = [int(e) for e in json.load(f)['key']['glk']]
    eager, jit = FheTask(d, mode='eager'), FheTask(d, mode='jit')
    assert eager.device == jit.device == cuda
    if name == tasks.MULT_RELIN:
        assert len(jit.plan) == 2
    ctx = task_context(params, elts, 11, cuda)
    online, offline, expected = task_arguments(name, ctx, 3)
    for task in (eager, jit):
        task.preload(ctx, offline)
    want, _ = eager.run(ctx, online)
    first, _ = jit.run(ctx, online)
    again, dur = jit.run(ctx, online)
    assert dur > 0 and len(jit._graphs) == 1
    for out in (first, again):
        assert all(torch.equal(a.data, b.data) for a, b in zip(flat_outputs(out),
                                                               flat_outputs(want)))
    twin = cpu_twin(ctx)
    cpu_task = FheTask(d, mode='eager', device=CPU)
    cpu_task.preload(twin, {k: on_cpu(v) for k, v in offline.items()})
    got_cpu, _ = cpu_task.run(twin, {k: on_cpu(v) for k, v in online.items()})
    assert all(torch.equal(a.data.cpu(), b.data) for a, b in zip(flat_outputs(want),
                                                                 flat_outputs(got_cpu)))
    # a second context: other keys, other arguments, through the same objects
    ctx2 = task_context(params, elts, 12, cuda)
    online2, offline2, expected2 = task_arguments(name, ctx2, 4)
    for task in (eager, jit):
        task.preload(ctx2, offline2)
    got2, _ = jit.run(ctx2, online2)
    want2, _ = eager.run(ctx2, online2)
    assert len(jit._graphs) == 2
    assert all(torch.equal(a.data, b.data) for a, b in zip(flat_outputs(got2),
                                                           flat_outputs(want2)))
    for k in sorted(expected2):
        vals = got2[k] if isinstance(got2[k], list) else [got2[k]]
        for v, m in zip(vals, expected2[k]):
            assert np.array_equal(ctx2.decrypt_decode(tasks.coefficient_form(ctx2.engine, v)), m), k
    jit.preload(ctx, offline)
    back, _ = jit.run(ctx, online)
    assert all(torch.equal(a.data, b.data) for a, b in zip(flat_outputs(back), flat_outputs(want)))
    k0 = sorted(expected)[0]
    v0 = back[k0] if isinstance(back[k0], list) else [back[k0]]
    assert np.array_equal(ctx.decrypt_decode(tasks.coefficient_form(ctx.engine, v0[0])),
                          expected[k0][0])


# ---------------------------------------------------------------------------
# CKKS on the card
# ---------------------------------------------------------------------------

def ckks_chain(word):
    """(params, level) of a CKKS path: CkksParams.create(16384) at level 3,
    or the composite 2^60 chain on create_tpu_param(16384)'s primes at 10."""
    from lattisense_torch.params import CkksParams
    from lattisense_torch.parallel.batch import ckks_composite_params
    if word == 'u64':
        return CkksParams.create(16384), 3
    return ckks_composite_params(16384), 10


def ckks_msgs(seed, count, slots):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (count, slots)) + 1j * rng.uniform(-1, 1, (count, slots))


@pytest.mark.parametrize('word', ['u64', 'w32'])
def test_ckks_engine_ops_card_match_cpu(cuda, word):
    """Every CKKS evaluation op at n=1024 on the card (the pt_ringt lift, an
    encode_const plaintext, a dropped level, the hoisted and plain rotations,
    the conjugation, a key switch, the scalar product) equals the CPU twin."""
    from lattisense_torch.params import CkksParams
    from lattisense_torch.runtime import CkksContext
    from lattisense_torch.schemes.ckks import CkksEngine
    from lattisense_torch.schemes.galois import galois_elt_row
    n = 1024
    if word == 'w32':
        primes = gen_ntt_primes(n, 31, 7)
        params = CkksParams.create_custom(n, primes[:5], primes[5:], scale=2.0 ** 30,
                                          word_bits=32)
    else:
        big = gen_ntt_primes(n, 60, 2)
        params = CkksParams.create_custom(n, [big[0]] + gen_ntt_primes(n, 40, 4), [big[1]],
                                          scale=2.0 ** 40)
    ctx = CkksContext.create_random_context(params, seed=14, device=cuda)
    elts = [galois_elt_col(1, n), galois_elt_row(n)]
    ctx.gen_galois_keys_for_elements(elts)
    twin = cpu_twin(ctx)
    ec, eg = CkksEngine(params, CPU), ctx.engine
    lv = params.max_level
    m = ckks_msgs(14, 3, params.slots)
    a, b = (ctx.encrypt(ctx.encode(v, lv)) for v in m[:2])
    pts = {'pt': ctx.encode(m[2], lv), 'ringt': ctx.encode_ringt(m[2]),
           'mul': ctx.encode_mul(m[2], lv), 'const': eg.encode_const(-0.75, lv)}

    def ops(e, keys, a, b, pts):
        rlk, glk = keys
        d = e.rns_sp_decomp(a)
        return ([e.add(a, b), e.sub(a, pts['pt']), e.add(a, pts['ringt']), e.sub(a, pts['const']),
                 e.neg(a), e.mult(a, pts['pt']), e.mult(a, pts['ringt']), e.mult(a, pts['mul']),
                 e.rescale(e.relinearize(e.mult(a, b), rlk)), e.drop_level(a, 2),
                 e.rotate(a, 1, glk[elts[0]]), e.conjugate(a, glk[elts[1]]),
                 e.apply_galois_decomposed(d, elts[0], glk[elts[0]]), e.key_switch(a, rlk),
                 e.mult_scalar(a, 0.5)])
    got = ops(eg, (ctx.rlk, ctx.glk.keys), a, b, pts)
    want = ops(ec, (twin.rlk, twin.glk.keys), on_cpu(a), on_cpu(b),
               {k: on_cpu(v) for k, v in pts.items()})
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.data.cpu(), w.data) and (g.level, g.scale) == (w.level, w.scale), k
    assert np.abs(ctx.decrypt_decode(got[8]) - m[0] * m[1]).max() < 1e-3


@pytest.mark.parametrize('word', ['u64', 'w32'])
def test_ckks_batched_step_card_matches_cpu(cuda, word):
    """ckks_mult_relin_rescale (u64, level 3) or ckks_mult_relin_rescale2
    (w32 composite, level 10) and rotate by 1, B=2: the card equals the CPU
    twin bit for bit, the word's kernels were launched (B5, B6, B7; or B1's
    own entries and B3), and element 0 decodes within 1e-3."""
    from lattisense_torch.ops import bconv_cuda, ksw64_cuda, ntt64_cuda
    from lattisense_torch.parallel.batch import ckks_mult_relin_rescale, ckks_mult_relin_rescale2
    from lattisense_torch.runtime import CkksContext
    from lattisense_torch.schemes.ckks import CkksEngine
    params, level = ckks_chain(word)
    step_fn = ckks_mult_relin_rescale if word == 'u64' else ckks_mult_relin_rescale2
    ctx = CkksContext.create_random_context(params, seed=9, device=cuda)
    elt = galois_elt_col(1, params.n)
    ctx.gen_galois_keys_for_elements([elt])
    m = ckks_msgs(9, 4, params.slots)
    a = torch.stack([ctx.encrypt(ctx.encode(v, level)).data for v in m[:2]])
    b = torch.stack([ctx.encrypt(ctx.encode(v, level)).data for v in m[2:]])
    keys = key_tree(ctx, galois_elts=[elt])
    counts = (ntt_cuda.launches, ksw_cuda.launches, ntt64_cuda.launches, bconv_cuda.launches,
              ksw64_cuda.launches, behz_cuda.launches)
    before = [dict(c) for c in counts]
    out = make_batched_step(ctx.engine, step_fn, level, is_ntt=True)(a, b, keys)
    rot = make_batched_step(ctx.engine, make_rotate_step(elt), level, n_inputs=1,
                            is_ntt=True)(a, keys)
    after = [dict(c) for c in counts]
    if word == 'u64':
        risen = [after[2][k] > before[2][k] for k in ('ntt64_fwd', 'ntt64_inv')]
        risen += [after[3][k] > before[3][k] for k in ('bconv64_convert', 'bconv64_raw')]
        risen += [after[4]['ksw_inner64'] == before[4]['ksw_inner64'] + 2]
        assert all(risen) and after[0] == before[0] and after[1] == before[1]
    else:
        assert after[0]['ntt32_fwd'] == before[0]['ntt32_fwd'] + 3 + 1
        assert after[0]['ntt32_inv'] == before[0]['ntt32_inv'] + 3 + 1
        assert after[1]['ksw_switch32'] == before[1]['ksw_switch32'] + 2
        assert after[2:] == before[2:]
    cpu_keys = {'rlk': KeySwitchKey(key_q=ctx.rlk.key_q.cpu(), key_p=ctx.rlk.key_p.cpu()),
                'glk': {elt: KeySwitchKey(key_q=keys['glk'][elt].key_q.cpu(),
                                          key_p=keys['glk'][elt].key_p.cpu())}}
    eng_c = CkksEngine(params, CPU)
    want = step_fn(eng_c, *[Ciphertext(data=x.cpu(), level=level, is_ntt=True,
                                       scale=params.scale) for x in (a, b)], cpu_keys)
    want_rot = make_batched_step(eng_c, make_rotate_step(elt), level, n_inputs=1,
                                 is_ntt=True)(a.cpu(), cpu_keys)
    assert torch.equal(out.cpu(), want.data) and torch.equal(rot.cpu(), want_rot)
    got = ctx.decrypt_decode(Ciphertext(data=out[0], level=want.level, is_ntt=True,
                                        scale=want.scale))
    assert np.abs(got - m[0] * m[2]).max() < 1e-3
    got = ctx.decrypt_decode(Ciphertext(data=rot[1], level=level, is_ntt=True,
                                        scale=params.scale))
    assert np.abs(got - np.roll(m[1], -1)).max() < 1e-3


@pytest.mark.parametrize('name', ['ckks_ops_mix_w32_n16384_l10', 'ckks_ops_mix_u64_n16384_l3'])
def test_ckks_task_fixture_card_matches_cpu(cuda, name):
    """A committed CKKS task on the card: eager equals the port's CPU run
    bit for bit (data, level, scale), the replay equals eager, every output
    decodes within 1e-3; a second set of input scales captures a second
    graph, whose outputs carry the scales of that set, equal eager and
    decode within 1e-3; the first set's graph still replays right."""
    import json
    import os
    from lattisense_torch.runtime import CkksContext, FheTask, tasks
    d = tasks.task_dir(name)
    params, level = ckks_chain('u64' if 'u64' in name else 'w32')
    with open(os.path.join(d, 'task_signature.json')) as f:
        elts = [int(e) for e in json.load(f)['key']['glk']]
    with open(os.path.join(d, 'mega_ag.json')) as f:
        scale = float(json.load(f)['parameter']['scale'])
    ctx = CkksContext.create_random_context(params, seed=13, device=cuda)
    ctx.gen_galois_keys_for_elements(elts)
    msgs = tasks.ckks_mix_messages(params.slots, 5)
    expected = tasks.ckks_mix_expected(msgs)
    eager, jit = FheTask(d, mode='eager'), FheTask(d, mode='jit')

    def run(s):
        online, offline = tasks.ckks_mix_arguments(ctx, level, msgs, s)
        for task in (eager, jit):
            task.preload(ctx, offline)
        want, _ = eager.run(ctx, online)
        got, _ = jit.run(ctx, online)
        assert all(torch.equal(x.data, y.data) and x.scale == y.scale
                   for x, y in zip(flat_outputs(got), flat_outputs(want)))
        for k in tasks.CKKS_MIX_OUTPUTS:
            vals = got[k] if isinstance(got[k], list) else [got[k]]
            ms = expected[k] if isinstance(expected[k], list) else [expected[k]]
            for v, m in zip(vals, ms):
                assert np.abs(ctx.decrypt_decode(v) - m).max() < 1e-3, k
        return online, offline, want

    online, offline, want = run(scale)
    twin = cpu_twin(ctx)
    cpu_task = FheTask(d, mode='eager', device=CPU)
    cpu_task.preload(twin, {k: on_cpu(v) for k, v in offline.items()})
    got_cpu, _ = cpu_task.run(twin, {k: on_cpu(v) for k, v in online.items()})
    assert all(torch.equal(a.data.cpu(), b.data) and (a.level, a.scale) == (b.level, b.scale)
               for a, b in zip(flat_outputs(want), flat_outputs(got_cpu)))
    _, _, want2 = run(scale * 1.5)
    assert len(jit._graphs) == 2
    assert abs(want2['o_rs'].scale / want['o_rs'].scale - 2.25) < 1e-12
    jit.preload(ctx, offline)
    back, _ = jit.run(ctx, online)
    assert all(torch.equal(a.data, b.data) and a.scale == b.scale
               for a, b in zip(flat_outputs(back), flat_outputs(want)))


# ---------------------------------------------------------------------------
# CKKS bootstrapping at n=256, card against CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('word', [64, 32])
def test_bootstrap_n256_card_matches_cpu(cuda, word):
    """The n=256 bootstrap chains of the JAX package's tests
    (``tasks.bootstrap_n256``): a ``CkksBtpContext`` on the card and one on
    the CPU from one seed (the same keys); ``ctx.bootstrap`` and the
    committed one-node task in eager, jit (one CUDA graph) and partitioned
    (one CUDA graph a segment) modes on the card, each run twice (capture,
    replay), equal the CPU bootstrap bit for bit, with its level and scale;
    the card's launch counts show B1 and B3 (w32) or B5, B6 and B7 (u64)."""
    import dataclasses

    from lattisense_torch.ops import bconv_cuda, ksw64_cuda, ntt64_cuda
    from lattisense_torch.params import CkksParams
    from lattisense_torch.runtime import CkksBtpContext, FheTask, tasks
    from lattisense_torch.schemes.bootstrap import BootstrapConfig
    b = tasks.bootstrap_n256(word)
    params = CkksParams.create_custom(b['n'], b['q'], b['p'], scale=b['scale'], word_bits=word)
    ctxs = [CkksBtpContext.create_random_context(params, seed=b['seed'], h=b['h'],
                                                 btp_config=BootstrapConfig(**b['cfg']),
                                                 device=dev) for dev in (cuda, CPU)]
    card, twin = ctxs
    msg = np.random.default_rng(9).uniform(-1, 1, params.slots)
    x = twin.encrypt(twin.encode(msg, b['level']))
    want = twin.bootstrap(x)
    xc = dataclasses.replace(x, data=x.data.to(cuda))
    counts = (ntt_cuda.launches, ksw_cuda.launches, ntt64_cuda.launches, bconv_cuda.launches,
              ksw64_cuda.launches)
    before = {k: v for c in counts for k, v in c.items()}
    got = card.bootstrap(xc)
    after = {k: v for c in counts for k, v in c.items()}
    rose = {k for k in after if after[k] > before[k]}
    assert rose >= ({'ntt32_fwd', 'ntt32_inv', 'ksw_switch32'} if word == 32 else
                    {'ntt64_fwd', 'ntt64_inv', 'bconv64_convert', 'bconv64_raw', 'ksw_inner64'})

    def same(v):
        return torch.equal(v.data.cpu(), want.data) and (v.level, v.scale) == (want.level,
                                                                               want.scale)
    assert same(got)
    d = tasks.task_dir(tasks.BOOTSTRAP_N256[word])
    for mode in ('eager', 'jit', 'partitioned'):
        task = FheTask(d, mode=mode, device=cuda)
        for _ in range(2):
            out, _ = task.run(card, {'x': xc})
            assert same(out['z']), mode
        if mode != 'eager':
            assert task._graphs, mode


def test_bootstrap_graphs_replay_after_constant_churn(cuda):
    """Captured bootstraps (the n=256 u64 task, jit: one CUDA graph;
    partitioned: one a segment) replay bit for bit after the engine has
    encoded 5 000 more constants and the caching allocator's small blocks
    have been handed out again and overwritten: every constant column a
    graph reads in place stays alive with the engine."""
    from lattisense_torch.params import CkksParams
    from lattisense_torch.runtime import CkksBtpContext, FheTask, tasks
    from lattisense_torch.schemes.bootstrap import BootstrapConfig
    b = tasks.bootstrap_n256(64)
    params = CkksParams.create_custom(b['n'], b['q'], b['p'], scale=b['scale'], word_bits=64)
    card = CkksBtpContext.create_random_context(params, seed=b['seed'], h=b['h'],
                                                btp_config=BootstrapConfig(**b['cfg']),
                                                device=cuda)
    x = card.encrypt(card.encode(np.random.default_rng(9).uniform(-1, 1, params.slots),
                                 b['level']))
    want = card.bootstrap(x)
    d = tasks.task_dir(tasks.BOOTSTRAP_N256[64])
    runs = {mode: FheTask(d, mode=mode, device=cuda) for mode in ('jit', 'partitioned')}

    def same(v):
        return torch.equal(v.data, want.data) and (v.level, v.scale) == (want.level, want.scale)
    for mode, task in runs.items():
        out, _ = task.run(card, {'x': x})
        assert same(out['z']) and task._graphs, mode
    eng = card.engine
    for i in range(5000):
        eng.encode_const(1.0 + i / 4096, i % (params.max_level + 1))
    assert len(eng._const_cols) > 5000
    junk = [torch.full((64,), -1, dtype=torch.int64, device=cuda) for _ in range(20000)]
    for mode, task in runs.items():
        out, _ = task.run(card, {'x': x})
        assert same(out['z']), mode
    del junk


# ---------------------------------------------------------------------------
# threshold BFV, the foreign-library boundary and the memory monitor
# ---------------------------------------------------------------------------

def _mpc_run(params, level, device):
    """Every protocol of three parties (seeds 100 + i) on ``device``, the
    shares in order: CKG, RKG's two rounds, RTG (rotate_col by 1), then E2S,
    S2E and refresh with a permutation on an encryption under the collective
    key at ``level``."""
    from lattisense_torch.runtime import BfvContext as Ctx
    from lattisense_torch.schemes import multiparty as mp
    n = params.n
    parties = [mp.DBfvParty(params, seed=100 + i, device=device) for i in range(3)]
    shares = []

    def each(gen):
        out = [gen(p) for p in parties]
        shares.extend(s[0] if isinstance(s, tuple) else s for s in out)
        return out
    ckg = mp.CkgProtocol(params, 7, device=device)
    pk = ckg.aggregate(each(ckg.gen_share))
    rkg = mp.RkgProtocol(params, 11, device=device)
    agg1 = rkg.aggregate_round1(each(rkg.gen_share_round1))
    rlk = rkg.aggregate_round2(each(lambda p: rkg.gen_share_round2(p, agg1)), agg1)
    rtg = mp.RtgProtocol(params, galois_elt_col(1, n), 13, device=device)
    glk = rtg.aggregate(each(rtg.gen_share))
    ctx = Ctx.create_empty_context(params, device=device)
    ctx.pk = pk
    m = np.random.default_rng(3).integers(0, params.t, n)
    ct = ctx.engine.encrypt_asymmetric(np.random.default_rng(4), pk, ctx.encode(m, level))
    e2s = mp.E2sProtocol(ctx.engine, level)
    out = each(lambda p: e2s.gen_share(p, ct))
    residual = e2s.aggregate(ct, [s for s, _ in out])
    s2e = mp.S2eProtocol(ctx.engine, level, 17)
    ct2 = s2e.aggregate([s2e.gen_share(p, mk) for p, (_, mk) in zip(parties, out)], residual)
    perm = np.roll(np.arange(n), 5)
    ref = mp.RefreshProtocol(ctx.engine, level, 19, permutation=perm)
    fresh = ref.finalize(ct, each(lambda p: ref.gen_share(p, ct)))
    joint = SecretKey(sum(p.sk.coeffs for p in parties))
    assert np.array_equal(ctx.engine.decrypt_decode(joint, ct2), m)
    assert np.array_equal(ctx.engine.decrypt_decode(joint, fresh), m[perm])
    return [pk.data, rlk.key_q, rlk.key_p, glk.key_q, glk.key_p, ct2.data, fresh.data] + [
        s.data for s in shares]


@pytest.mark.parametrize('word', [32, 64], ids=['w32', 'u64'])
def test_multiparty_n16384_card_matches_cpu(cuda, word):
    """Every share, collective key and E2S / S2E / refresh output of the
    protocols at n=16384 (create_tpu_param L7, create L3) on the card equals
    the CPU run of the same seeds bit for bit."""
    params = BfvParams.create_tpu_param(16384) if word == 32 else BfvParams.create(16384)
    level = 7 if word == 32 else 3
    counts = ntt_cuda.launches if word == 32 else ntt64_cuda.launches
    fwd = 'ntt32_fwd' if word == 32 else 'ntt64_fwd'
    before = counts[fwd]
    card = _mpc_run(params, level, cuda)
    assert counts[fwd] > before
    for g, c in zip(card, _mpc_run(params, level, CPU)):
        assert torch.equal(g.cpu(), c)


@pytest.mark.parametrize('mf_nbits', [0, 64])
def test_foreign_task_card_matches_cpu(cuda, mf_nbits):
    """ForeignTask on the card (one CUDA graph) against the CPU on the same C
    structs: the committed mult-rotate task at n=16384, both words."""
    from lattisense_torch import abi
    from lattisense_torch.plugin import ForeignTask, ForeignVectorArgument
    from lattisense_torch.runtime import tasks
    params = BfvParams.create_tpu_param(16384)
    ctx = BfvContext.create_random_context(params, seed=21, device=CPU)
    ctx.gen_rotation_keys_for_rotations([1])
    ring = get_rns_ring(tuple(params.q) + tuple(params.p), params.n, CPU, 32)
    m = np.random.default_rng(5).integers(0, params.t, (2, params.n))
    xs, ys = (abi.export_ciphertext(ctx.encrypt(ctx.encode(v, 7))) for v in m)
    rlk = abi.export_keyswitch_key(ctx.rlk, mf_nbits, ring)
    glk = abi.export_galois_keys(ctx.glk.keys, mf_nbits, ring)
    d = tasks.task_dir(tasks.MULT_ROTATE)
    for word in (32, 64):
        if word == 64 and mf_nbits:
            continue                     # stored 32-bit Montgomery keys are not 64-bit ones
        outs = []
        for dev, mode in ((cuda, 'jit'), (CPU, 'eager')):
            task = ForeignTask(d, mode=mode, device=dev, word_bits=word)
            for _ in range(2 if dev.type == 'cuda' else 1):    # the second run replays
                out, _ = task.run(rlk=rlk.struct, glk=glk.struct, mf_nbits=mf_nbits,
                                  args=[ForeignVectorArgument('x', xs.struct),
                                        ForeignVectorArgument('y', ys.struct)])
            outs.append(abi.import_ciphertext(out['w'].struct, device=CPU).data)
        assert torch.equal(outs[0], outs[1]), word
        prod = m[0] * m[1] % params.t
        assert np.array_equal(ctx.decrypt_decode(Ciphertext(data=outs[0], level=7)),
                              np.roll(prod.reshape(2, -1), -1, axis=1).reshape(-1))


def test_memory_monitor_with_device(cuda, tmp_path):
    """The monitor's device column follows the card's tensors."""
    from lattisense_torch.utils import observability as obs
    mon = obs.MemoryMonitor(20, with_device=True)
    path = str(tmp_path / 'mem.csv')
    mon.start(path)
    x = torch.empty(1 << 28, dtype=torch.uint8, device=cuda)
    time.sleep(0.1)
    mon.stop()
    with open(path) as f:
        header = f.readline().strip().split(',')
        rows = [line.strip().split(',') for line in f if line.strip()]
    assert header[-1] == 'device_bytes_in_use' and len(rows) >= 3
    assert int(rows[-1][-1]) >= 1 << 28
    stats = obs.device_memory_stats()
    assert f'cuda:{cuda.index}' in stats
    s = stats[f'cuda:{cuda.index}']
    assert 1 << 28 <= s['bytes_in_use'] <= s['bytes_limit']
    del x


# ---------------------------------------------------------------------------
# the MXU NTT (ops/ntt_mxu.py) against B5, and a mesh world on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('route', ['bf16', 'int8'])
@pytest.mark.parametrize('chain,n', [('create16384', 16384), ('create16384', 4096),
                                     ('create4096', 4096)])
def test_mxu_ntt_matches_b5(cuda, monkeypatch, chain, n, route):
    """Both routes of the four-step NTT as matrix products equal B5 bit for
    bit, forward and inverse, on the 54-57-bit primes of create(16384) and
    the 39/40-bit ones of create(4096) (six digit planes, two chunks), and
    issue their products on the card (bmm, or one _int_mm a limb)."""
    from lattisense_torch.ops import ntt_mxu
    params = BfvParams.create(int(chain[6:]))
    ring = get_rns_ring(params.q, n, cuda, 64)
    x = card_residues(ring, (8,), 3)
    monkeypatch.setattr(ntt_mxu, 'I8DOT', route == 'int8')
    for k in ntt_mxu.launches:
        ntt_mxu.launches[k] = 0
    y = ntt_mxu.ntt(x, ring)
    assert torch.equal(y, ntt64_cuda.ntt64_fwd(x, ring))
    assert torch.equal(ntt_mxu.intt(y, ring), ntt64_cuda.ntt64_inv(y, ring))
    want = {'bf16': {'mxu_bmm': 4, 'mxu_int_mm': 0},
            'int8': {'mxu_bmm': 0, 'mxu_int_mm': 4 * len(params.q)}}[route]
    assert ntt_mxu.launches == want


def test_mxu_gate_mult_relin_card_matches_b5(cuda, monkeypatch):
    """The batched u64 mult_relin at create(16384) level 3 with the gate on
    equals the gate off bit for bit, and launches no B5."""
    from lattisense_torch.ops import ntt_mxu
    ctx = BfvContext.create_random_context(BfvParams.create(16384), seed=7, device=cuda)
    rng = np.random.default_rng(2)
    cts = [ctx.encrypt(ctx.encode(rng.integers(0, 65537, 16384), 3)) for _ in range(4)]
    a, b = torch.stack([c.data for c in cts[:2]]), torch.stack([c.data for c in cts[2:]])
    step = make_batched_step(ctx.engine, bfv_mult_relin, 3)
    want = step(a, b, key_tree(ctx))
    monkeypatch.setattr(ntt_mxu, 'ENABLED', True)
    for k in ntt64_cuda.launches:
        ntt64_cuda.launches[k] = 0
    got = step(a, b, key_tree(ctx))
    assert torch.equal(got, want)
    assert not any(ntt64_cuda.launches.values())


@pytest.mark.parametrize('path', ['limb_tp', 'mesh_op', 'task_jit'])
def test_mesh_world_on_the_card(cuda, tmp_path, path):
    """A world of 2 ranks sharing the card over gloo (its collectives staged
    through the host and counted) runs make_limb_tp_mult_relin over
    (op=1, limb=2), the op-sharded step, and the committed 32-mult_relin task
    replayed as CUDA graphs cut at each collective, over (op=2): each equal to
    the single-card step bit for bit on every rank."""
    from lattisense_torch.parallel.launch import World
    from lattisense_torch.runtime import tasks
    from lattisense_torch.tools import mesh_paths
    ctx = _mesh_ctx(cuda)
    rng = np.random.default_rng(3)
    cts = [ctx.encrypt(ctx.encode(rng.integers(0, 65537, 16384), 7)) for _ in range(64)]
    a, b = torch.stack([c.data for c in cts[:32]]), torch.stack([c.data for c in cts[32:]])
    out = make_batched_step(ctx.engine, bfv_mult_relin, 7)(a, b, key_tree(ctx))
    mesh_paths.save(str(tmp_path), 'ctx', mesh_paths.save_context(ctx))
    mesh_paths.save(str(tmp_path), 'main', {'a': a.cpu(), 'b': b.cpu(), 'out': out.cpu()})
    shape = (1, 2, 1) if path == 'limb_tp' else (2, 1, 1)
    with World(2, backend='gloo', device=cuda, timeout_s=600) as w:
        res = w.run(mesh_paths.rank_path, str(tmp_path), path, 'ctx', 'main', shape, 7, 1,
                    None, None, tasks.task_dir(tasks.MULT_RELIN))
    assert all(r['equal'] for r in res)
    assert all(r['backend'] == 'gloo' and r['collectives']['staged_bytes'] > 0 for r in res)
    if path == 'task_jit':
        assert all(r['graphs'] >= 2 for r in res)


_MESH_CTX = {}


def _mesh_ctx(cuda):
    if cuda not in _MESH_CTX:
        _MESH_CTX[cuda] = BfvContext.create_random_context(BfvParams.create_tpu_param(16384),
                                                           seed=7, device=cuda)
    return _MESH_CTX[cuda]


# ---------------------------------------------------------------------------
# the sharded engine views (parallel/sharded_engine.py) on the card
# ---------------------------------------------------------------------------

def test_coeff_engine_view_on_the_card(cuda, tmp_path):
    """The coefficient-sharded view of a 31-bit BFV engine in a world of 2
    ranks sharing the card over gloo: mult + relinearize at n = 4096, L3,
    batch 4, on its unfused route (B1 on the degree-C rings; B2, B3 and B4
    launched by neither rank), equal bit for bit on every rank to the CPU
    twin of the same seed."""
    from lattisense_torch.core.modring import gen_ntt_primes
    from lattisense_torch.parallel.launch import World
    from lattisense_torch.tools import mesh_paths
    n, level = 4096, 3
    q = gen_ntt_primes(n, 31, 4)
    p = gen_ntt_primes(n, 31, 2, exclude=tuple(q))
    params = BfvParams.create_custom(n, 65537, q, p, word_bits=32)
    card, twin = (BfvContext.create_random_context(params, seed=5, device=d) for d in (cuda, CPU))
    rng = np.random.default_rng(6)
    cts = [twin.encrypt(twin.encode(rng.integers(0, 65537, n), level)) for _ in range(8)]
    a, b = torch.stack([c.data for c in cts[:4]]), torch.stack([c.data for c in cts[4:]])
    eng = twin.engine
    want = eng.relinearize(eng.mult(Ciphertext(data=a, level=level),
                                    Ciphertext(data=b, level=level)), twin.rlk).data
    mesh_paths.save(str(tmp_path), 'ctx', mesh_paths.save_context(card))
    mesh_paths.save(str(tmp_path), 'main', {'a': a, 'b': b, 'out': want})
    with World(2, backend='gloo', device=cuda, timeout_s=600) as w:
        res = w.run(mesh_paths.rank_path, str(tmp_path), 'coeff_engine', 'ctx', 'main',
                    (1, 1, 2), level, 1)
    assert all(r['equal'] for r in res)
    for r in res:
        assert r['launches'].get('ntt32_fwd') and r['launches'].get('ntt32_inv')
        assert not any(r['launches'].get(k) for k in ('behz_prep32', 'ksw_switch32',
                                                      'behz_finish32'))


def test_coeff_sharded_bootstrap_on_the_card(cuda, tmp_path):
    """``CoeffShardedBootstrap`` of the n = 256 u64 chain in a world of 2
    ranks sharing the card: equal bit for bit on every rank to the CPU
    twin's bootstrap of the same input (one seed, the same keys)."""
    from lattisense_torch.params import CkksParams
    from lattisense_torch.parallel.launch import World
    from lattisense_torch.runtime import CkksBtpContext, tasks
    from lattisense_torch.schemes.bootstrap import BootstrapConfig
    from lattisense_torch.tools import mesh_paths
    b = tasks.bootstrap_n256(64)
    params = CkksParams.create_custom(b['n'], b['q'], b['p'], scale=b['scale'])
    twin = CkksBtpContext.create_random_context(params, seed=b['seed'], h=b['h'],
                                                btp_config=BootstrapConfig(**b['cfg']),
                                                device=CPU)
    x = twin.encrypt(twin.encode(np.random.default_rng(9).uniform(-1, 1, params.slots),
                                 b['level']))
    want = twin.bootstrap(x)
    mesh_paths.save(str(tmp_path), 'btp', {'a': x.data, 'level': x.level, 'scale': x.scale,
                                           'out': want.data})
    with World(2, backend='gloo', device=cuda, timeout_s=600) as w:
        res = w.run(mesh_paths.rank_path, str(tmp_path), 'coeff_btp', 'btp:n256', 'btp',
                    (1, 1, 2), b['level'], 1)
    assert all(r['equal'] for r in res)
    assert all(r['launches'].get('ntt64_fwd') for r in res)


def test_model_n1024_card_matches_cpu(cuda):
    """The banded ``EncryptedMatVec`` on the JAX model tests' toy chain at
    n=1024: ``load`` on a card context and on a CPU context of one seed (the
    same Galois keys), the card's eager run and its graph replay equal to the
    CPU run bit for bit, the decoded product within 5e-3 of A·x."""
    import dataclasses

    from lattisense_torch.frontend import custom_task as fe
    from lattisense_torch.models import EncryptedMatVec
    from lattisense_torch.params import CkksParams
    from lattisense_torch.runtime import CkksContext
    n = 1024
    q = gen_ntt_primes(n, 50, 5)
    p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    params = CkksParams.create_custom(n, q, p, scale=float(1 << 40))
    fparam = fe.CkksParam.create_custom_param(n=n, q=q, p=p, scale=float(1 << 40), slots=n // 2)
    rng = np.random.default_rng(4)
    s = n // 2
    A, k = np.zeros((s, s)), np.arange(s)
    for d in (0, 1, 5, 40, 300):
        A[k, (k + d) % s] = rng.uniform(-1, 1, s)
    m = EncryptedMatVec(fparam, A, level=2)
    card = CkksContext.create_random_context(params, seed=21, device=cuda)
    twin = CkksContext.create_random_context(params, seed=21, device=CPU)
    eager, jit, cpu_task = m.load(card, mode='eager'), m.load(card, mode='jit'), m.load(twin)
    xv = rng.uniform(-1, 1, s)
    inputs = m.pack_inputs(card, xv)
    out, _ = eager.run(card, inputs)
    replay, _ = jit.run(card, inputs)
    want, _ = cpu_task.run(twin, {k: dataclasses.replace(v, data=v.data.cpu())
                                  for k, v in inputs.items()})
    assert torch.equal(out['y'].data.cpu(), want['y'].data)
    assert torch.equal(replay['y'].data, out['y'].data)
    assert np.abs(m.decode_output(card, out) - A @ xv).max() < 5e-3


def test_runner_toy_on_the_card(cuda, capsys):
    """``ckks_logistic_regression``'s ``main(['--toy'])`` runs on the card
    (``--toy`` keeps it) and meets its oracle."""
    from lattisense_torch.examples import ckks_logistic_regression as ex
    got = ex.main(['--toy'])
    assert abs(got['score'] - got['expected']) < 1e-2
    assert capsys.readouterr().out.rstrip().endswith('OK')
