"""The reference accepts the port's outputs at a toy size and rejects one
with a coefficient changed. The test imports the port to make the outputs;
the reference itself imports nothing of it."""

import numpy as np
import pytest
import torch

from portbench import fhe
from portbench.reference import bfv as rb
from portbench.reference import ckks as rc
from portbench.reference import control, rns
from portbench.tests.conftest import toy

N = 1024


def nudged(data, limb=0, pos=0, poly=0):
    out = data.clone()
    out[..., poly, limb, pos] += 1
    return out


@pytest.fixture(scope='module')
def bfv():
    from lattisense_torch.parallel.batch import bfv_mult_relin, key_tree, make_rotate_step
    from lattisense_torch.schemes.galois import galois_elt_col
    _, cell, cfg = toy('bfv_w32_mult_relin_b32', N)
    s = fhe.secret(11, cfg)
    ctx = fhe.bfv_context(cfg, 11, 'cpu', s)
    fhe.add_relin_key(ctx)
    elt = galois_elt_col(1, N)
    ctx.gen_galois_keys_for_elements([elt])
    g = fhe.rng(11, 2)
    ma, mb = g.integers(0, cfg['t'], (2, N))
    a = ctx.encrypt(ctx.encode_coeffs(ma, 7))
    b = ctx.encrypt(ctx.encode_coeffs(mb, 7))
    prod = bfv_mult_relin(ctx.engine, a, b, key_tree(ctx))
    rot = make_rotate_step(elt)(ctx.engine, a, key_tree(ctx, [elt]))
    return dict(cfg=cfg, s=s, ma=ma, mb=mb, a=a, prod=prod, rot=rot, ctx=ctx)


def test_bfv_decrypts_the_ports_ciphertexts(bfv):
    q, t = bfv['cfg']['q'][:8], bfv['cfg']['t']
    assert np.array_equal(rb.decrypt(bfv['a'].data, bfv['s'], q, t), bfv['ma'])
    assert np.array_equal(rb.decrypt(bfv['a'].data, bfv['s'], q, t),
                          bfv['ctx'].decrypt_coeffs(bfv['a']))


@pytest.mark.parametrize('which', ['prod', 'rot'])
def test_bfv_accepts_the_result_and_rejects_a_changed_coefficient(bfv, which):
    q, t = bfv['cfg']['q'][:8], bfv['cfg']['t']
    want = (rb.negacyclic_mul(bfv['ma'], bfv['mb'], t) if which == 'prod'
            else rb.automorphism(bfv['ma'], 5, t))
    out = bfv[which].data
    assert np.array_equal(rb.decrypt(out, bfv['s'], q, t), want)
    for limb in (0, 7):
        assert (rb.decrypt(nudged(out, limb, 5, 1), bfv['s'], q, t) != want).sum() > 0


def test_bfv_plaintext_products_against_a_schoolbook():
    t, n = 65537, 16
    g = np.random.default_rng(1)
    a, b = g.integers(0, t, (2, n))
    want = np.zeros(n, dtype=object)
    for i in range(n):
        for j in range(n):
            k, sgn = (i + j) % n, (1 if i + j < n else -1)
            want[k] += sgn * int(a[i]) * int(b[j])
    assert np.array_equal(rb.negacyclic_mul(a, b, t), (want % t).astype(np.int64))
    m = g.integers(0, t, n)
    rot = rb.automorphism(m, 5, t)
    for i in range(n):
        e = i * 5 % (2 * n)
        assert rot[e % n] == (m[i] if e < n else (t - m[i]) % t)


@pytest.mark.parametrize('q', [65537, 2147352577, 0x10000000006E0001, 0x1FFFFFFFFFE00001])
def test_ntt_round_trip_and_evaluation_order(q):
    n = 32
    g = np.random.default_rng(q % 1000)
    x = g.integers(0, min(q, 1 << 62), n)
    limb = rns.as_limb(x, q)
    back = rns.intt(rns.ntt(limb, q), q)
    assert [int(v) for v in back] == [int(v) for v in x]
    psi, br = rns.root_2n(q, n), rns.bitrev(n)
    hat = rns.ntt(limb, q)
    for i in (0, 1, 5, n - 1):
        pt = pow(psi, 2 * int(br[i]) + 1, q)
        assert int(hat[i]) == sum(int(c) * pow(pt, j, q) for j, c in enumerate(x)) % q


@pytest.mark.parametrize('q', [2147352577, 0x7FFFE60001, 0x10000000006E0001,
                               0x1FFFFFFFFFE00001, (1 << 61) - 1])
def test_mulmod_against_python_integers(q):
    g = np.random.default_rng(q % 997)
    a, w = g.integers(0, q, (2, 4096))
    a[:4], w[:4] = [0, q - 1, q - 1, (1 << 31) - 1], [q - 1, q - 1, 1, 1 << 31]
    got = rns.mulmod(torch.tensor(a), torch.tensor(w), q).tolist()
    assert got == [int(x) * int(y) % q for x, y in zip(a, w)]


def test_centered_float_is_the_crt_and_falls_back_where_limbs_disagree():
    moduli = [0x10000000006E0001, 0x10000140001, 0x7FFFE60001]
    g = np.random.default_rng(4)
    small = g.integers(-(1 << 50), 1 << 50, (3, 64))
    limbs = [torch.tensor(small % q) for q in moduli]
    assert np.array_equal(rns.centered_float(limbs, moduli), small.astype(np.float64))
    limbs[2][1, 7] = (limbs[2][1, 7] + 1) % moduli[2]
    x, Q = rns.crt(limbs, moduli)
    want = rns.centered(x, Q)
    got = rns.centered_float(limbs, moduli)
    assert np.array_equal(got[[0, 2]], small[[0, 2]].astype(np.float64))
    assert np.array_equal(got[1], want[1].astype(np.float64)) and abs(got[1, 7]) > 2.0 ** 80


@pytest.fixture(scope='module')
def ckks():
    from lattisense_torch.parallel.batch import ckks_mult_relin_rescale, key_tree
    _, cell, cfg = toy('ckks_btp_mult_rescale_b32', N)
    s = fhe.secret(12, cfg)
    ctx = fhe.ckks_context(cfg, 12, 'cpu', s)
    fhe.add_relin_key(ctx)
    g = fhe.rng(12, 2)
    za, zb = (g.uniform(-1, 1, (2, N // 2)) + 1j * g.uniform(-1, 1, (2, N // 2)))
    a, b = (ctx.encrypt(ctx.encode(z, 9)) for z in (za, zb))
    out = ckks_mult_relin_rescale(ctx.engine, a, b, key_tree(ctx))
    return dict(cfg=cfg, s=s, za=za, zb=zb, a=a, b=b, out=out, ctx=ctx)


def test_ckks_decodes_the_ports_ciphertexts(ckks):
    cfg = ckks['cfg']
    got = rc.decrypt_decode(ckks['a'].data, ckks['s'], cfg['q'][:10], cfg['scale'], N // 2)
    assert np.abs(got - ckks['za']).max() < 1e-6
    assert np.abs(got - ckks['ctx'].decrypt_decode(ckks['a'])).max() < 1e-9


def test_ckks_decodes_a_batch_as_each_ciphertext(ckks):
    cfg = ckks['cfg']
    one = [rc.decrypt_decode(ct.data, ckks['s'], cfg['q'][:10], cfg['scale'], N // 2)
           for ct in (ckks['a'], ckks['b'])]
    both = rc.decrypt_decode(torch.stack([ckks['a'].data, ckks['b'].data]), ckks['s'],
                             cfg['q'][:10], cfg['scale'], N // 2)
    assert both.shape == (2, N // 2) and np.array_equal(both, np.stack(one))


def test_ckks_accepts_the_product_and_rejects_a_changed_coefficient(ckks):
    cfg, out = ckks['cfg'], ckks['out']
    scale = float(cfg['scale']) ** 2 / cfg['q'][9]
    assert out.scale == pytest.approx(scale, rel=1e-12)
    want = ckks['za'] * ckks['zb']
    good = rc.decrypt_decode(out.data, ckks['s'], cfg['q'][:9], scale, N // 2)
    assert np.abs(good - want).max() < 1e-6
    for limb in (0, 8):
        bad = rc.decrypt_decode(nudged(out.data, limb, 3, 0), ckks['s'], cfg['q'][:9], scale,
                                N // 2)
        assert np.abs(bad - want).max() > 1e-2


def test_controls_fail_the_limits():
    t = 65537
    x = np.arange(t)
    assert (control.int16(x, t) != x).sum() == t - 32768
    g = np.random.default_rng(3)
    a, b = g.uniform(-1, 1, (2, 4096)) + 1j * g.uniform(-1, 1, (2, 4096))
    assert 3e-4 < np.abs(control.float16_product(a, b) - a * b).max() < 1e-2
