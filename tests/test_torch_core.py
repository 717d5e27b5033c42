"""lattisense_torch core (word arithmetic, ring tables, NTT twin, RNS toolbox,
key switching) held bit for bit against lattisense_tpu's NumPy path.

Inputs are made with a seeded NumPy generator and handed to both packages;
every value is an integer residue, so the tolerance is zero.
"""

import math

import numpy as np
import pytest
import torch

from lattisense_tpu.core import ntt as ref_ntt
from lattisense_tpu.core import rns as ref_rns
from lattisense_tpu.core import u64 as ref_u
from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.core.modring import get_rns_ring as ref_ring
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.params import bfv_aux_basis as ref_aux_basis
from lattisense_tpu.runtime import BfvContext as RefContext
from lattisense_tpu.schemes.keyswitch import KeySwitcher as RefKeySwitcher
from lattisense_tpu.schemes.keyswitch import RoundDivP as RefRoundDivP

from lattisense_torch.core import ntt as tntt
from lattisense_torch.core import rns as trns
from lattisense_torch.core import u64 as tu
from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_torch.params import BfvParams, bfv_aux_basis
from lattisense_torch.schemes.keyswitch import KeySwitcher, RoundDivP
from lattisense_torch.schemes.types import KeySwitchKey

CPU = torch.device('cpu')


def T(a):
    """NumPy array (any unsigned/signed integer dtype) → int64 CPU tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def A(t):
    return t.numpy().astype(np.uint64)


def residues(rng, moduli, n, lead=()):
    """Random residues (*lead, L, n) as uint32, one row per modulus."""
    out = np.stack([rng.integers(0, q, (*lead, n), dtype=np.uint64) for q in moduli], axis=-2)
    return out.astype(np.uint32)


# ---------------------------------------------------------------------------
# core/u64
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def word_case():
    rng = np.random.default_rng(0)
    chain = tuple(ref_primes(64, 31, 4))
    ring = ref_ring(chain, 64, 32)
    a = residues(rng, chain, 64, (3,))
    b = residues(rng, chain, 64, (3,))
    return chain, ring, a, b


def test_mulhi_full_word_matches_reference():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 32, 8192, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 8192, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(A(tu.mulhi(T(a), T(b))), ref_u.mulhi(np, a, b).astype(np.uint64))


@pytest.mark.parametrize('op', ['addmod', 'submod', 'negmod', 'mont_mul', 'mulmod',
                                'to_mont', 'from_mont', 'redc', 'shoup_mul', 'modsum'])
def test_word_ops_match_reference(word_case, op):
    chain, ring, a, b = word_case
    q, pinv, r2 = ring.q, ring.pinv, ring.r2
    tq, tpinv, tr2 = T(q), T(pinv), T(r2)
    if op in ('addmod', 'submod'):
        want = getattr(ref_u, op)(np, a, b, q)
        got = getattr(tu, op)(T(a), T(b), tq)
    elif op == 'negmod':
        a = a.copy()
        a[..., :4] = 0                          # the a == 0 branch
        want, got = ref_u.negmod(np, a, q), tu.negmod(T(a), tq)
    elif op == 'mont_mul':
        want, got = ref_u.mont_mul(np, a, b, q, pinv), tu.mont_mul(T(a), T(b), tq, tpinv)
    elif op == 'mulmod':
        want = ref_u.mulmod(np, a, b, q, pinv, r2)
        got = tu.mulmod(T(a), T(b), tq, tpinv, tr2)
    elif op == 'to_mont':
        want, got = ref_u.to_mont(np, a, q, pinv, r2), tu.to_mont(T(a), tq, tpinv, tr2)
    elif op == 'from_mont':
        want, got = ref_u.from_mont(np, a, q, pinv), tu.from_mont(T(a), tq, tpinv)
    elif op == 'redc':
        hi = (a.astype(np.uint64) * b.astype(np.uint64) >> np.uint64(32)).astype(np.uint32)
        lo = (a.astype(np.uint64) * b.astype(np.uint64)).astype(np.uint32)
        want, got = ref_u.redc(np, hi, lo, q, pinv), tu.redc(T(hi), T(lo), tq, tpinv)
    elif op == 'shoup_mul':
        w = np.asarray(ring.psi_rev[:, 1:2])
        ws = np.asarray(ring.psi_rev_shoup[:, 1:2])
        want = ref_u.shoup_mul(np, a, w, ws, q)
        got = tu.shoup_mul(T(a), T(w), T(ws), tq)
    else:
        want = ref_u.modsum_tree(np, a, q[None], axis=0)
        got = tu.modsum(T(a), tq, dim=0)
    assert np.array_equal(A(got), want.astype(np.uint64))


# ---------------------------------------------------------------------------
# params / core/modring
# ---------------------------------------------------------------------------

def test_primes_params_and_aux_basis_match_reference():
    assert gen_ntt_primes(1024, 31, 9) == ref_primes(1024, 31, 9)
    assert gen_ntt_primes(256, 31, 4, exclude=ref_primes(256, 31, 2)) == \
        ref_primes(256, 31, 4, exclude=ref_primes(256, 31, 2))
    p, r = BfvParams.create_tpu_param(16384), RefBfvParams.create_tpu_param(16384)
    assert (p.n, p.t, p.q, p.p) == (r.n, r.t, r.q, r.p)
    assert (len(p.q), len(p.p), p.t) == (10, 4, 65537)
    assert bfv_aux_basis(p.n, tuple(p.q), tuple(p.p), 32) == \
        ref_aux_basis(r.n, tuple(r.q), tuple(r.p), 32)
    p64, r64 = BfvParams.create(16384), RefBfvParams.create(16384)
    assert (p64.n, p64.t, p64.q, p64.p, p64.word_bits) == (r64.n, r64.t, r64.q, r64.p, 64)
    assert bfv_aux_basis(p64.n, tuple(p64.q), tuple(p64.p), 64) == \
        ref_aux_basis(r64.n, tuple(r64.q), tuple(r64.p), 64)
    with pytest.raises(ValueError, match='2\\^31'):
        BfvParams.create_custom(256, 257, p64.q[:2], p64.p[:1], word_bits=32)


@pytest.mark.parametrize('n', [256, 4096])
def test_ring_tables_match_reference(n):
    chain = tuple(ref_primes(n, 31, 3))
    ring, ref = get_rns_ring(chain, n, CPU), ref_ring(chain, n, 32)
    for attr in ('q', 'pinv', 'r1', 'r2', 'n_inv', 'n_inv_shoup', 'psi_rev',
                 'psi_rev_shoup', 'psi_inv_rev', 'psi_inv_rev_shoup'):
        assert np.array_equal(A(getattr(ring, attr)),
                              np.asarray(getattr(ref, attr)).astype(np.uint64)), attr


# ---------------------------------------------------------------------------
# core/ntt (plain twin)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n,lead', [(256, (3,)), (1024, (2, 2)), (4096, ())])
def test_ntt_plain_matches_reference(n, lead):
    chain = tuple(ref_primes(n, 31, 3))
    ring, ref = get_rns_ring(chain, n, CPU), ref_ring(chain, n, 32)
    x = residues(np.random.default_rng(n), chain, n, lead)
    want = ref_ntt.ntt(np, x, ref)
    got = tntt.ntt(T(x), ring)
    assert np.array_equal(A(got), want.astype(np.uint64))
    assert np.array_equal(A(tntt.intt(got, ring)), ref_ntt.intt(np, want, ref).astype(np.uint64))
    assert np.array_equal(A(tntt.intt(got, ring)), x.astype(np.uint64))


# ---------------------------------------------------------------------------
# core/rns
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def rns_case():
    n = 128
    primes = ref_primes(n, 31, 9)
    src, dst = tuple(primes[:4]), tuple(primes[4:8])
    return n, src, dst, primes[8]


def test_basis_conv_matches_reference(rns_case):
    n, src, dst, _ = rns_case
    x = residues(np.random.default_rng(3), src, n, (2,))
    ref, port = ref_rns.BasisConv(src, dst, 32), trns.BasisConv(src, dst, CPU)
    y = ref.decompose(np, x)
    assert np.array_equal(A(port.decompose(T(x))), y.astype(np.uint64))
    assert np.array_equal(A(port.convert(T(y))), ref.convert(np, y).astype(np.uint64))
    assert np.array_equal(A(port.convert_mtilde(T(y))), ref.convert_mtilde(np, y).astype(np.uint64))
    assert np.array_equal(A(port(T(x))), ref(np, x).astype(np.uint64))


def test_exact_extend_and_smmrq_match_reference(rns_case):
    n, src, dst, m_sk = rns_case
    full = dst + (m_sk,)
    rng = np.random.default_rng(4)
    x = residues(rng, src, n, (3,))
    ref, port = ref_rns.ExactExtend(src, full, 32), trns.ExactExtend(src, full, CPU)
    assert np.array_equal(A(port(T(x))), ref(np, x).astype(np.uint64))
    ext = residues(rng, full, n, (3,))
    emt = rng.integers(0, 1 << 16, (3, n), dtype=np.uint64).astype(np.uint32)
    rs, ps = ref_rns.SmMRq(src, full, 32), trns.SmMRq(src, full, CPU)
    assert np.array_equal(A(ps(T(ext), T(emt))), rs(np, ext, emt).astype(np.uint64))


def test_shenoy_and_div_round_last_match_reference(rns_case):
    n, src, dst, m_sk = rns_case
    rng = np.random.default_rng(5)
    xb = residues(rng, dst, n, (2,))
    xsk = rng.integers(0, m_sk, (2, n), dtype=np.uint64).astype(np.uint32)
    ref, port = ref_rns.ShenoyConvert(dst, m_sk, src, 32), trns.ShenoyConvert(dst, m_sk, src, CPU)
    assert np.array_equal(A(port(T(xb), T(xsk))), ref(np, xb, xsk).astype(np.uint64))
    x = residues(rng, src, n, (2, 3))
    rd, pd = ref_rns.DivRoundLast(src, 32), trns.DivRoundLast(src, CPU, 32)
    assert np.array_equal(A(pd(T(x))), rd(np, x).astype(np.uint64))


# ---------------------------------------------------------------------------
# schemes/keyswitch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('alpha', [2, 4])
def test_round_div_p_matches_reference(alpha):
    n = 256
    primes = ref_primes(n, 31, 6 + alpha)
    q, p = tuple(primes[:6]), tuple(primes[6:])
    rng = np.random.default_rng(6)
    xq, xp = residues(rng, q, n, (2,)), residues(rng, p, n, (2,))
    ref, port = RefRoundDivP(q, p, 32), RoundDivP(q, p, CPU)
    y = ref.conv.decompose(np, xp)
    got_v = A(port.overflow(T(y)))
    assert np.array_equal(got_v, ref.overflow(np, y).astype(np.uint64))
    if alpha == 4:      # the fixed-point sum passes 2^63 and wraps in int64
        acc = sum(y[..., j, :].astype(object) * ((1 << 62) // p[j]) for j in range(alpha))
        assert max(int(v) for v in acc.ravel()) >= 1 << 63
    assert np.array_equal(A(port(T(xq), T(xp))), ref(np, xq, xp).astype(np.uint64))


def _switch_case(n, nq, npr, seed):
    chain = ref_primes(n, 31, nq + npr)
    params = RefBfvParams.create_custom(n, 257, chain[:nq], chain[nq:], word_bits=32)
    ctx = RefContext.create_random_context(params, seed=seed)
    port = KeySwitcher(params.q, params.p, n, CPU)
    ksk = KeySwitchKey(key_q=T(ctx.rlk.key_q), key_p=T(ctx.rlk.key_p))
    return params, ctx.engine.switcher, port, ctx.rlk, ksk


@pytest.mark.parametrize('nq,npr,levels', [(5, 2, (4, 3, 2)), (8, 4, (7, 5))],
                         ids=['alpha2-ragged', 'alpha4'])
def test_keyswitch_matches_reference(nq, npr, levels):
    n = 256
    params, ref_sw, port, rlk, ksk = _switch_case(n, nq, npr, seed=15)
    assert isinstance(ref_sw, RefKeySwitcher)
    rng = np.random.default_rng(8)
    for level in levels:
        x = residues(rng, params.q[:level + 1], n, (2,))
        for output_ntt in (False, True):
            want = ref_sw.switch(np, x, rlk, level, output_ntt=output_ntt)
            got = port.switch(T(x), ksk, level, output_ntt=output_ntt)
            assert np.array_equal(A(got[0]), want[0].astype(np.uint64)), (level, output_ntt)
            assert np.array_equal(A(got[1]), want[1].astype(np.uint64)), (level, output_ntt)
    assert math.ceil((levels[0] + 1) / npr) == port.beta(levels[0])
