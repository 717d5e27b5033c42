"""Kernels B5 (u64 NTT), B6 (u64 FastBConv) and B7 (u64 gadget inner
product) of lattisense_torch, and the B1-r4 / perm-layout entries.

On the CPU the wrappers run their plain PyTorch twins; those are held bit
for bit against the Pallas kernels they replace, each called by its own
name and run in interpret mode as the JAX package's own tests run them
(``tests/test_ntt_pallas.py``, ``test_bconv_pallas.py``,
``test_ksw_pallas.py``, ``test_word32.py``). The CUDA kernels are held
against the same twins on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lattisense_tpu.core import ntt as ref_ntt
from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.core.modring import get_rns_ring as ref_ring
from lattisense_tpu.core import u64 as ref_u
from lattisense_tpu.core.rns import BasisConv as RefBasisConv
from lattisense_tpu.ops import bconv_pallas, ksw_pallas, ntt_pallas, ntt_pallas32, ntt_pallas64f
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.runtime import BfvContext as RefContext
from lattisense_tpu.schemes.keyswitch import KeySwitcher as RefKeySwitcher

from lattisense_torch.core.modring import get_rns_ring
from lattisense_torch.core.rns import BasisConv
from lattisense_torch.ops import bconv_cuda, ksw64_cuda, ntt64_cuda, ntt_cuda
from lattisense_torch.schemes.keyswitch import KeySwitcher
from lattisense_torch.schemes.types import KeySwitchKey


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    """One torch intra-op thread: the suite's parallel workers, each with a
    thread per core, would oversubscribe the host (``tests/test_torch_task.py``)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

CPU = torch.device('cpu')


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.uint64)).view(np.int64))


def A(t):
    return t.cpu().numpy().view(np.uint64)


def residues(rng, moduli, n, lead=()):
    return np.stack([rng.integers(0, q, (*lead, n), dtype=np.uint64) for q in moduli], axis=-2)


@pytest.fixture(scope='module')
def ntt64_case():
    """n=4096, four primes of 61, 59, 57 and 55 bits, two polynomials."""
    n = 4096
    chain = tuple(ref_primes(n, 61, 1) + ref_primes(n, 59, 1) + ref_primes(n, 57, 1)
                  + ref_primes(n, 55, 1))
    x = residues(np.random.default_rng(4096), chain, n, (2,))
    ref = ref_ring(chain, n, 64)
    return x, ref, get_rns_ring(chain, n, CPU, 64), ref_ntt.ntt(np, x, ref)


# ---------------------------------------------------------------------------
# B5: one twin, five reference names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['ntt_fused64', 'ntt_fused'])
def test_b5_forward_matches_pallas_by_name(ntt64_case, name):
    x, ref, ring, want = ntt64_case
    pallas = {'ntt_fused64': ntt_pallas64f.ntt_fused64, 'ntt_fused': ntt_pallas.ntt_fused}[name]
    got_ref = np.asarray(pallas(jnp.asarray(x), ref))
    assert np.array_equal(got_ref, want)
    assert np.array_equal(A(getattr(ntt64_cuda, name)(T(x), ring)), got_ref)
    assert np.array_equal(A(ntt64_cuda.ntt64_fwd(T(x), ring)), got_ref)


@pytest.mark.parametrize('name', ['intt_fused64', 'intt_fused', '_intt_fused_impl'])
def test_b5_inverse_matches_pallas_by_name(ntt64_case, name):
    x, ref, ring, f = ntt64_case
    pallas = {'intt_fused64': ntt_pallas64f.intt_fused64, 'intt_fused': ntt_pallas.intt_fused,
              '_intt_fused_impl': ntt_pallas._intt_fused_impl}[name]
    got_ref = np.asarray(pallas(jnp.asarray(f), ref))
    assert np.array_equal(got_ref, x)
    port = getattr(ntt64_cuda, name.lstrip('_'))
    assert np.array_equal(A(port(T(f), ring)), got_ref)


def test_b5_round_trip_and_epilogues(ntt64_case):
    x, ref, ring, f = ntt64_case
    fm = ntt64_cuda.ntt64_fwd(T(x), ring, to_mont=True)
    assert np.array_equal(A(fm), np.asarray(ring.word.to_mont(T(f), ring.q, ring.pinv,
                                                              ring.r2)).view(np.uint64))
    assert np.array_equal(A(ntt64_cuda.ntt64_inv(fm, ring, from_mont=True)), x)
    assert np.array_equal(A(ntt64_cuda.ntt64_inv(ntt64_cuda.ntt64_fwd(T(x), ring), ring)), x)


# ---------------------------------------------------------------------------
# B6: the convert and raw forms
# ---------------------------------------------------------------------------

def test_b6_convert_matches_pallas():
    """The BEHZ extension's conversion: L=4 q primes → 5 aux primes + m_sk."""
    n = 2048
    src = tuple(ref_primes(n, 57, 2) + ref_primes(n, 54, 2))
    dst = tuple(ref_primes(n, 59, 6, exclude=src))
    ref, port = RefBasisConv(src, dst), BasisConv(src, dst, CPU, 64)
    y = ref.decompose(np, residues(np.random.default_rng(6), src, n, (2,)))
    want = np.asarray(bconv_pallas.bconv_convert_fused(jnp.asarray(y), ref))
    assert np.array_equal(want, ref.convert(np, y))
    assert np.array_equal(A(bconv_cuda.bconv64_convert(T(y), port)), want)


@pytest.mark.parametrize('level', [3, 2], ids=['beta2', 'beta2-ragged'])
def test_b6_raw_matches_pallas_modup(level):
    """The key switch's grouped mod-up: the reference converts digit by digit
    with ``bconv_raw_fused``; the port converts all β digits in one call."""
    n = 2048
    chain = ref_primes(n, 57, 4) + ref_primes(n, 55, 2)
    q, p = tuple(chain[:4]), tuple(chain[4:])
    ref_sw, port = RefKeySwitcher(q, p, n), KeySwitcher(q, p, n, CPU, 64)
    ring_qp, qhat_inv, qhat_inv_shoup, src_q, _, _ = ref_sw._level_pre(level)
    L, alpha, beta = level + 1, 2, ref_sw.beta(level)
    x = residues(np.random.default_rng(level), q[:L], n, (2,))
    x = np.concatenate([x, np.zeros((2, beta * alpha - L, n), dtype=np.uint64)], axis=-2)
    y = ref_u.shoup_mul(np, x.reshape(2, beta, alpha, n), qhat_inv, qhat_inv_shoup, src_q)
    consts = ref_sw._modup_consts(level)
    want = np.stack([np.asarray(bconv_pallas.bconv_raw_fused(jnp.asarray(y[:, d]), ch, cl, qd,
                                                             L + alpha, alpha))
                     for d, (ch, cl, qd) in enumerate(consts)], axis=1)
    _, _, _, _, qhat_conv, _ = port._level_pre(level)
    pr = port.ring_qp(level)
    got = bconv_cuda.bconv64_raw(T(y), qhat_conv, pr.q, pr.pinv)
    assert got.shape == (2, beta, L + alpha, n)
    assert np.array_equal(A(got), want)


# ---------------------------------------------------------------------------
# B7: the gadget inner product
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def ref16384():
    return RefContext.create_random_context(RefBfvParams.create(16384), seed=13)


def _b7_case(ctx, level, lead):
    eng, rlk = ctx.engine, ctx.rlk
    sw = eng.switcher
    L = level + 1
    x = residues(np.random.default_rng(level), eng.q[:L], eng.n, lead)
    digits = sw.decompose_modup_ntt(np, x, level)
    beta = sw.beta(level)
    ring_qp = sw._level_pre(level)[0]
    kd = np.concatenate([rlk.key_q[:beta, :, :L], rlk.key_p[:beta]], axis=2)
    w0, w1 = ksw_pallas.ksw_inner_fused(jnp.asarray(digits), jnp.asarray(kd), ring_qp.q,
                                        ring_qp.pinv)
    want = np.stack([np.asarray(w0), np.asarray(w1)], axis=-3)
    ref_acc = sw.inner_product(np, digits, rlk, level)
    assert np.array_equal(want, np.stack(ref_acc, axis=-3))
    port_ring = get_rns_ring(ring_qp.moduli, eng.n, CPU, 64)
    ksk = KeySwitchKey(key_q=T(rlk.key_q), key_p=T(rlk.key_p))
    got = ksw64_cuda.ksw_inner64(T(digits), ksk, level, port_ring)
    assert np.array_equal(A(got), want)


def test_b7_matches_pallas_alpha1():
    """BfvParams.create(4096): one special prime, β = L."""
    ctx = RefContext.create_random_context(RefBfvParams.create(4096), seed=12)
    _b7_case(ctx, ctx.params.max_level, (2,))


@pytest.mark.parametrize('level', [3, 2], ids=['alpha2', 'alpha2-ragged'])
def test_b7_matches_pallas_n16384(ref16384, level):
    _b7_case(ref16384, level, (1,))


# ---------------------------------------------------------------------------
# B1-r4 and the perm-layout entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['ntt_fused32_r4', 'intt_fused32_r4', 'ntt_fused32_perm',
                                  'intt_fused32_perm'])
def test_b1_r4_and_perm_match_pallas_by_name(name):
    n = 1024
    chain = tuple(ref_primes(n, 31, 3))
    ref, ring = ref_ring(chain, n, 32), get_rns_ring(chain, n, CPU)
    x = residues(np.random.default_rng(15), chain, n, (2,)).astype(np.uint32)
    f = ref_ntt.ntt(np, x, ref)
    arg = {'ntt_fused32_r4': x, 'intt_fused32_r4': f, 'ntt_fused32_perm': x,
           'intt_fused32_perm': ntt_pallas32.perm_layout(f, n)}[name]
    want = np.asarray(getattr(ntt_pallas32, name)(jnp.asarray(arg), ref))
    port = {'ntt_fused32_r4': ntt_cuda.ntt32_fwd_r4, 'intt_fused32_r4': ntt_cuda.ntt32_inv_r4,
            'ntt_fused32_perm': ntt_cuda.ntt32_fwd_perm,
            'intt_fused32_perm': ntt_cuda.ntt32_inv_perm}[name]
    got = port(torch.from_numpy(arg.astype(np.int64)), ring)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert np.array_equal(A(ntt_cuda.perm_layout(T(f))), ntt_pallas32.perm_layout(f, n))
    assert np.array_equal(A(ntt_cuda.unperm_layout(ntt_cuda.perm_layout(T(f)))), f)
