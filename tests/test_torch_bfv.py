"""lattisense_torch BFV (keys, encode/encrypt/decrypt, evaluation ops, the
batched mult_relin main path) held bit for bit against lattisense_tpu.

Both packages sample through the same seeded CSPRNG, so the same seed gives
the same keys and ciphertexts; the batched main path takes the reference's
key set through ``BfvContext.from_arrays``.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.runtime import BfvContext as RefContext

from lattisense_torch.params import BfvParams
from lattisense_torch.parallel.batch import bfv_mult_relin, key_tree, make_batched_step
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes.types import Ciphertext


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    """One torch intra-op thread: the suite's parallel workers, each with a
    thread per core, would oversubscribe the host (``tests/test_torch_task.py``)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

N = 256
T_MOD = 65537


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def A(t):
    return t.cpu().numpy().astype(np.uint64)


def same(port, ref):
    return np.array_equal(A(port), np.asarray(ref).astype(np.uint64))


@pytest.fixture(scope='module')
def pair():
    chain = ref_primes(N, 31, 7)
    q, p = chain[:5], chain[5:]
    ref = RefContext.create_random_context(
        RefBfvParams.create_custom(N, T_MOD, q, p, word_bits=32), seed=21)
    port = BfvContext.create_random_context(BfvParams.create_custom(N, T_MOD, q, p, word_bits=32),
                                            seed=21, device='cpu')
    return ref, port


def msgs(k):
    rng = np.random.default_rng(k)
    return [rng.integers(0, T_MOD, N) for _ in range(2)]


def test_same_seed_same_keys_and_ciphertexts(pair):
    ref, port = pair
    assert np.array_equal(port.sk.coeffs, ref.sk.coeffs)
    assert same(port.pk.data, ref.pk.data)
    assert same(port.rlk.key_q, ref.rlk.key_q) and same(port.rlk.key_p, ref.rlk.key_p)
    assert (port.rlk.level, port.rlk.sp_level) == (ref.rlk.level, ref.rlk.sp_level)
    ma, mb = msgs(1)
    for m, level in ((ma, 4), (mb, 2)):
        pt_r, pt_p = ref.encode(m, level), port.encode(m, level)
        assert same(pt_p.data, pt_r.data)
        ct_r, ct_p = ref.encrypt(pt_r), port.encrypt(pt_p)
        assert same(ct_p.data, ct_r.data)
        assert np.array_equal(port.decrypt(ct_p), ref.decrypt(ct_r).astype(np.int64))
        assert np.array_equal(port.decrypt_decode(ct_p), m)


@pytest.mark.parametrize('op', ['add', 'sub', 'neg', 'mult', 'mult_relin', 'rescale',
                                'mult_pt', 'mult_ringt', 'mult_mul', 'add_pt', 'sub_ringt',
                                'symmetric'])
def test_eval_ops_match_reference(pair, op):
    ref, port = pair
    re, pe = ref.engine, port.engine
    level = 3
    ma, mb = msgs(2)
    ca = ref.encrypt(ref.encode(ma, level))
    cb = ref.encrypt(ref.encode(mb, level))
    pa = Ciphertext(data=T(ca.data), level=level)
    pb = Ciphertext(data=T(cb.data), level=level)
    if op in ('add', 'sub', 'mult'):
        want, got = getattr(re, op)(np, ca, cb), getattr(pe, op)(pa, pb)
    elif op == 'neg':
        want, got = re.neg(np, ca), pe.neg(pa)
    elif op == 'mult_relin':
        want = re.relinearize(np, re.mult(np, ca, cb), ref.rlk)
        got = port.mult_relin(pa, pb)
        assert np.array_equal(port.decrypt_decode(got), (ma * mb) % T_MOD)
    elif op == 'rescale':
        want, got = re.rescale(np, ca), pe.rescale(pa)
    elif op == 'mult_pt':
        want, got = re.mult(np, ca, re.encode(mb, level)), pe.mult(pa, pe.encode(mb, level))
    elif op == 'mult_ringt':
        want, got = re.mult(np, ca, re.encode_ringt(mb)), pe.mult(pa, pe.encode_ringt(mb))
    elif op == 'mult_mul':
        want = re.mult(np, ca, re.encode_mul(mb, level))
        got = pe.mult(pa, pe.encode_mul(mb, level))
    elif op == 'add_pt':
        want, got = re.add(np, ca, re.encode(mb, level)), pe.add(pa, pe.encode(mb, level))
    elif op == 'sub_ringt':
        want, got = re.sub(np, ca, re.encode_ringt(mb)), pe.sub(pa, pe.encode_ringt(mb))
    else:
        r = ref.engine.encrypt_symmetric(np.random.default_rng(9), ref.sk, ref.encode(ma, level))
        got = pe.encrypt_symmetric(np.random.default_rng(9), port.sk, pe.encode(ma, level))
        assert same(got.data, r.data)
        assert pe.noise_budget(port.sk, got) == re.noise_budget(ref.sk, r)
        return
    assert got.level == want.level
    assert same(got.data, want.data)


def _batched_case(params_ref, params_port, level, seed, batch=2):
    ref = RefContext.create_random_context(params_ref, seed=seed)
    port = BfvContext.from_arrays(params_port, ref.sk.coeffs, ref.pk.data, ref.rlk.key_q,
                                  ref.rlk.key_p, device='cpu')
    rng = np.random.default_rng(seed)
    ma = rng.integers(0, params_ref.t, (batch, params_ref.n))
    mb = rng.integers(0, params_ref.t, (batch, params_ref.n))
    cas = [ref.encrypt(ref.encode(m, level)) for m in ma]
    cbs = [ref.encrypt(ref.encode(m, level)) for m in mb]
    step = make_batched_step(port.engine, bfv_mult_relin, level)
    out = step(T(np.stack([c.data for c in cas])), T(np.stack([c.data for c in cbs])),
               key_tree(port))
    assert out.shape == (batch, 2, level + 1, params_ref.n)
    eng = ref.engine
    for i in range(batch):
        want = eng.relinearize(np, eng.mult(np, cas[i], cbs[i]), ref.rlk)
        assert same(out[i], want.data), i
        got = Ciphertext(data=out[i], level=level)
        assert np.array_equal(port.decrypt_decode(got), (ma[i] * mb[i]) % params_ref.t)


def test_batched_mult_relin_n4096_matches_reference():
    chain = ref_primes(4096, 31, 5)
    _batched_case(RefBfvParams.create_custom(4096, 65537, chain[:3], chain[3:], word_bits=32),
                  BfvParams.create_custom(4096, 65537, chain[:3], chain[3:], word_bits=32), 2, seed=3)


def test_batched_mult_relin_headline_matches_reference():
    """The main path's configuration: create_tpu_param(16384), level 7 (8 of
    the 10 q limbs, α = 4 special primes, T = 11 aux rows), batch of 2."""
    _batched_case(RefBfvParams.create_tpu_param(16384), BfvParams.create_tpu_param(16384),
                  7, seed=7)
