"""lattisense_torch BFV on the 64-bit word (the u64 conformance chain of
``parameter.json``): keys, encode/encrypt/decrypt, the evaluation ops and
the batched mult_relin main path, held bit for bit against lattisense_tpu.

Both packages sample through the same seeded CSPRNG, so the same seed gives
the same keys and ciphertexts; the batched main path takes the reference's
uint64 key arrays through ``BfvContext.from_arrays``.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.runtime import BfvContext as RefContext

from lattisense_torch.params import BfvParams
from lattisense_torch.parallel.batch import (bfv_mult_relin, key_tree, make_batched_step,
                                             make_rotate_step)
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes.galois import galois_elt_col, galois_elt_row
from lattisense_torch.schemes.types import Ciphertext


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    """One torch intra-op thread: the suite's parallel workers, each with a
    thread per core, would oversubscribe the host (``tests/test_torch_task.py``)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.uint64)).view(np.int64))


def A(t):
    return t.cpu().numpy().view(np.uint64)


def same(port, ref):
    return np.array_equal(A(port), np.asarray(ref).astype(np.uint64))


@pytest.fixture(scope='module', params=[4096, 8192])
def pair(request):
    n = request.param
    ref = RefContext.create_random_context(RefBfvParams.create(n), seed=31)
    port = BfvContext.create_random_context(BfvParams.create(n), seed=31, device='cpu')
    elts = [galois_elt_col(1, n), galois_elt_row(n)]
    ref.gen_galois_keys_for_elements(elts)
    port.gen_galois_keys_for_elements(elts)
    return ref, port


def msgs(k, n, t):
    rng = np.random.default_rng(k)
    return [rng.integers(0, t, n) for _ in range(2)]


def test_same_seed_same_keys_and_ciphertexts_word64(pair):
    ref, port = pair
    assert port.params.word_bits == 64 and port.engine.word_bits == 64
    assert np.array_equal(port.sk.coeffs, ref.sk.coeffs)
    assert same(port.pk.data, ref.pk.data)
    assert same(port.rlk.key_q, ref.rlk.key_q) and same(port.rlk.key_p, ref.rlk.key_p)
    for elt, key in ref.glk.keys.items():
        assert same(port.glk.keys[elt].key_q, key.key_q), elt
        assert same(port.glk.keys[elt].key_p, key.key_p), elt
    n, t = port.params.n, port.params.t
    ma, mb = msgs(1, n, t)
    for m, level in ((ma, port.params.max_level), (mb, 0)):
        pt_r, pt_p = ref.encode(m, level), port.encode(m, level)
        assert same(pt_p.data, pt_r.data)
        ct_r, ct_p = ref.encrypt(pt_r), port.encrypt(pt_p)
        assert same(ct_p.data, ct_r.data)
        assert np.array_equal(port.decrypt(ct_p), ref.decrypt(ct_r).astype(np.int64))
        assert np.array_equal(port.decrypt_decode(ct_p), m)


@pytest.mark.parametrize('op', ['add', 'sub', 'neg', 'mult', 'relinearize', 'mult_relin',
                                'rescale', 'rotate_cols', 'rotate_rows', 'mult_pt',
                                'mult_ringt', 'mult_mul', 'add_ringt'])
def test_eval_ops_word64_match_reference(pair, op):
    ref, port = pair
    re, pe = ref.engine, port.engine
    n, t = port.params.n, port.params.t
    level = port.params.max_level
    ma, mb = msgs(2, n, t)
    ca = ref.encrypt(ref.encode(ma, level))
    cb = ref.encrypt(ref.encode(mb, level))
    pa = Ciphertext(data=T(ca.data), level=level)
    pb = Ciphertext(data=T(cb.data), level=level)
    half = n // 2
    if op in ('add', 'sub', 'mult'):
        want, got = getattr(re, op)(np, ca, cb), getattr(pe, op)(pa, pb)
    elif op == 'neg':
        want, got = re.neg(np, ca), pe.neg(pa)
    elif op == 'relinearize':
        want = re.relinearize(np, re.mult(np, ca, cb), ref.rlk)
        got = pe.relinearize(Ciphertext(data=T(re.mult(np, ca, cb).data), level=level), port.rlk)
    elif op == 'mult_relin':
        want = re.relinearize(np, re.mult(np, ca, cb), ref.rlk)
        got = port.mult_relin(pa, pb)
        assert np.array_equal(port.decrypt_decode(got), (ma * mb) % t)
    elif op == 'rescale':
        want, got = re.rescale(np, ca), pe.rescale(pa)
    elif op == 'rotate_cols':
        elt = galois_elt_col(1, n)
        want = re.rotate_cols(np, ca, 1, ref.glk.keys[elt])
        got = port.rotate_cols(pa, 1)
        assert np.array_equal(port.decrypt_decode(got),
                              np.concatenate([np.roll(ma[:half], -1), np.roll(ma[half:], -1)]))
    elif op == 'rotate_rows':
        want = re.rotate_rows(np, ca, ref.glk.keys[galois_elt_row(n)])
        got = port.rotate_rows(pa)
        assert np.array_equal(port.decrypt_decode(got), np.concatenate([ma[half:], ma[:half]]))
    elif op == 'mult_pt':
        want, got = re.mult(np, ca, re.encode(mb, level)), pe.mult(pa, pe.encode(mb, level))
    elif op == 'mult_ringt':
        want, got = re.mult(np, ca, re.encode_ringt(mb)), pe.mult(pa, pe.encode_ringt(mb))
    elif op == 'mult_mul':
        want = re.mult(np, ca, re.encode_mul(mb, level))
        got = pe.mult(pa, pe.encode_mul(mb, level))
    else:
        want, got = re.add(np, ca, re.encode_ringt(mb)), pe.add(pa, pe.encode_ringt(mb))
    assert got.level == want.level
    assert same(got.data, want.data)


def test_batched_u64_main_path_matches_reference():
    """The u64 main path: BfvParams.create(16384) at level 3 (4 of the 6 q
    limbs, α = 2 special primes, 6 aux limbs), batch 2, through
    ``make_batched_step`` with the reference's keys (uint64 arrays) handed
    over by ``from_arrays``; then the batched rotate_col with the
    reference's Galois key."""
    level, batch = 3, 2
    params_ref = RefBfvParams.create(16384)
    ref = RefContext.create_random_context(params_ref, seed=7)
    elt = galois_elt_col(1, params_ref.n)
    ref.gen_galois_keys_for_elements([elt])
    port = BfvContext.from_arrays(BfvParams.create(16384), ref.sk.coeffs, ref.pk.data,
                                  ref.rlk.key_q, ref.rlk.key_p, device='cpu')
    port.add_galois_key_arrays(elt, ref.glk.keys[elt].key_q, ref.glk.keys[elt].key_p)
    rng = np.random.default_rng(7)
    ma = rng.integers(0, params_ref.t, (batch, params_ref.n))
    mb = rng.integers(0, params_ref.t, (batch, params_ref.n))
    cas = [ref.encrypt(ref.encode(m, level)) for m in ma]
    cbs = [ref.encrypt(ref.encode(m, level)) for m in mb]
    a, b = T(np.stack([c.data for c in cas])), T(np.stack([c.data for c in cbs]))
    keys = key_tree(port, galois_elts=[elt])
    out = make_batched_step(port.engine, bfv_mult_relin, level)(a, b, keys)
    rot = make_batched_step(port.engine, make_rotate_step(elt), level, n_inputs=1)(a, keys)
    assert out.shape == rot.shape == (batch, 2, level + 1, params_ref.n)
    eng = ref.engine
    for i in range(batch):
        assert same(out[i], eng.relinearize(np, eng.mult(np, cas[i], cbs[i]), ref.rlk).data), i
        assert same(rot[i], eng.apply_galois(np, cas[i], elt, ref.glk.keys[elt]).data), i
        assert np.array_equal(port.decrypt_decode(Ciphertext(data=out[i], level=level)),
                              (ma[i] * mb[i]) % params_ref.t)
