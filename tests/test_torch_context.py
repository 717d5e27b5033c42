"""lattisense_torch's contexts held against lattisense_tpu's.

``FheContext`` (the shared base), ``BfvContext`` rebased on it and
``CkksContext``, on the CPU: contexts of one seed hold the same keys; the
context methods new to the port (empty and public contexts, ``add`` /
``sub`` / ``neg`` / ``rescale``, symmetric encryption, the coefficient
encodes, ``decrypt_coeffs``, ``noise_budget``, ``get_coeff``, the CKKS
conjugation, level drop and scalar product) give the reference's results
bit for bit; the message checks give its strings; bootstrapping without a
bootstrapper raises its error, and the polynomial activations equal its.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.params import CkksParams as RefCkksParams
from lattisense_tpu.runtime import create_context_for_params as ref_create

from lattisense_torch.params import BfvParams, CkksParams
from lattisense_torch.runtime import (BfvContext, CkksContext, FheContext,
                                      create_context_for_params)
from lattisense_torch.schemes.galois import galois_elt_col, galois_elt_row
from lattisense_torch.schemes.types import Ciphertext

N = 64
T_MOD = 257


def A(t):
    return t.cpu().numpy().view(np.uint64)


def same(port, ref) -> bool:
    return (np.array_equal(A(port.data), np.asarray(ref.data).astype(np.uint64))
            and port.level == ref.level and port.scale == ref.scale)


def port_ct(ct):
    return Ciphertext(data=torch.from_numpy(np.asarray(ct.data).astype(np.int64)),
                      level=ct.level, is_ntt=ct.is_ntt, is_mform=ct.is_mform, scale=ct.scale)


def params_pair(scheme: str, word: int):
    """(reference params, port params) on an n=64 chain of the word."""
    if word == 32:
        primes = gen_ntt_primes(N, 31, 6)
        q, p, scale = primes[:4], primes[4:], float(1 << 30)
    else:
        big = gen_ntt_primes(N, 60, 2)
        q, p, scale = [big[0]] + gen_ntt_primes(N, 40, 3), [big[1]], float(1 << 40)
    if scheme == 'bfv':
        return (RefBfvParams.create_custom(N, T_MOD, q, p, word_bits=word),
                BfvParams.create_custom(N, T_MOD, q, p, word_bits=word))
    return (RefCkksParams.create_custom(N, q, p, scale=scale, word_bits=word),
            CkksParams.create_custom(N, q, p, scale=scale, word_bits=word))


CASES = [('bfv', 32), ('bfv', 64), ('ckks', 32), ('ckks', 64)]
IDS = [f'{s}_w{w}' for s, w in CASES]


@pytest.fixture(scope='module', params=CASES, ids=IDS)
def pair(request):
    scheme, word = request.param
    rp, pp = params_pair(scheme, word)
    ref, port = ref_create(rp, seed=29), create_context_for_params(pp, seed=29, device='cpu')
    ref.gen_rotation_keys_for_rotations([1, 3], swap_rows=True)
    port.gen_rotation_keys_for_rotations([1, 3], swap_rows=True)
    return scheme, ref, port


def message(scheme, ctx, seed):
    rng = np.random.default_rng(seed)
    if scheme == 'bfv':
        return rng.integers(0, T_MOD, N)
    s = ctx.params.slots
    return rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)


def test_same_seed_same_keys(pair):
    scheme, ref, port = pair
    assert isinstance(port, BfvContext if scheme == 'bfv' else CkksContext)
    assert isinstance(port, FheContext) and not port.is_public
    assert np.array_equal(port.sk.coeffs, ref.sk.coeffs)
    for a, b in ((port.pk.data, ref.pk.data), (port.rlk.key_q, ref.rlk.key_q),
                 (port.rlk.key_p, ref.rlk.key_p)):
        assert np.array_equal(A(a), np.asarray(b).astype(np.uint64))
    assert sorted(port.glk.keys) == sorted(ref.glk.keys)
    for elt, key in ref.glk.keys.items():
        assert np.array_equal(A(port.glk.keys[elt].key_q), np.asarray(key.key_q).astype(np.uint64))


def test_empty_and_public_contexts(pair):
    scheme, ref, port = pair
    empty = type(port).create_empty_context(port.params, device='cpu')
    assert empty.is_public and empty.pk is None and empty.rlk is None and not empty.glk.keys
    pub = port.make_public_context()
    assert pub.is_public and pub.pk is port.pk and pub.rlk is port.rlk
    assert pub.glk.keys == port.glk.keys and pub.glk.keys is not port.glk.keys
    level = port.params.max_level
    ct = pub.encrypt(pub.encode(message(scheme, port, 1), level))
    with pytest.raises(RuntimeError, match='Context does not have sk and decryptor.'):
        pub.decrypt(ct)
    with pytest.raises(RuntimeError, match='does not have sk and the corresponding encryptor'):
        pub.encrypt_symmetric(pub.encode(message(scheme, port, 1), level))
    if scheme == 'bfv':
        assert np.array_equal(port.decrypt_decode(ct), message(scheme, port, 1))
    else:
        assert np.abs(port.decrypt_decode(ct) - message(scheme, port, 1)).max() < 1e-3


def _ref_and_port(name, scheme, ref, port, ca, cb, level, m):
    """(reference result, port result) of one context method."""
    pa, pb = port_ct(ca), port_ct(cb)
    if name in ('add', 'sub'):
        return getattr(ref, name)(ca, cb), getattr(port, name)(pa, pb)
    if name == 'neg':
        return ref.neg(ca), port.neg(pa)
    if name == 'rescale':
        if scheme == 'bfv':
            return ref.rescale(ca), port.rescale(pa)
        return ref.rescale(ref.mult_relin(ca, cb)), port.rescale(port.mult_relin(pa, pb))
    if name == 'rotate_cols':
        return ref.rotate_cols(ca, 3), port.rotate_cols(pa, 3)
    if name == 'advanced_rotate_cols':
        r, p = ref.advanced_rotate_cols(ca, [1]), port.advanced_rotate_cols(pa, [1])
        return r[1], p[1]
    if name == 'get_coeff':
        return ([ref.get_coeff(ca, 1, level, k) for k in (0, 7)],
                [port.get_coeff(pa, 1, level, k) for k in (0, 7)])
    if name == 'mult_scalar':
        s = 5 if scheme == 'bfv' else -1.5
        return ref.engine.mult_scalar(np, ca, s), port.mult_scalar(pa, s)
    if name == 'encode_coeffs':
        return ref.encode_coeffs(m, level), port.encode_coeffs(m, level)
    if name == 'encode_coeffs_ringt':
        return ref.encode_coeffs_ringt(m), port.encode_coeffs_ringt(m)
    if name == 'encode_coeffs_mul':
        return ref.encode_coeffs_mul(m, level), port.encode_coeffs_mul(m, level)
    if name == 'decrypt_coeffs':
        return ref.decrypt_coeffs(ca), port.decrypt_coeffs(pa)
    if name == 'noise_budget':
        return ref.noise_budget(ca), port.noise_budget(pa)
    if name == 'conjugate':
        return ref.engine.conjugate(np, ca, ref.glk.keys[galois_elt_row(N)]), port.conjugate(pa)
    assert name == 'drop_level'
    return ref.engine.drop_level(np, ca, 2), port.drop_level(pa, 2)


SHARED = ['add', 'sub', 'neg', 'rescale', 'rotate_cols', 'advanced_rotate_cols', 'get_coeff',
          'mult_scalar']
BFV_ONLY = ['encode_coeffs', 'encode_coeffs_ringt', 'encode_coeffs_mul', 'decrypt_coeffs',
            'noise_budget']
CKKS_ONLY = ['conjugate', 'drop_level']


@pytest.mark.parametrize('name', SHARED + BFV_ONLY + CKKS_ONLY)
def test_context_method_matches_reference(pair, name):
    scheme, ref, port = pair
    if name in (CKKS_ONLY if scheme == 'bfv' else BFV_ONLY):
        assert not hasattr(port, name)
        return
    level = port.params.max_level
    ca = ref.encrypt(ref.encode(message(scheme, ref, 2), level))
    cb = ref.encrypt(ref.encode(message(scheme, ref, 3), level))
    m = np.random.default_rng(4).integers(0, T_MOD, N // 2)
    want, got = _ref_and_port(name, scheme, ref, port, ca, cb, level, m)
    if isinstance(want, (list, float, np.ndarray)):
        assert np.array_equal(np.asarray(got), np.asarray(want).astype(np.asarray(got).dtype))
    elif name == 'encode_coeffs_ringt':
        assert np.array_equal(got.data.numpy(), np.asarray(want.data).astype(np.int64))
    else:
        assert same(got, want)


def test_encrypt_symmetric_matches_reference(pair):
    """Symmetric encryption from contexts of one seed in the same call order."""
    scheme, _, _ = pair
    rp, pp = params_pair(scheme, pair[2].params.word_bits)
    ref, port = ref_create(rp, seed=31), create_context_for_params(pp, seed=31, device='cpu')
    m = message(scheme, port, 5)
    for level in (port.params.max_level, 1):
        assert same(port.encrypt_symmetric(port.encode(m, level)),
                    ref.encrypt_symmetric(ref.encode(m, level)))


def test_message_checks_and_refusals(pair):
    """The reference's strings for a message too long, a bad level and
    operands of two levels; the CKKS bootstrapping and activation entries
    behave as the reference's."""
    scheme, ref, port = pair
    too_long = np.zeros(port._max_message_len() + 1)
    assert port._max_message_len() == (N if scheme == 'bfv' else port.params.slots)
    for ctx in (ref, port):
        with pytest.raises(RuntimeError, match='Invalid message length.'):
            ctx.encode(too_long)
        with pytest.raises(RuntimeError, match='Invalid level.'):
            ctx.encode(np.zeros(4), port.params.max_level + 1)
    a = port.encrypt(port.encode(message(scheme, port, 6), 2))
    b = port.encrypt(port.encode(message(scheme, port, 6), 1))
    with pytest.raises(RuntimeError, match='x0 and x1 have different levels.'):
        port.add(a, b)
    if scheme == 'ckks':
        # bootstrapping without a bootstrapper raises the reference's error;
        # the polynomial activations (at degree 1, which fits the chain's
        # levels) equal the reference's bit for bit
        ra = ref.encrypt(ref.encode(message(scheme, port, 6), port.params.max_level))
        for ctx, x in ((ref, ra), (port, port_ct(ra))):
            with pytest.raises(RuntimeError, match=r'call create_bootstrapper\(\) first'):
                ctx.bootstrap(x)
        assert same(port.poly_eval_relu_function(port_ct(ra), degree=1),
                    ref.poly_eval_relu_function(ra, degree=1))
        assert same(port.poly_eval_step_function(port_ct(ra), degree=1),
                    ref.poly_eval_step_function(ra, degree=1))
        port.set_log_slots(3)
        assert port.params.slots == 8
        port.set_log_slots(5)


def test_create_context_for_params():
    rp, pp = params_pair('ckks', 64)
    assert type(create_context_for_params(pp, random=False, device='cpu')) is CkksContext
    empty = create_context_for_params(params_pair('bfv', 32)[1], random=False, device='cpu')
    assert type(empty) is BfvContext and empty.sk is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            create_context_for_params(pp, seed=1)
    elt = galois_elt_col(1, N)
    ctx = create_context_for_params(pp, seed=3, device='cpu')
    ctx.gen_galois_keys_for_elements([elt])
    ref = ref_create(rp, seed=3)
    ref.gen_galois_keys_for_elements([elt])
    assert np.array_equal(A(ctx.glk.keys[elt].key_p),
                          np.asarray(ref.glk.keys[elt].key_p).astype(np.uint64))
