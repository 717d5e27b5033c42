"""lattisense_torch parameters, security estimate and the scalar BFV ops held
against lattisense_tpu: the ``FheParams`` base, ``BfvParams`` (with
``create_tpu_custom`` and its security warning), ``CkksParams``,
``params_from_task_json`` on BFV and CKKS blobs (``btp_*`` included),
``security_bits`` on every ``parameter.json`` entry, ``mult_scalar`` bit for
bit at both words, batched and not, and the BFV ``drop_level`` refusal.
"""

import json
import os
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lattisense_tpu import params as ref_params
from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.runtime import BfvContext as RefContext
from lattisense_tpu.schemes.types import Ciphertext as RefCiphertext
from lattisense_tpu.utils import security as ref_security

from lattisense_torch import params
from lattisense_torch.runtime import BfvContext, tasks
from lattisense_torch.schemes.bfv import BfvEngine
from lattisense_torch.schemes.types import Ciphertext
from lattisense_torch.utils import security

N = 256
T_MOD = 65537
FIELDS = ('n', 'logn', 'q', 'p', 'max_level', 'max_sp_level', 'p_prod', 'word_bits', 'algo')


def assert_same(port, ref, extra=()):
    for f in FIELDS + tuple(extra):
        assert getattr(port, f) == getattr(ref, f), f
    for lvl in range(port.max_level + 1):
        assert port.q_prod(lvl) == ref.q_prod(lvl)
    assert port.level_of(3) == ref.level_of(3)


def table():
    with open(params._TABLE_PATH) as f:
        return json.load(f)


def message(exc_type, fn):
    with pytest.raises(exc_type) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize('word', [32, 64])
def test_bfv_fields_equality_and_hash(word):
    primes = ref_primes(N, 31, 7)
    q, p = primes[:5], primes[5:]
    port = params.BfvParams.create_custom(N, T_MOD, q, p, word_bits=word)
    ref = ref_params.BfvParams.create_custom(N, T_MOD, q, p, word_bits=word)
    assert_same(port, ref, ('t',))
    assert [port.delta(lvl) for lvl in range(5)] == [ref.delta(lvl) for lvl in range(5)]
    assert isinstance(port, params.FheParams) and port.algo == 'BFV'
    twin = params.BfvParams.create_custom(N, T_MOD, list(q), list(p), word_bits=word)
    assert port == twin and hash(port) == hash(twin) and len({port, twin}) == 1
    assert port != params.BfvParams.create_custom(N, 257, q, p, word_bits=word)
    assert port != params.CkksParams.create_custom(N, q, p, word_bits=word)
    # hashes the same fields as the reference's __hash__
    assert hash(port) == hash(('BFV', N, tuple(q), tuple(p), word))


def test_error_messages_match_reference():
    primes = ref_primes(N, 31, 3)
    big = ref_primes(N, 40, 1)
    for fn in (lambda m: m.BfvParams(48, T_MOD, primes, []),
               lambda m: m.BfvParams(N, T_MOD, primes + big, [], word_bits=32),
               lambda m: m.CkksParams(N, primes, [], slots=3),
               lambda m: m.CkksParams(N, primes, [], slots=N)):
        assert message(ValueError, lambda: fn(params)) == message(ValueError, lambda: fn(ref_params))


def test_bfv_table_and_tpu_profiles():
    for n in table()['BFV']:
        n = int(n)
        assert_same(params.BfvParams.create(n), ref_params.BfvParams.create(n), ('t',))
        assert_same(params.BfvParams.create_tpu_param(n), ref_params.BfvParams.create_tpu_param(n),
                    ('t',))


@pytest.mark.parametrize('n, log_q, log_p', [(1024, 20, 10), (1024, 60, 31), (4096, 62, 31)])
def test_create_tpu_custom_and_its_warning(n, log_q, log_p):
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter('always')
        port = params.BfvParams.create_tpu_custom(n, T_MOD, log_q, log_p)
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter('always')
        ref = ref_params.BfvParams.create_tpu_custom(n, T_MOD, log_q, log_p)
    assert_same(port, ref, ('t',))
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert [w.category for w in got] == [w.category for w in want]
    assert bool(got) == (security.security_bits(port) < 128)


def test_security_bits_on_every_table_entry():
    """``security_bits`` and ``log_qp`` of every parameter.json chain and of
    every 31-bit re-cut, at both schemes."""
    checked = 0
    for algo, entries in table().items():
        port_cls = params.BfvParams if algo == 'BFV' else params.CkksParams
        ref_cls = ref_params.BfvParams if algo == 'BFV' else ref_params.CkksParams
        for n in entries:
            for make in ('create', 'create_tpu_param'):
                port, ref = getattr(port_cls, make)(int(n)), getattr(ref_cls, make)(int(n))
                assert security.security_bits(port) == ref_security.security_bits(ref)
                assert security.log_qp(port) == ref_security.log_qp(ref)
                assert security.check_security(port, min_bits=0) == \
                    ref_security.check_security(ref, min_bits=0)
                checked += 1
    assert checked == 18


def test_security_warning_text_word_for_word():
    over = params.BfvParams.create_custom(1024, T_MOD, ref_primes(1024, 31, 2), [],
                                          word_bits=32)
    ref_over = ref_params.BfvParams.create_custom(1024, T_MOD, list(over.q), [], word_bits=32)
    for check, p in ((security.check_security, over), (ref_security.check_security, ref_over)):
        with pytest.warns(UserWarning) as rec:
            assert check(p) == 0
        text = str(rec[0].message)
        assert text == ('parameter set n=1024 logQP=62 is below 128-bit classical security '
                        '(needs logQP <= 27); shorten the prime chain or increase n')
    odd = SimpleNamespace(n=3072, q=list(over.q), p=[])      # no table row
    with pytest.warns(UserWarning, match='no standard table row for this n'):
        security.check_security(odd)


def test_ckks_params():
    for n in table()['CKKS']:
        n = int(n)
        port, ref = params.CkksParams.create(n), ref_params.CkksParams.create(n)
        assert_same(port, ref, ('slots', 'scale', 'log_slots'))
        port.set_log_slots(5)
        ref.set_log_slots(5)
        assert (port.slots, port.log_slots) == (ref.slots, ref.log_slots) == (32, 5)
    for n in (16384, 65536):
        assert_same(params.CkksParams.create_tpu_param(n), ref_params.CkksParams.create_tpu_param(n),
                    ('slots', 'scale'))
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert_same(params.CkksParams.create_tpu_btp_param(), ref_params.CkksParams.create_tpu_btp_param(),
                    ('slots', 'scale'))
    primes = ref_primes(N, 40, 4)
    port = params.CkksParams.create_custom(N, primes[:3], primes[3:], slots=64, word_bits=64)
    ref = ref_params.CkksParams.create_custom(N, primes[:3], primes[3:], slots=64, word_bits=64)
    assert_same(port, ref, ('slots', 'scale'))
    assert port.scale == float(primes[2])


def test_params_from_task_json():
    with open(os.path.join(tasks.task_dir(tasks.MIX_W32), 'mega_ag.json')) as f:
        bfv = json.load(f)['parameter']
    for wb in (64, 32):
        port = params.params_from_task_json(bfv, word_bits=wb)
        ref = ref_params.params_from_task_json(bfv, word_bits=wb)
        assert isinstance(port, params.BfvParams)
        assert_same(port, ref, ('t',))
    assert params.params_from_task_json(bfv).word_bits == 64
    primes = ref_primes(N, 40, 4)
    ckks = {'n': N, 'q': primes[:3], 'p': primes[3:], 'slots': 32, 'scale': float(1 << 40)}
    btp = dict(ckks, btp_cts_depth=3, btp_stc_depth=2, btp_output_level=1, other=5)
    for blob in (ckks, btp):
        port = params.params_from_task_json(blob)
        ref = ref_params.params_from_task_json(blob)
        assert isinstance(port, params.CkksParams)
        assert_same(port, ref, ('slots', 'scale'))
        assert getattr(port, 'btp', None) == getattr(ref, 'btp', None)
    assert port.btp == {'btp_cts_depth': 3, 'btp_stc_depth': 2, 'btp_output_level': 1}


@pytest.fixture(scope='module', params=[32, 64], ids=['w32', 'u64'])
def pair(request):
    word = request.param
    if word == 32:
        primes = ref_primes(N, 31, 7)
        q, p = primes[:5], primes[5:]
    else:
        q = ref_primes(N, 50, 4)
        p = ref_primes(N, 51, 1, exclude=tuple(q))
    ref = RefContext.create_random_context(
        ref_params.BfvParams.create_custom(N, T_MOD, q, p, word_bits=word), seed=3)
    return ref, BfvEngine(params.BfvParams.create_custom(N, T_MOD, q, p, word_bits=word), 'cpu')


@pytest.mark.parametrize('batched', [False, True])
def test_mult_scalar_matches_reference(pair, batched):
    ref, eng = pair
    rng = np.random.default_rng(4)
    level = 2
    cts = [ref.encrypt(ref.encode(rng.integers(0, T_MOD, N), level)) for _ in range(3)]
    scalars = (0, 3, T_MOD - 1, (1 << 40) + 7)
    for s in scalars:
        want = [ref.engine.mult_scalar(np, c, s) for c in cts]
        datas = [torch.from_numpy(np.asarray(c.data).astype(np.int64)) for c in cts]
        if batched:
            got = eng.mult_scalar(Ciphertext(data=torch.stack(datas), level=level), s)
            assert got.level == level
            outs = list(got.data)
        else:
            outs = [eng.mult_scalar(Ciphertext(data=d, level=level), s).data for d in datas]
        for o, w in zip(outs, want):
            assert np.array_equal(o.numpy().astype(np.uint64), np.asarray(w.data).astype(np.uint64))
    m = rng.integers(0, T_MOD, N)
    ct = ref.encrypt(ref.encode(m, level))
    out = eng.mult_scalar(Ciphertext(data=torch.from_numpy(np.asarray(ct.data).astype(np.int64)),
                                     level=level), 5)
    dec = ref.decrypt_decode(RefCiphertext(data=out.data.numpy().astype(np.asarray(ct.data).dtype),
                                           level=level))
    assert np.array_equal(dec, (5 * m) % T_MOD)


def test_drop_level_refused_as_reference(pair):
    ref, eng = pair
    ct = ref.encrypt(ref.encode(np.arange(N) % T_MOD, 2))
    port_ct = Ciphertext(data=torch.from_numpy(np.asarray(ct.data).astype(np.int64)), level=2)
    assert message(NotImplementedError, lambda: eng.drop_level(port_ct)) == \
        message(NotImplementedError, lambda: ref.engine.drop_level(np, ct))


def test_context_encodes_match_reference(pair):
    """``BfvContext.encode_ringt`` / ``encode_mul`` as the reference's, with
    its message checks."""
    ref, eng = pair
    port = BfvContext.from_arrays(eng.params, ref.sk.coeffs, ref.pk.data, ref.rlk.key_q,
                                  ref.rlk.key_p, device='cpu')
    m = np.random.default_rng(5).integers(0, T_MOD, N)
    assert np.array_equal(port.encode_ringt(m).data.numpy(),
                          np.asarray(ref.encode_ringt(m).data).astype(np.int64))
    for level in (None, 1):
        got, want = port.encode_mul(m, level), ref.encode_mul(m, level)
        assert got.level == want.level
        assert np.array_equal(got.data.numpy().astype(np.uint64),
                              np.asarray(want.data).astype(np.uint64))
    for fn in (lambda c: c.encode_ringt([]), lambda c: c.encode_mul(m, 9)):
        assert message(RuntimeError, lambda: fn(port)) == message(RuntimeError, lambda: fn(ref))
