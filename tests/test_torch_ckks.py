"""lattisense_torch's CKKS engine held bit for bit against lattisense_tpu.

Both packages sample through the same seeded CSPRNG, so contexts of the
same seed hold the same keys; every evaluation op of the port's
``CkksEngine`` takes the reference's ciphertexts and plaintexts (as int64
tensors on the CPU, where each kernel runs its plain twin) and must give the
reference's NumPy result (``xp=numpy``) bit for bit, with its level and
scale. Encoding and decoding are held to the reference's NumPy output
exactly. Chains: the n=64 chains of ``tests/test_ckks_golden.py`` (u64) and
``tests/test_word32.py`` (31-bit primes; 16 slots here, sparse packing),
and ``CkksParams.create(4096)``; then one n=16384 batched step per word:
``ckks_mult_relin_rescale`` at ``create(16384)`` level 3 and
``ckks_mult_relin_rescale2`` on the composite 2^60 chain of 31-bit primes at
level 10; and the rotation's noise on ``create_tpu_param(65536)``'s chain at
n=1024, equal to the reference's and peaked where the all-ones polynomial's
embedding peaks.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.params import CkksParams as RefParams
from lattisense_tpu.runtime import CkksContext as RefContext
from lattisense_tpu.utils.precision import get_precision_stats as ref_precision_stats

from lattisense_torch.params import CkksParams
from lattisense_torch.parallel.batch import (ckks_composite_params, ckks_mult_relin_rescale,
                                             ckks_mult_relin_rescale2, key_tree,
                                             make_batched_step)
from lattisense_torch.runtime import CkksContext
from lattisense_torch.schemes.galois import galois_elt_col, galois_elt_row
from lattisense_torch.schemes.types import (Ciphertext, Plaintext, PlaintextMul,
                                            PlaintextRingt)
from lattisense_torch.utils.precision import get_precision_stats


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


def same_data(port, ref):
    return np.array_equal(A(port), np.asarray(ref).astype(np.uint64))


def same(port, ref):
    """Data, level, domain and scale of a port carrier equal the reference's."""
    if hasattr(ref, 'digits'):
        return (same_data(port.c0, ref.c0) and same_data(port.digits, ref.digits)
                and port.level == ref.level and port.scale == ref.scale)
    return (same_data(port.data, ref.data) and port.level == ref.level
            and getattr(port, 'is_ntt', True) == getattr(ref, 'is_ntt', True)
            and port.scale == ref.scale)


def to_port(v):
    """A reference carrier → the port's, on the CPU."""
    name = type(v).__name__
    if name == 'Ciphertext':
        return Ciphertext(data=T(v.data), level=v.level, is_ntt=v.is_ntt, scale=v.scale)
    if name == 'Plaintext':
        return Plaintext(data=T(v.data), level=v.level, is_ntt=v.is_ntt, scale=v.scale)
    if name == 'PlaintextRingt':
        return PlaintextRingt(data=torch.from_numpy(np.asarray(v.data, dtype=np.int64)),
                              scale=v.scale)
    assert name == 'PlaintextMul', name
    return PlaintextMul(data=T(v.data), level=v.level, scale=v.scale)


def chain(name: str):
    """(n, q, p, slots, scale, word_bits) of a named chain."""
    if name == 'u64_n64':
        big = gen_ntt_primes(64, 60, 2)
        return 64, [big[0]] + gen_ntt_primes(64, 40, 4), [big[1]], None, float(1 << 40), 64
    if name == 'w32_n64':
        primes = gen_ntt_primes(64, 31, 7)
        return 64, primes[:5], primes[5:], 16, float(1 << 30), 32
    p = RefParams.create(4096)
    return 4096, p.q, p.p, p.slots, p.scale, 64


CHAINS = ['u64_n64', 'w32_n64', 'u64_4096']


@pytest.fixture(scope='module', params=CHAINS)
def pair(request):
    """Reference and port contexts of one seed, with a column and the row
    Galois key, and two reference ciphertexts with their messages."""
    n, q, p, slots, scale, wb = chain(request.param)
    ref = RefContext.create_random_context(
        RefParams.create_custom(n, q, p, slots, scale, word_bits=wb), seed=17)
    port = CkksContext.create_random_context(
        CkksParams.create_custom(n, q, p, slots, scale, word_bits=wb), seed=17, device='cpu')
    elts = [galois_elt_col(1, n), galois_elt_row(n)]
    ref.gen_galois_keys_for_elements(elts)
    port.gen_galois_keys_for_elements(elts)
    rng = np.random.default_rng(3)
    s = ref.params.slots
    msgs = [rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s) for _ in range(3)]
    level = ref.params.max_level
    cts = [ref.encrypt(ref.encode(m, level)) for m in msgs[:2]]
    for m in msgs[:2]:          # keep the two generators in step
        port.encrypt(port.encode(m, level))
    return {'ref': ref, 'port': port, 'msgs': msgs, 'cts': cts, 'level': level, 'elts': elts}


def test_same_seed_same_keys(pair):
    ref, port = pair['ref'], pair['port']
    assert port.engine.word_bits == ref.params.word_bits
    assert np.array_equal(port.sk.coeffs, ref.sk.coeffs)
    assert same_data(port.pk.data, ref.pk.data)
    assert same_data(port.rlk.key_q, ref.rlk.key_q) and same_data(port.rlk.key_p, ref.rlk.key_p)
    for elt, key in ref.glk.keys.items():
        assert same_data(port.glk.keys[elt].key_q, key.key_q), elt
        assert same_data(port.glk.keys[elt].key_p, key.key_p), elt


def test_encode_and_decode_match(pair):
    """encode, encode_mul, encode_ringt and encode_const at two scales;
    decode of a coefficient vector; the precision statistics."""
    ref, port, m, level = pair['ref'], pair['port'], pair['msgs'][2], pair['level']
    for scale in (None, ref.params.scale / 2):
        kw = {} if scale is None else {'scale': scale}
        assert same(port.encode(m, level, **kw), ref.encode(m, level, **kw))
        assert same(port.encode_mul(m, level, **kw), ref.encode_mul(m, level, **kw))
        pr, rr = port.encode_ringt(m, **kw), ref.encode_ringt(m, **kw)
        assert np.array_equal(pr.data.numpy(), rr.data) and pr.scale == rr.scale
        pc, rc = port.engine.encode_const(-0.375, level, scale), ref.engine.encode_const(
            -0.375, level, scale)
        assert pc.data.is_contiguous() and same(pc, rc)
    coeffs = ref.decrypt(pair['cts'][0])
    assert np.array_equal(port.engine.decode(coeffs, 3.5e9), ref.engine.decode(coeffs, 3.5e9))
    got = port.decrypt_decode(to_port(pair['cts'][0]))
    mine, theirs = get_precision_stats(pair['msgs'][0], got), ref_precision_stats(
        pair['msgs'][0], got)
    assert vars(mine.mean_precision) == vars(theirs.mean_precision)
    assert mine.std_freq == theirs.std_freq


def test_encrypt_and_decrypt_match(pair):
    """Asymmetric, symmetric and seed-compressed encryption from contexts of
    one seed in the same call order; decryption of the reference's
    ciphertexts."""
    ref, port, m, level = pair['ref'], pair['port'], pair['msgs'][2], pair['level']
    assert same(port.encrypt(port.encode(m, level)), ref.encrypt(ref.encode(m, level)))
    assert same(port.encrypt_symmetric(port.encode(m, level)),
                ref.encrypt_symmetric(ref.encode(m, level)))
    pc = port.encrypt_symmetric_compressed(port.encode(m, level - 1))
    rc = ref.encrypt_symmetric_compressed(ref.encode(m, level - 1))
    assert pc.seed == rc.seed and same_data(pc.c0, rc.c0) and pc.scale == rc.scale
    assert same(port.compressed_ciphertext_to_ciphertext(pc),
                ref.compressed_ciphertext_to_ciphertext(rc))
    for ct, msg in zip(pair['cts'], pair['msgs']):
        assert np.array_equal(port.decrypt(to_port(ct)), ref.decrypt(ct))
        assert np.abs(port.decrypt_decode(to_port(ct)) - msg).max() < 1e-3


def _op(name, eng, xp, keys, a, b, pts):
    """One evaluation op on either package's engine (xp=None: the port)."""
    args = () if xp is None else (xp,)
    rlk, glk = keys
    elt_col, elt_row = sorted(glk)[0], galois_elt_row(eng.n)
    kind, _, operand = name.partition('_')
    if kind in ('add', 'sub', 'mult') and operand:
        other = b if operand == 'ct' else pts[operand]
        return getattr(eng, kind)(*args, a, other)
    if name == 'neg':
        return eng.neg(*args, a)
    if name == 'relin':
        return eng.relinearize(*args, eng.mult(*args, a, b), rlk)
    if name == 'rescale':
        return eng.rescale(*args, eng.relinearize(*args, eng.mult(*args, a, b), rlk))
    if name == 'drop':
        return eng.drop_level(*args, a, 1)
    if name == 'rotate':
        return eng.rotate(*args, a, 1, glk[galois_elt_col(1, eng.n)])
    if name == 'conjugate':
        return eng.conjugate(*args, a, glk[elt_row])
    if name == 'keyswitch':
        return eng.key_switch(*args, a, rlk)
    if name == 'decomp':
        return eng.rns_sp_decomp(*args, a)
    if name == 'hoisted':
        return eng.apply_galois_decomposed(*args, eng.rns_sp_decomp(*args, a), elt_col,
                                           glk[elt_col])
    assert name == 'scalar'
    return eng.mult_scalar(*args, a, -0.625)


OPS = ['add_ct', 'add_pt', 'add_ringt', 'sub_ct', 'sub_pt', 'sub_ringt', 'neg', 'mult_ct',
       'mult_pt', 'mult_ringt', 'mult_mul', 'relin', 'rescale', 'drop', 'rotate', 'conjugate',
       'keyswitch', 'decomp', 'hoisted', 'scalar']


@pytest.mark.parametrize('op', OPS)
def test_eval_op_matches_reference(pair, op):
    ref, port, level = pair['ref'], pair['port'], pair['level']
    a, b = pair['cts']
    m = pair['msgs'][2]
    ref_pts = {'pt': ref.encode(m, level), 'ringt': ref.encode_ringt(m),
               'mul': ref.encode_mul(m, level)}
    want = _op(op, ref.engine, np, (ref.rlk, ref.glk.keys), a, b, ref_pts)
    got = _op(op, port.engine, None, (port.rlk, port.glk.keys), to_port(a), to_port(b),
              {k: to_port(v) for k, v in ref_pts.items()})
    assert same(got, want)


def test_errors_match_reference(pair):
    """Scale and level mismatches raise as in the reference; so does a
    bootstrap on an engine without a bootstrapper."""
    ref, port, level = pair['ref'], pair['port'], pair['level']
    a = to_port(pair['cts'][0])
    with pytest.raises(ValueError, match='scale mismatch'):
        port.engine.add(a, port.encode(pair['msgs'][2], level, scale=port.params.scale * 2))
    with pytest.raises(ValueError, match='level mismatch in sub'):
        port.engine.sub(a, port.engine.drop_level(a))
    for call in (lambda: port.engine.bootstrap(a, {}),
                 lambda: ref.engine.bootstrap(np, pair['cts'][0], {})):
        with pytest.raises(RuntimeError, match='engine has no bootstrapper; use CkksBtpContext'):
            call()


# ---------------------------------------------------------------------------
# the batched steps at n=16384, one element
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('word', ['u64', 'w32'])
def test_batched_step_n16384_matches_reference(word):
    """u64: ckks_mult_relin_rescale at create(16384), level 3; w32:
    ckks_mult_relin_rescale2 at the composite chain, level 10. The port's
    batched step on the reference's keys and ciphertexts, B=1, equals the
    reference's NumPy step and decodes a·b within 1e-3."""
    if word == 'u64':
        ref_params, params, level, step = (RefParams.create(16384), CkksParams.create(16384), 3,
                                           ckks_mult_relin_rescale)
    else:
        params, level, step = ckks_composite_params(16384), 10, ckks_mult_relin_rescale2
        tpu = RefParams.create_tpu_param(16384)
        assert (params.q, params.p) == (tpu.q, tpu.p)
        ref_params = RefParams.create_custom(16384, tpu.q, tpu.p, slots=8192, scale=2.0 ** 60,
                                             word_bits=32)
    ref = RefContext.create_random_context(ref_params, seed=23)
    port = CkksContext.from_arrays(params, ref.sk.coeffs, ref.pk.data, ref.rlk.key_q,
                                   ref.rlk.key_p, device='cpu')
    rng = np.random.default_rng(8)
    msgs = [rng.uniform(-1, 1, params.slots) for _ in range(2)]
    a, b = (ref.encrypt(ref.encode(m, level)) for m in msgs)
    e = ref.engine
    want = e.rescale(np, e.relinearize(np, e.mult(np, a, b), ref.rlk))
    if word == 'w32':
        want = e.rescale(np, want)
    f = make_batched_step(port.engine, step, level, is_ntt=True)
    out = f(T(a.data)[None], T(b.data)[None], key_tree(port))
    assert out.shape == (1, 2, want.level + 1, 16384)
    assert same_data(out[0], want.data)
    got = port.decrypt_decode(Ciphertext(data=out[0], level=want.level, is_ntt=True,
                                         scale=want.scale))
    assert np.abs(got - msgs[0] * msgs[1]).max() < 1e-3


def test_rotation_noise_of_the_n65536_w32_chain_matches_reference():
    """The rotation's noise on the 31-bit chain of
    ``create_tpu_param(65536)`` (44 q, 7 p primes; at n = 1024, where its
    primes are NTT-friendly too) at the profile's scale 2^30. Same seed,
    same keys: the port's rotation equals the reference's bit for bit, so
    the decoded error is the reference's own. That error is concentrated on
    the few slots where the embedding of the all-ones polynomial
    Σ_k X^k peaks (2n/π on slot 0, falling off as 1/angle): after the fast
    mod-up each key-switch digit lies in [0, α·Q_j), and its mean, about
    α·Q_j/2 in every coefficient, multiplies the key's error e_j by
    Σ_k X^k. That term grows as n^1.5 against n for the rest of the noise,
    which is why ``create_tpu_param(65536)`` decodes a rotation at 2^30
    about 0.2 off on its first slots (the card test at 2^16), and a fresh
    encryption shows no such peak."""
    from lattisense_torch.schemes.encoding import ckks_decode_values
    n = 1024
    big = CkksParams.create_tpu_param(1 << 16)
    assert (len(big.q), len(big.p), big.scale) == (44, 7, 2.0 ** 30)
    args = (n, list(big.q), list(big.p), n // 2, big.scale)
    ref = RefContext.create_random_context(RefParams.create_custom(*args, word_bits=32), seed=13)
    port = CkksContext.create_random_context(CkksParams.create_custom(*args, word_bits=32),
                                             seed=13, device='cpu')
    ref.gen_rotation_keys_for_rotations([1])
    port.gen_rotation_keys_for_rotations([1])
    m = np.random.default_rng(13).uniform(-1, 1, n // 2)
    ct = ref.encrypt(ref.encode(m, big.max_level))
    rot, want = port.rotate_cols(to_port(ct), 1), ref.rotate_cols(ct, 1)
    assert same(rot, want)
    err = np.abs(port.decrypt_decode(rot) - np.roll(m, -1))
    fresh = np.abs(port.decrypt_decode(to_port(ct)) - m)
    ones = np.abs(ckks_decode_values(np.ones(n, dtype=np.int64), n, n // 2, 1.0))
    assert abs(ones[0] - 2 * n / np.pi) < 1e-3 * ones[0]
    peaks = set(np.argsort(ones)[::-1][:3])
    assert set(np.argsort(err)[::-1][:2]) <= peaks
    assert err.max() > 20 * np.median(err)
    assert fresh.max() < 10 * np.median(fresh)
