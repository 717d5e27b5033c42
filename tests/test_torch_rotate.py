"""lattisense_torch rotations held bit for bit against lattisense_tpu.

Galois maps, the NAF split of a rotation, Galois keys from the same seed,
``apply_galois`` in every input and output form, NAF-composite
``rotate_cols``, ``rotate_rows``, hoisted rotations (``rns_sp_decomp`` +
``apply_galois_decomposed``, compared with the reference's hoisted path, not
with direct rotations, which round differently), the form conversions and
the batched rotate step. The reference runs on ``xp=numpy``; keys cross over
as arrays (``BfvContext.add_galois_key_arrays``).
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.frontend.custom_task import get_glk_col as ref_get_glk_col
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.runtime import BfvContext as RefContext
from lattisense_tpu.schemes import galois as ref_galois
from lattisense_tpu.schemes.types import Ciphertext as RefCiphertext

from lattisense_torch.params import BfvParams
from lattisense_torch.parallel.batch import key_tree, make_batched_step, make_rotate_step
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes import galois
from lattisense_torch.schemes.types import Ciphertext

N = 256
T_MOD = 65537
LEVEL = 3
STEPS = (1, -1, 5, -7)


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(port, ref):
    return np.array_equal(port.cpu().numpy().astype(np.uint64),
                          np.asarray(ref).astype(np.uint64))


def rolled(m, step):
    half = len(m) // 2
    return np.concatenate([np.roll(m[:half], -step), np.roll(m[half:], -step)])


@pytest.fixture(scope='module')
def pair():
    """A reference context with rotation keys for STEPS and the row key, and
    a port context holding the same keys as arrays."""
    chain = ref_primes(N, 31, 7)
    q, p = chain[:5], chain[5:]
    ref = RefContext.create_random_context(
        RefBfvParams.create_custom(N, T_MOD, q, p, word_bits=32), seed=31)
    ref.gen_rotation_keys_for_rotations(list(STEPS), swap_rows=True)
    ref.gen_galois_keys_for_elements([galois.galois_elt_col(s, N) for s in STEPS])
    port = BfvContext.from_arrays(BfvParams.create_custom(N, T_MOD, q, p, word_bits=32), ref.sk.coeffs,
                                  ref.pk.data, ref.rlk.key_q, ref.rlk.key_p, device='cpu')
    for elt, k in ref.glk.keys.items():
        port.add_galois_key_arrays(elt, k.key_q, k.key_p)
    return ref, port


def encrypt_pair(ref, seed, level=LEVEL):
    m = np.random.default_rng(seed).integers(0, T_MOD, N)
    ct = ref.encrypt(ref.encode(m, level))
    return m, ct, Ciphertext(data=T(ct.data), level=level)


# ---------------------------------------------------------------------------
# maps and keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [16, 256, 4096])
def test_galois_maps_match_reference(n):
    elts = [galois.galois_elt_col(s, n) for s in (1, -1, 3, n // 4)] + [galois.galois_elt_row(n)]
    assert elts[:4] == [ref_galois.galois_elt_col(s, n) for s in (1, -1, 3, n // 4)]
    assert elts[4] == ref_galois.galois_elt_row(n)
    for g in elts:
        src, neg = galois.coeff_automorphism_maps(n, g)
        ref_src, ref_neg = ref_galois.coeff_automorphism_maps(n, g)
        assert np.array_equal(src, ref_src) and np.array_equal(neg, ref_neg.astype(np.int64))
        assert np.array_equal(galois.ntt_automorphism_perm(n, g),
                              ref_galois.ntt_automorphism_perm(n, g))


def test_glk_col_matches_frontend():
    for n in (256, 4096):
        for step in list(range(-40, 41)) + [n // 2 - 1, -(n // 2) + 3, n // 2, n]:
            assert galois.get_glk_col(step, n) == ref_get_glk_col(step, n), (n, step)


def test_automorphisms_on_tensors_match_reference(pair):
    ref, port = pair
    ring = port.engine.ring(LEVEL)
    ref_ring = ref.engine.ring(LEVEL)
    x = np.stack([np.random.default_rng(3).integers(0, q, (2, N)) for q in ring.moduli], axis=-2)
    for g in (galois.galois_elt_col(1, N), galois.galois_elt_row(N)):
        want = ref_galois.apply_automorphism_coeff(np, x.astype(np.uint64), ref_ring.q, N, g)
        assert same(galois.apply_automorphism_coeff(T(x), ring.q, N, g), want)
        assert same(galois.apply_automorphism_ntt(T(x), N, g),
                    ref_galois.apply_automorphism_ntt(np, x, N, g))


def test_same_seed_same_galois_keys():
    chain = ref_primes(N, 31, 7)
    q, p = chain[:5], chain[5:]
    ref = RefContext.create_random_context(
        RefBfvParams.create_custom(N, T_MOD, q, p, word_bits=32), seed=41)
    port = BfvContext.create_random_context(BfvParams.create_custom(N, T_MOD, q, p, word_bits=32), seed=41,
                                            device='cpu')
    ref.gen_rotation_keys_for_rotations([3, -5], swap_rows=True)
    port.gen_rotation_keys_for_rotations([3, -5], swap_rows=True)
    assert list(port.glk.keys) == list(ref.glk.keys)
    for elt, k in ref.glk.keys.items():
        assert same(port.glk.keys[elt].key_q, k.key_q) and same(port.glk.keys[elt].key_p, k.key_p)
        assert port.glk.keys[elt].level == k.level


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['col+1', 'col-1', 'row'])
def test_apply_galois_matches_reference(pair, kind):
    ref, port = pair
    m, ct_r, ct_p = encrypt_pair(ref, 5)
    g = {'col+1': galois.galois_elt_col(1, N), 'col-1': galois.galois_elt_col(-1, N),
         'row': galois.galois_elt_row(N)}[kind]
    want = ref.engine.apply_galois(np, ct_r, g, ref.glk.keys[g])
    got = port.engine.apply_galois(ct_p, g, port.glk.keys[g])
    assert same(got.data, want.data)
    if kind == 'row':
        assert np.array_equal(port.decrypt_decode(got), np.concatenate([m[N // 2:], m[:N // 2]]))
    else:
        assert np.array_equal(port.decrypt_decode(got), rolled(m, 1 if kind == 'col+1' else -1))


@pytest.mark.parametrize('form', ['ntt', 'mform', 'ntt+mform'])
def test_apply_galois_forms_match_reference(pair, form):
    """NTT and Montgomery inputs are normalised first; the output form
    follows the input by default and can be forced."""
    ref, port = pair
    _, ct_r, ct_p = encrypt_pair(ref, 6)
    is_ntt, is_mform = 'ntt' in form, 'mform' in form
    if is_ntt:
        ct_r, ct_p = ref.engine.to_ntt(np, ct_r), port.engine.to_ntt(ct_p)
    if is_mform:
        ct_r, ct_p = ref.engine.to_mf(np, ct_r), port.engine.to_mf(ct_p)
    assert same(ct_p.data, ct_r.data)
    g = galois.galois_elt_col(1, N)
    for out_ntt, out_mform in ((None, None), (False, False), (not is_ntt, True)):
        want = ref.engine.apply_galois(np, ct_r, g, ref.glk.keys[g], out_ntt=out_ntt,
                                       out_mform=out_mform)
        got = port.engine.apply_galois(ct_p, g, port.glk.keys[g], out_ntt=out_ntt,
                                       out_mform=out_mform)
        assert (got.is_ntt, got.is_mform) == (want.is_ntt, want.is_mform)
        assert same(got.data, want.data)


@pytest.mark.parametrize('step', [5, -7, 9])
def test_rotate_cols_naf_composite_matches_reference(pair, step):
    ref, port = pair
    m, ct_r, ct_p = encrypt_pair(ref, 7)
    if step == 9:   # NAF 8 + 1: the +8 key is missing in both
        with pytest.raises(RuntimeError, match='missing Galois key for element'):
            port.rotate_cols(ct_p, step)
        with pytest.raises(RuntimeError, match='missing Galois key for element'):
            ref.rotate_cols(ct_r, step)
        return
    want = ref.rotate_cols(ct_r, step)
    got = port.rotate_cols(ct_p, step)
    assert same(got.data, want.data)
    assert np.array_equal(port.decrypt_decode(got), rolled(m, step))


def test_rotate_rows_matches_reference(pair):
    ref, port = pair
    _, ct_r, ct_p = encrypt_pair(ref, 8)
    assert same(port.rotate_rows(ct_p).data, ref.rotate_rows(ct_r).data)
    assert same(port.engine.rotate_rows(ct_p, port.glk.keys[galois.galois_elt_row(N)]).data,
                ref.engine.rotate_rows(np, ct_r, ref.glk.keys[galois.galois_elt_row(N)]).data)
    g1 = galois.galois_elt_col(1, N)
    assert same(port.engine.rotate_cols(ct_p, 1, port.glk.keys[g1]).data,
                ref.engine.rotate_cols(np, ct_r, 1, ref.glk.keys[g1]).data)


def test_hoisted_rotations_match_reference(pair):
    ref, port = pair
    m, ct_r, ct_p = encrypt_pair(ref, 9)
    dct_r = ref.engine.rns_sp_decomp(np, ct_r)
    dct_p = port.engine.rns_sp_decomp(ct_p)
    assert same(dct_p.digits, dct_r.digits)
    for s in STEPS:
        g = galois.galois_elt_col(s, N)
        for out_ntt, out_mform in ((False, False), (True, True)):
            want = ref.engine.apply_galois_decomposed(np, dct_r, g, ref.glk.keys[g],
                                                      out_ntt=out_ntt, out_mform=out_mform)
            got = port.engine.apply_galois_decomposed(dct_p, g, port.glk.keys[g],
                                                      out_ntt=out_ntt, out_mform=out_mform)
            assert same(got.data, want.data), (s, out_ntt)
    # the context's list form shares one decomposition
    want = ref.advanced_rotate_cols(ct_r, list(STEPS))
    got = port.advanced_rotate_cols(ct_p, list(STEPS))
    assert list(got) == list(STEPS)
    for s in STEPS:
        assert same(got[s].data, want[s].data)
        assert np.array_equal(port.decrypt_decode(got[s]), rolled(m, s))
    assert same(port.advanced_rotate_cols(ct_p, 1).data, ref.advanced_rotate_cols(ct_r, 1).data)


def test_form_conversions_match_reference(pair):
    ref, port = pair
    _, ct_r, ct_p = encrypt_pair(ref, 10)
    re, pe = ref.engine, port.engine
    for name in ('to_ntt', 'to_mf', 'to_mul'):
        want, got = getattr(re, name)(np, ct_r), getattr(pe, name)(ct_p)
        assert (got.is_ntt, got.is_mform) == (want.is_ntt, want.is_mform)
        assert same(got.data, want.data), name
    back = pe.to_inv_ntt(pe.to_ntt(ct_p))
    assert torch.equal(back.data, ct_p.data)
    with pytest.raises(ValueError):
        pe.to_inv_ntt(ct_p)
    with pytest.raises(ValueError):
        pe.to_mul(pe.to_mf(ct_p))


@pytest.mark.parametrize('batch', [2])
def test_batched_rotate_step(pair, batch):
    """The rotate path's step at B=2: each output equals the reference's
    apply_galois on that ciphertext and decrypts to the rolled slots."""
    ref, port = pair
    elt = galois.galois_elt_col(1, N)
    rng = np.random.default_rng(11)
    msgs = rng.integers(0, T_MOD, (batch, N))
    cts = [ref.encrypt(ref.encode(m, LEVEL)) for m in msgs]
    step = make_batched_step(port.engine, make_rotate_step(elt), LEVEL, n_inputs=1)
    out = step(T(np.stack([c.data for c in cts])), key_tree(port, galois_elts=[elt]))
    assert out.shape == (batch, 2, LEVEL + 1, N)
    for i in range(batch):
        want = ref.engine.apply_galois(np, RefCiphertext(data=cts[i].data, level=LEVEL), elt,
                                       ref.glk.keys[elt])
        assert same(out[i], want.data), i
        got = Ciphertext(data=out[i], level=LEVEL)
        assert np.array_equal(port.decrypt_decode(got), rolled(msgs[i], 1))
    with pytest.raises(TypeError):
        step(T(cts[0].data)[None])                  # keys missing


def test_batched_hoisted_rotation(pair):
    """rns_sp_decomp and apply_galois_decomposed take leading batch
    dimensions: each element equals the reference's hoisted rotation."""
    ref, port = pair
    cts = [encrypt_pair(ref, 12 + i)[1] for i in range(2)]
    batched = Ciphertext(data=T(np.stack([c.data for c in cts])), level=LEVEL)
    dct = port.engine.rns_sp_decomp(batched)
    g = galois.galois_elt_col(-1, N)
    got = port.engine.apply_galois_decomposed(dct, g, port.glk.keys[g])
    for i, ct in enumerate(cts):
        want = ref.engine.apply_galois_decomposed(np, ref.engine.rns_sp_decomp(np, ct), g,
                                                  ref.glk.keys[g])
        assert same(got.data[i], want.data), i
