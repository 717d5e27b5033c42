"""lattisense_torch's serialization held byte for byte against lattisense_tpu's.

A blob written by either package is read by the other, and writing what was
read gives the same bytes: ciphertexts (with and without dropped low bits),
seed-compressed ciphertexts, and contexts with and without evaluation keys,
for BFV and CKKS on both words; bit packing and the seed expansion equal
the reference's on the same inputs.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.params import CkksParams as RefCkksParams
from lattisense_tpu.runtime import create_context_for_params as ref_create
from lattisense_tpu.utils import serialize as ref_ser

from lattisense_torch.params import BfvParams, CkksParams
from lattisense_torch.runtime import BfvContext, CkksContext, FheContext
from lattisense_torch.runtime import create_context_for_params
from lattisense_torch.utils import serialize as ser

N = 64


def A(t):
    return t.cpu().numpy().view(np.uint64) if isinstance(t, torch.Tensor) else np.asarray(
        t).astype(np.uint64)


CASES = [('bfv', 32), ('bfv', 64), ('ckks', 32), ('ckks', 64)]
IDS = [f'{s}_w{w}' for s, w in CASES]


@pytest.fixture(scope='module', params=CASES, ids=IDS)
def pair(request):
    """Reference and port contexts of one seed with two Galois keys and a
    switching key, and a ciphertext of each."""
    scheme, word = request.param
    if word == 32:
        primes = gen_ntt_primes(N, 31, 6)
        q, p, scale = primes[:4], primes[4:], float(1 << 30)
    else:
        big = gen_ntt_primes(N, 60, 2)
        q, p, scale = [big[0]] + gen_ntt_primes(N, 40, 3), [big[1]], float(1 << 40)
    if scheme == 'bfv':
        rp = RefBfvParams.create_custom(N, 257, q, p, word_bits=word)
        pp = BfvParams.create_custom(N, 257, q, p, word_bits=word)
        msg = np.arange(N) % 257
    else:
        rp = RefCkksParams.create_custom(N, q, p, scale=scale, word_bits=word)
        pp = CkksParams.create_custom(N, q, p, scale=scale, word_bits=word)
        msg = np.linspace(-1, 1, N // 2)
    ref, port = ref_create(rp, seed=37), create_context_for_params(pp, seed=37, device='cpu')
    for ctx in (ref, port):
        ctx.gen_rotation_keys_for_rotations([1], swap_rows=True)
        ctx.swk['swk_demo'] = ctx.rlk
    level = pp.max_level
    return {'ref': ref, 'port': port, 'msg': msg, 'scheme': scheme,
            'ref_ct': ref.encrypt(ref.encode(msg, level)),
            'port_ct': port.encrypt(port.encode(msg, level))}


@pytest.mark.parametrize('drops', [(0, 0), (3, 5)], ids=['exact', 'dropped'])
def test_ciphertext_blobs_cross_read(pair, drops):
    ref, port = pair['ref'], pair['port']
    blob = ref.serialize_ciphertext(pair['ref_ct'], *drops)
    back = FheContext.deserialize_ciphertext(blob, device='cpu')
    want = ref_ser.deserialize_ciphertext(blob)
    assert np.array_equal(A(back.data), A(want.data))
    assert (back.level, back.is_ntt, back.is_mform, back.scale) == (
        want.level, want.is_ntt, want.is_mform, want.scale)
    assert port.serialize_ciphertext(back, *drops) == blob
    mine = port.serialize_ciphertext(pair['port_ct'], *drops)
    assert mine == ref.serialize_ciphertext(ref_ser.deserialize_ciphertext(mine), *drops)
    assert mine == ref.serialize_ciphertext(pair['ref_ct'], *drops)   # one seed, one ciphertext
    if pair['scheme'] == 'ckks' and drops == (0, 0):
        # (dropping low bits of NTT-domain values is the reference's lossy
        # format and does not decrypt for CKKS in either package)
        assert np.abs(port.decrypt_decode(back) - pair['msg']).max() < 1e-3


def test_compressed_ciphertext_blobs_cross_read(pair):
    ref, port = pair['ref'], pair['port']
    seed = (1 << 100) + 12345
    level = 1
    rc = ref.encrypt_symmetric_compressed(ref.encode(pair['msg'], level), seed=seed)
    pc = port.encrypt_symmetric_compressed(port.encode(pair['msg'], level), seed=seed)
    assert np.array_equal(A(pc.c0), A(rc.c0))
    blob = rc.serialize(ref.params)
    assert pc.serialize(port.params) == blob
    back = ser.CompressedCiphertext.deserialize(blob, device='cpu')
    assert (back.seed, back.level, back.is_ntt, back.scale) == (seed, level, rc.is_ntt, rc.scale)
    full = port.compressed_ciphertext_to_ciphertext(back)
    want = ref.compressed_ciphertext_to_ciphertext(rc)
    assert np.array_equal(A(full.data), A(want.data))
    assert ref_ser.CompressedCiphertext.deserialize(pc.serialize(port.params)).seed == seed


@pytest.mark.parametrize('advanced', [False, True], ids=['public', 'advanced'])
def test_context_blobs_cross_read(pair, advanced):
    ref, port = pair['ref'], pair['port']
    blob = ref.serialize_advanced() if advanced else ref.serialize()
    assert (port.serialize_advanced() if advanced else port.serialize()) == blob
    back = FheContext.deserialize(blob, device='cpu')
    assert type(back) is (BfvContext if pair['scheme'] == 'bfv' else CkksContext)
    assert back.params == port.params and back.device == torch.device('cpu')
    assert np.array_equal(back.sk.coeffs, port.sk.coeffs)
    assert np.array_equal(A(back.pk.data), A(port.pk.data))
    if advanced:
        assert sorted(back.glk.keys) == sorted(port.glk.keys) and list(back.swk) == ['swk_demo']
        assert np.array_equal(A(back.rlk.key_q), A(port.rlk.key_q))
        assert back.serialize_advanced() == blob
    else:
        assert back.rlk is None and not back.glk.keys
        assert back.serialize() == blob
    assert ref_ser.deserialize_context(back.serialize()).sk.coeffs.tolist() == \
        port.sk.coeffs.tolist()


@pytest.mark.parametrize('width', [1, 2, 31, 46, 61, 64])
def test_bit_packing_matches_reference(width):
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 1 << 63, 77, dtype=np.uint64) >> np.uint64(64 - width) \
        if width < 64 else rng.integers(0, 1 << 63, 77, dtype=np.uint64)
    packed = ser.pack_bits(vals, width)
    assert packed == ref_ser.pack_bits(vals, width)
    assert np.array_equal(ser.unpack_bits(packed, width, 77), vals)
    with pytest.raises(ValueError, match='truncated'):
        ser.unpack_bits(packed[:-2], width, 77)


@pytest.mark.parametrize('seed', [7, (1 << 64) + 3, (1 << 127) + 11])
def test_seed_expansion_matches_reference(seed):
    moduli = gen_ntt_primes(256, 31, 2) + gen_ntt_primes(256, 59, 2)
    got = ser.expand_uniform(seed, moduli, 256)
    assert np.array_equal(got, ref_ser.expand_uniform(seed, moduli, 256))
    assert all((got[i] < q).all() for i, q in enumerate(moduli))


def test_bad_blobs_raise():
    with pytest.raises(ValueError, match='bad magic'):
        ser.deserialize_ciphertext(b'NOPE' + bytes(16), device='cpu')
    ct_blob = ref_ser.CompressedCiphertext(np.zeros((1, N), np.uint64), 5, 0, False).serialize(
        RefBfvParams.create_custom(N, 257, gen_ntt_primes(N, 31, 2), [], word_bits=32))
    with pytest.raises(ValueError, match="expected a ciphertext blob, got 'compressed_ct'"):
        ser.deserialize_ciphertext(ct_blob, device='cpu')
