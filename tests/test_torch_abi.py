"""lattisense_torch's raw-RNS C ABI held against lattisense_tpu's.

The ctypes structs have the JAX classes' sizes and field offsets (the
abi/c_types.h layout); the buffers exported from the port's tensors equal
the JAX export of the same ciphertext, plaintext, relinearization key and
Galois keys, with ``mf_nbits`` 0 and 64, on both words; and importing what
was exported gives back the same tensors.

The JAX exporters hand a uint64 view of the arrays' memory to the structs,
which is right only for the 64-bit word's uint64 arrays: a 32-bit word's
uint32 arrays come out as pairs of residues a word. The port exports every
residue as one uint64, so at the 32-bit word it is held against the JAX
export of the same values widened to uint64 after the JAX word arithmetic
(``mf_nbits=0``'s de-Montgomery with the 32-bit ring).
"""

import ctypes

import numpy as np
import pytest
import torch

from lattisense_tpu import abi as rabi
from lattisense_tpu.core import u64 as ref_u64
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.core.modring import get_rns_ring as ref_ring
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.runtime import BfvContext as RefBfvContext
from lattisense_tpu.schemes.types import Ciphertext as RefCiphertext
from lattisense_tpu.schemes.types import KeySwitchKey as RefKeySwitchKey
from lattisense_tpu.schemes.types import Plaintext as RefPlaintext

from lattisense_torch import abi
from lattisense_torch.core.modring import get_rns_ring
from lattisense_torch.params import BfvParams
from lattisense_torch.runtime import BfvContext

N, T = 64, 65537
STRUCTS = ['CComponent', 'CPolynomial', 'CPlaintext', 'CCiphertext', 'CPublicKey',
           'CKeySwitchKey', 'CRelinKey', 'CGaloisKey']


def A(t):
    return t.cpu().numpy().view(np.uint64)


@pytest.mark.parametrize('name', STRUCTS)
def test_struct_layout_matches_reference(name):
    port, ref = getattr(abi, name), getattr(rabi, name)
    assert ctypes.sizeof(port) == ctypes.sizeof(ref)
    assert [f[0] for f in port._fields_] == [f[0] for f in ref._fields_]
    for field, _ in port._fields_:
        assert getattr(port, field).offset == getattr(ref, field).offset
        assert getattr(port, field).size == getattr(ref, field).size
    assert abi.CCiphertext.degree.offset == 4


@pytest.fixture(scope='module', params=[64, 32], ids=['u64', 'w32'])
def pair(request):
    """Reference and port contexts of one seed (the same keys), a Galois key
    of two elements, and the Q∪P rings of each."""
    word = request.param
    if word == 64:
        q = gen_ntt_primes(N, 50, 4)
        p = gen_ntt_primes(N, 51, 2, exclude=tuple(q))
    else:
        primes = gen_ntt_primes(N, 31, 8)
        q, p = primes[:6], primes[6:]
    ref = RefBfvContext.create_random_context(RefBfvParams.create_custom(N, T, q, p,
                                                                         word_bits=word), seed=77)
    port = BfvContext.create_random_context(BfvParams.create_custom(N, T, q, p, word_bits=word),
                                            seed=77, device='cpu')
    for c in (ref, port):
        c.gen_rotation_keys_for_rotations([1, 2])
    qp = tuple(q) + tuple(p)
    return ref, port, ref_ring(qp, N, word), get_rns_ring(qp, N, 'cpu', word)


def walk(s):
    """Every limb buffer of a struct as uint64 arrays, in memory order."""
    if isinstance(s, (abi.CPolynomial, rabi.CPolynomial)):
        return [np.ctypeslib.as_array(s.components[i].data, shape=(s.components[i].n,)).copy()
                for i in range(s.n_component)]
    if isinstance(s, (abi.CPlaintext, rabi.CPlaintext)):
        return [np.array([s.level])] + walk(s.poly)
    if isinstance(s, (abi.CCiphertext, rabi.CCiphertext)):
        return [np.array([s.level, s.degree])] + [b for j in range(s.degree + 1)
                                                  for b in walk(s.polys[j])]
    if isinstance(s, (abi.CKeySwitchKey, rabi.CKeySwitchKey)):
        return [np.array([s.n_public_key])] + [b for d in range(s.n_public_key)
                                               for b in walk(s.public_keys[d])]
    return ([np.ctypeslib.as_array(s.galois_elements, shape=(s.n_key_switch_key,)).copy()]
            + [b for i in range(s.n_key_switch_key) for b in walk(s.key_switch_keys[i])])


def same_buffers(port_exp, ref_exp):
    got, want = walk(port_exp.struct), walk(ref_exp.struct)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def wide(a):
    return np.asarray(a).astype(np.uint64)


def ref_key_export(key, mf_nbits, ring):
    """The JAX export of ``key`` with its residues widened to uint64 after
    the JAX package's own (word-native) de-Montgomery; at the 64-bit word
    this is the JAX export itself."""
    data = np.concatenate([np.asarray(key.key_q), np.asarray(key.key_p)], axis=2)
    if mf_nbits == 0:
        data = ref_u64.from_mont(np, data, ring.q, ring.pinv)
    Lq = key.key_q.shape[2]
    return rabi.export_keyswitch_key(RefKeySwitchKey(key_q=wide(data[:, :, :Lq]),
                                                     key_p=wide(data[:, :, Lq:])), 64)


def test_ciphertext_and_plaintext_exports_match(pair):
    ref, port, _, _ = pair
    m = np.arange(N) % T
    level = 2
    pt_r, pt_p = ref.encode(m, level), port.encode(m, level)
    np.testing.assert_array_equal(A(pt_p.data), pt_r.data)
    ct_r = ref.encrypt(pt_r)
    ct_p = port.encrypt(port.encode(m, level))
    # the same ciphertext on both sides: the reference's values in a tensor
    ct_p.data = torch.from_numpy(np.asarray(ct_r.data).astype(np.int64))
    exp = abi.export_ciphertext(ct_p)
    same_buffers(exp, rabi.export_ciphertext(RefCiphertext(data=wide(ct_r.data), level=level)))
    same_buffers(abi.export_plaintext(pt_p),
                 rabi.export_plaintext(RefPlaintext(data=wide(pt_r.data), level=level)))
    back = abi.import_ciphertext(exp.struct, device='cpu')
    assert torch.equal(back.data, ct_p.data) and back.level == level
    np.testing.assert_array_equal(port.decrypt_decode(back), m)
    pexp = abi.export_plaintext(pt_p)            # owns the buffers the struct points to
    pt_back = abi.import_plaintext(pexp.struct, device='cpu')
    assert torch.equal(pt_back.data, pt_p.data) and pt_back.level == level


@pytest.mark.parametrize('mf_nbits', [64, 0])
def test_key_exports_match_and_round_trip(pair, mf_nbits):
    ref, port, rring, pring = pair
    np.testing.assert_array_equal(A(port.rlk.key_q), ref.rlk.key_q)
    exp = abi.export_keyswitch_key(port.rlk, mf_nbits, pring)
    same_buffers(exp, ref_key_export(ref.rlk, mf_nbits, rring))
    if port.params.word_bits == 64:
        same_buffers(exp, rabi.export_keyswitch_key(ref.rlk, mf_nbits, rring))
    back = abi.import_keyswitch_key(exp.struct, port.rlk.level, port.rlk.sp_level, mf_nbits,
                                    pring)
    assert torch.equal(back.key_q, port.rlk.key_q) and torch.equal(back.key_p, port.rlk.key_p)
    assert (back.level, back.sp_level) == (port.rlk.level, port.rlk.sp_level)

    gexp = abi.export_galois_keys(port.glk.keys, mf_nbits, pring)
    ref_g = {e: ref_key_export(k, mf_nbits, rring) for e, k in ref.glk.keys.items()}
    got = walk(gexp.struct)
    np.testing.assert_array_equal(got[0], sorted(ref_g))
    want = [b for e in sorted(ref_g) for b in walk(ref_g[e].struct)]
    assert len(got) == 1 + len(want)
    for g, w in zip(got[1:], want):
        np.testing.assert_array_equal(g, w)
    if port.params.word_bits == 64:
        same_buffers(gexp, rabi.export_galois_keys(ref.glk.keys, mf_nbits, rring))
    gback = abi.import_galois_keys(gexp.struct, port.rlk.level, port.rlk.sp_level, mf_nbits,
                                   pring)
    assert sorted(gback) == sorted(port.glk.keys)
    for e, k in gback.items():
        assert torch.equal(k.key_q, port.glk.keys[e].key_q)
        assert torch.equal(k.key_p, port.glk.keys[e].key_p)


def test_plain_exchange_needs_the_ring(pair):
    _, port, _, _ = pair
    with pytest.raises(ValueError, match='mf_nbits=0 needs the Q∪P ring'):
        abi.export_keyswitch_key(port.rlk, 0)
    exp = abi.export_keyswitch_key(port.rlk, 64)
    with pytest.raises(ValueError, match='mf_nbits=0 needs the Q∪P ring'):
        abi.import_keyswitch_key(exp.struct, port.rlk.level, port.rlk.sp_level, 0, device='cpu')
