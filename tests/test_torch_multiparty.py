"""lattisense_torch's threshold BFV held against lattisense_tpu's.

Three parties of the same seeds run every protocol in both packages, at
n=64, t=65537, on both words (the primes of ``tests/test_multiparty.py``):
each share equals the JAX share bit for bit and serializes to the same
bytes, a blob written by either package is read by the other, and the
collective public, relinearization and Galois keys are equal. The port's
``mult`` + ``relinearize`` and ``rotate_cols`` with those keys equal the JAX
engine's, and the JAX file's five end-to-end checks hold on the port. The
slice as a whole: the batched step with the collective keys on a 31-bit
chain at n=1024, B=2, decrypted by E2S.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.schemes import keys as ref_keys
from lattisense_tpu.schemes import multiparty as rmp
from lattisense_tpu.schemes.bfv import BfvEngine as RefBfvEngine
from lattisense_tpu.schemes.keys import SecretKey as RefSecretKey

from lattisense_torch.params import BfvParams
from lattisense_torch.parallel.batch import bfv_mult_relin, make_batched_step, make_rotate_step
from lattisense_torch.schemes import keys as port_keys
from lattisense_torch.schemes import multiparty as mp
from lattisense_torch.schemes.bfv import BfvEngine
from lattisense_torch.schemes.galois import galois_elt_col
from lattisense_torch.schemes.keys import SecretKey
from lattisense_torch.schemes.types import Ciphertext

N, T, PARTIES = 64, 65537, 3
SHARES = [mp.PublicKeyShare, mp.RelinKeyShareRound1, mp.RelinKeyShareRound2,
          mp.GaloisKeyShare, mp.DecryptionShare, mp.EncryptionShare, mp.RefreshShare]


def A(x):
    return x.cpu().numpy().view(np.uint64) if isinstance(x, torch.Tensor) else np.asarray(
        x).astype(np.uint64)


def chain(word, n=N):
    """The q and p primes of the JAX multiparty tests for ``word``."""
    if word == 64:
        q = gen_ntt_primes(n, 50, 3)
        return q, gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    primes = gen_ntt_primes(n, 31, 8)
    return primes[:6], primes[6:8]


class Side:
    """One package's parameters, engine, parties and joint secret."""

    def __init__(self, ref: bool, word: int, q, p, n=N):
        if ref:
            self.params = RefBfvParams.create_custom(n, T, q, p, word_bits=word)
            self.eng = RefBfvEngine(self.params)
            self.parties = [rmp.DBfvParty(self.params, seed=100 + i) for i in range(PARTIES)]
            self.joint = RefSecretKey(sum(x.sk.coeffs for x in self.parties))
        else:
            self.params = BfvParams.create_custom(n, T, q, p, word_bits=word)
            self.eng = BfvEngine(self.params, 'cpu')
            self.parties = [mp.DBfvParty(self.params, seed=100 + i, device='cpu')
                            for i in range(PARTIES)]
            self.joint = SecretKey(sum(x.sk.coeffs for x in self.parties))


@pytest.fixture(params=[64, 32], ids=['u64', 'w32'])
def sides(request):
    """Fresh JAX and port parties of the same seeds (their generators advance
    in step as long as both sides run the same protocol calls)."""
    q, p = chain(request.param)
    return Side(True, request.param, q, p), Side(False, request.param, q, p)


def same_share(ref_share, port_share):
    assert port_share.kind == ref_share.kind
    assert port_share.moduli == ref_share.moduli
    np.testing.assert_array_equal(A(port_share.data), ref_share.data)
    blob = port_share.serialize()
    assert blob == ref_share.serialize()
    return blob


def exchange(ref_shares, port_shares, cls, ref_cls):
    """Check each pair equal, then cross the wire: the port reads the JAX
    blobs and the JAX package the port's."""
    back_port, back_ref = [], []
    for r, s in zip(ref_shares, port_shares):
        blob = same_share(r, s)
        back_port.append(cls.deserialize(blob, device='cpu'))
        back_ref.append(ref_cls.deserialize(blob))
        np.testing.assert_array_equal(A(back_port[-1].data), r.data)
    return back_ref, back_port


def collective_pk(ref, port):
    ckg_r, ckg_p = rmp.CkgProtocol(ref.params, crp_seed=7), mp.CkgProtocol(port.params, 7,
                                                                           device='cpu')
    rs = [ckg_r.gen_share(x) for x in ref.parties]
    ps = [ckg_p.gen_share(x) for x in port.parties]
    back_ref, back_port = exchange(rs, ps, mp.PublicKeyShare, rmp.PublicKeyShare)
    pk_r, pk_p = ckg_r.aggregate(back_ref), ckg_p.aggregate(back_port)
    np.testing.assert_array_equal(A(pk_p.data), pk_r.data)
    return pk_r, pk_p


def collective_rlk(ref, port, crp_seed=11):
    rkg_r, rkg_p = rmp.RkgProtocol(ref.params, crp_seed), mp.RkgProtocol(port.params, crp_seed,
                                                                          device='cpu')
    r1r = [rkg_r.gen_share_round1(x) for x in ref.parties]
    r1p = [rkg_p.gen_share_round1(x) for x in port.parties]
    back_ref, back_port = exchange(r1r, r1p, mp.RelinKeyShareRound1, rmp.RelinKeyShareRound1)
    agg_r, agg_p = rkg_r.aggregate_round1(back_ref), rkg_p.aggregate_round1(back_port)
    np.testing.assert_array_equal(A(agg_p.data), agg_r.data)
    r2r = [rkg_r.gen_share_round2(x, agg_r) for x in ref.parties]
    r2p = [rkg_p.gen_share_round2(x, agg_p) for x in port.parties]
    back_ref, back_port = exchange(r2r, r2p, mp.RelinKeyShareRound2, rmp.RelinKeyShareRound2)
    rlk_r, rlk_p = rkg_r.aggregate_round2(back_ref, agg_r), rkg_p.aggregate_round2(back_port,
                                                                                   agg_p)
    same_key(rlk_r, rlk_p)
    return rlk_r, rlk_p


def collective_glk(ref, port, elt, crp_seed=13):
    rtg_r = rmp.RtgProtocol(ref.params, elt, crp_seed)
    rtg_p = mp.RtgProtocol(port.params, elt, crp_seed, device='cpu')
    back_ref, back_port = exchange([rtg_r.gen_share(x) for x in ref.parties],
                                   [rtg_p.gen_share(x) for x in port.parties],
                                   mp.GaloisKeyShare, rmp.GaloisKeyShare)
    glk_r, glk_p = rtg_r.aggregate(back_ref), rtg_p.aggregate(back_port)
    same_key(glk_r, glk_p)
    return glk_r, glk_p


def same_key(r, p):
    np.testing.assert_array_equal(A(p.key_q), r.key_q)
    np.testing.assert_array_equal(A(p.key_p), r.key_p)
    assert (p.level, p.sp_level) == (r.level, r.sp_level)


def encrypt_both(ref, port, pk_r, pk_p, m, level, seed):
    """The same asymmetric encryption in both packages (one NumPy seed)."""
    ct_r = ref.eng.encrypt_asymmetric(np.random.default_rng(seed), pk_r, ref.eng.encode(m, level))
    ct_p = port.eng.encrypt_asymmetric(np.random.default_rng(seed), pk_p,
                                       port.eng.encode(m, level))
    np.testing.assert_array_equal(A(ct_p.data), ct_r.data)
    return ct_r, ct_p


def test_ckg_joint_encrypt_decrypt(sides):
    ref, port = sides
    pk_r, pk_p = collective_pk(ref, port)
    m = np.random.default_rng(0).integers(0, T, N, dtype=np.uint64)
    _, ct = encrypt_both(ref, port, pk_r, pk_p, m, 2, seed=0)
    np.testing.assert_array_equal(port.eng.decrypt_decode(port.joint, ct), m)


def test_rkg_two_round(sides):
    ref, port = sides
    pk_r, pk_p = collective_pk(ref, port)
    rlk_r, rlk_p = collective_rlk(ref, port)
    rng = np.random.default_rng(1)
    ma = rng.integers(0, 256, N, dtype=np.uint64)
    mb = rng.integers(0, 256, N, dtype=np.uint64)
    a_r, a_p = encrypt_both(ref, port, pk_r, pk_p, ma, 2, seed=2)
    b_r, b_p = encrypt_both(ref, port, pk_r, pk_p, mb, 2, seed=3)
    prod_r = ref.eng.relinearize(np, ref.eng.mult(np, a_r, b_r), rlk_r)
    prod_p = port.eng.relinearize(port.eng.mult(a_p, b_p), rlk_p)
    np.testing.assert_array_equal(A(prod_p.data), prod_r.data)
    np.testing.assert_array_equal(port.eng.decrypt_decode(port.joint, prod_p),
                                  (ma.astype(object) * mb % T).astype(np.uint64))


def test_rtg_collective_rotation(sides):
    ref, port = sides
    pk_r, pk_p = collective_pk(ref, port)
    elt = galois_elt_col(2, N)
    glk_r, glk_p = collective_glk(ref, port, elt)
    m = np.random.default_rng(2).integers(0, T, N, dtype=np.uint64)
    ct_r, ct_p = encrypt_both(ref, port, pk_r, pk_p, m, 1, seed=4)
    rot_r = ref.eng.rotate_cols(np, ct_r, 2, glk_r)
    rot_p = port.eng.rotate_cols(ct_p, 2, glk_p)
    np.testing.assert_array_equal(A(rot_p.data), rot_r.data)
    np.testing.assert_array_equal(port.eng.decrypt_decode(port.joint, rot_p),
                                  np.roll(m.reshape(2, -1), -2, axis=1).reshape(-1))


def test_e2s_s2e_roundtrip(sides):
    ref, port = sides
    pk_r, pk_p = collective_pk(ref, port)
    m = np.random.default_rng(3).integers(0, T, N, dtype=np.uint64)
    ct_r, ct_p = encrypt_both(ref, port, pk_r, pk_p, m, 2, seed=5)

    e2s_r, e2s_p = rmp.E2sProtocol(ref.eng, level=2), mp.E2sProtocol(port.eng, level=2)
    out_r = [e2s_r.gen_share(x, ct_r) for x in ref.parties]
    out_p = [e2s_p.gen_share(x, ct_p) for x in port.parties]
    for (_, mk_r), (_, mk_p) in zip(out_r, out_p):
        np.testing.assert_array_equal(mk_p, mk_r)
    back_ref, back_port = exchange([s for s, _ in out_r], [s for s, _ in out_p],
                                   mp.DecryptionShare, rmp.DecryptionShare)
    residual = e2s_p.aggregate(ct_p, back_port)
    np.testing.assert_array_equal(residual, e2s_r.aggregate(ct_r, back_ref))
    total = residual.astype(np.int64)
    for _, mk in out_p:
        total = (total + mk.astype(np.int64)) % T
    np.testing.assert_array_equal(total.astype(np.uint64), m)

    s2e_r = rmp.S2eProtocol(ref.eng, level=2, crp_seed=17)
    s2e_p = mp.S2eProtocol(port.eng, level=2, crp_seed=17)
    back_ref, back_port = exchange(
        [s2e_r.gen_share(x, mk) for x, (_, mk) in zip(ref.parties, out_r)],
        [s2e_p.gen_share(x, mk) for x, (_, mk) in zip(port.parties, out_p)],
        mp.EncryptionShare, rmp.EncryptionShare)
    ct2_r = s2e_r.aggregate(back_ref, residual)
    ct2_p = s2e_p.aggregate(back_port, residual)
    np.testing.assert_array_equal(A(ct2_p.data), ct2_r.data)
    np.testing.assert_array_equal(port.eng.decrypt_decode(port.joint, ct2_p), m)


@pytest.mark.parametrize('permute', [False, True])
def test_collective_refresh(sides, permute):
    ref, port = sides
    pk_r, pk_p = collective_pk(ref, port)
    m = np.random.default_rng(4).integers(0, T, N, dtype=np.uint64)
    ct_r, ct_p = encrypt_both(ref, port, pk_r, pk_p, m, 2, seed=6)
    for _ in range(6):                                   # noise growth, as the JAX test
        ct_r, ct_p = ref.eng.add(np, ct_r, ct_r), port.eng.add(ct_p, ct_p)
        m = (m.astype(np.int64) * 2 % T).astype(np.uint64)
    perm = np.roll(np.arange(N), 5) if permute else None
    ref_r = rmp.RefreshProtocol(ref.eng, level=2, crp_seed=19, permutation=perm)
    ref_p = mp.RefreshProtocol(port.eng, level=2, crp_seed=19, permutation=perm)
    back_ref, back_port = exchange([ref_r.gen_share(x, ct_r) for x in ref.parties],
                                   [ref_p.gen_share(x, ct_p) for x in port.parties],
                                   mp.RefreshShare, rmp.RefreshShare)
    fresh_r, fresh_p = ref_r.finalize(ct_r, back_ref), ref_p.finalize(ct_p, back_port)
    np.testing.assert_array_equal(A(fresh_p.data), fresh_r.data)
    np.testing.assert_array_equal(port.eng.decrypt_decode(port.joint, fresh_p),
                                  m if perm is None else m[perm])


def test_share_classes_match_reference():
    """The seven share kinds, in name and tag; a blob of another kind is
    refused."""
    for cls in SHARES:
        assert getattr(rmp, cls.__name__).kind == cls.kind
    blob = mp.GaloisKeyShare(torch.zeros((1, 2, 64), dtype=torch.int64), (17, 97)).serialize()
    with pytest.raises(ValueError, match='expected rkg1 share, got rtg'):
        mp.RelinKeyShareRound1.deserialize(blob, device='cpu')


@pytest.mark.parametrize('word', [32, 64])
def test_smudging_lift_matches_reference(word):
    """A σ = 2^30 sample lifts exactly over 31-bit primes (and the 64-bit
    chain): ``np.mod``, not one +q re-centre."""
    q = gen_ntt_primes(N, 31, 6) if word == 32 else chain(64)[0]
    e = port_keys.sample_gaussian(np.random.default_rng(9), 4096, sigma=2.0 ** 30)
    assert np.abs(e).max() > max(q) or word == 64
    got = port_keys.lift_signed(e, q)
    np.testing.assert_array_equal(got.astype(np.uint64), ref_keys.lift_signed(e, q, word))
    for i, qi in enumerate(q):
        np.testing.assert_array_equal(got[i], np.mod(e, qi))


def test_batched_step_with_collective_keys_decrypted_by_e2s():
    """The slice as a whole on a 31-bit chain at n=1024, B=2: collective
    keys, the batched mult_relin and rotate_col (each element equal to the
    JAX engine's step), then threshold decryption by E2S."""
    n, level, batch = 1024, 5, 2
    q, p = chain(32, n)
    ref, port = Side(True, 32, q, p, n), Side(False, 32, q, p, n)
    pk_r, pk_p = collective_pk(ref, port)
    rlk_r, rlk_p = collective_rlk(ref, port)
    elt = galois_elt_col(1, n)
    glk_r, glk_p = collective_glk(ref, port, elt)
    rng = np.random.default_rng(5)
    msgs = rng.integers(0, T, (2 * batch, n), dtype=np.uint64)
    cts = [encrypt_both(ref, port, pk_r, pk_p, m, level, seed=20 + i) for i, m in enumerate(msgs)]
    a = torch.stack([c.data for _, c in cts[:batch]])
    b = torch.stack([c.data for _, c in cts[batch:]])
    mult = make_batched_step(port.eng, bfv_mult_relin, level)(a, b, {'rlk': rlk_p})
    rot = make_batched_step(port.eng, make_rotate_step(elt), level, n_inputs=1)(
        a, {'glk': {elt: glk_p}})
    e2s = mp.E2sProtocol(port.eng, level)
    for i in range(batch):
        want_m = ref.eng.relinearize(np, ref.eng.mult(np, cts[i][0], cts[batch + i][0]), rlk_r)
        want_r = ref.eng.apply_galois(np, cts[i][0], elt, glk_r)
        np.testing.assert_array_equal(A(mult[i]), want_m.data)
        np.testing.assert_array_equal(A(rot[i]), want_r.data)
        for out, expect in ((mult[i], msgs[i] * msgs[batch + i] % T),
                            (rot[i], np.roll(msgs[i].reshape(2, -1), -1, axis=1).reshape(-1))):
            ct = Ciphertext(data=out, level=level)
            shares, masks = zip(*[e2s.gen_share(x, ct) for x in port.parties])
            total = e2s.aggregate(ct, list(shares)).astype(np.int64)
            for mk in masks:
                total = (total + mk.astype(np.int64)) % T
            np.testing.assert_array_equal(total.astype(np.uint64), expect)
