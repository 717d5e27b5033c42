"""Kernels B2 (the BEHZ prep, ``csrc/behz32.cu``) and B6 (the u64 base
conversion, ``csrc/bconv64.cu``) walked on the CPU, and the port's default
machine word.

A CUDA kernel has no CPU mode, but what it computes does not need the card.

- B2: ``walk_prep`` extends x as the extension kernel does, from the uint32
  constant block it is handed, into a 32-bit scratch, then runs kernel B1's
  forward passes (``walk`` of ``test_torch_ntt_schedule``) over the joint
  stack of each polynomial's L x rows and T scratch rows, row k on limb k of
  the joint ring q ∪ aux (``behz_cuda.prep_ring``), ending with the
  to-Montgomery epilogue. It is held bit for bit against ``behz_prep_plain``
  and the JAX package's ``behz_prep32`` in interpret mode.
- B6: ``lazy_bconv`` sums the L 128-bit products of each output in exact
  integers cut to the kernel's two 64-bit words, folds the high word past
  ``lazy_fold`` terms, and makes one Montgomery reduction, asserting at each
  reduction the bound it relies on. It is held against ``bconv64_plain`` and
  the JAX ``bconv_convert_fused`` / ``bconv_raw_fused``, with all-(q-1)
  residues, at the edge L·ymax = 2^64 and just past it.
- The word: the port's ``BfvParams``, ``create_custom`` and
  ``bfv_aux_basis`` default to the reference's 64-bit word, and the
  reference's keys made with its default word go through the port's
  ``mult_relin`` and decrypt right.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.core.rns import BasisConv as RefBasisConv
from lattisense_tpu.ops import bconv_pallas
from lattisense_tpu.ops.behz_pallas32 import behz_prep32 as ref_behz_prep32
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.params import bfv_aux_basis as ref_aux_basis
from lattisense_tpu.runtime import BfvContext as RefContext

from lattisense_torch.core import u64 as tu
from lattisense_torch.core.rns import BasisConv
from lattisense_torch.ops import bconv_cuda, behz_cuda, ntt_cuda
from lattisense_torch.params import BfvParams, bfv_aux_basis
from lattisense_torch.parallel.batch import bfv_mult_relin, key_tree, make_batched_step
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes.bfv import BfvEngine
from lattisense_torch.schemes.types import Ciphertext
from tests.test_torch_ntt_schedule import walk

CPU = torch.device('cpu')
M32 = tu.MASK32
M64 = (1 << 64) - 1


def T64(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.uint64)).view(np.int64))


def A64(t):
    return t.cpu().numpy().view(np.uint64)


def residues(seed, moduli, n, lead=()):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, (*lead, n), dtype=np.uint64) for q in moduli], axis=-2)


# ---------------------------------------------------------------------------
# the port's default word
# ---------------------------------------------------------------------------

def test_default_word_is_the_reference_default():
    chain = ref_primes(256, 31, 7)
    q, p = chain[:5], chain[5:]
    for port, ref in ((BfvParams(256, 65537, q, p), RefBfvParams(256, 65537, q, p)),
                      (BfvParams.create_custom(256, 65537, q, p),
                       RefBfvParams.create_custom(256, 65537, q, p))):
        assert port.word_bits == ref.word_bits == 64
    assert bfv_aux_basis(256, tuple(q), tuple(p)) == ref_aux_basis(256, tuple(q), tuple(p))
    assert bfv_aux_basis(256, tuple(q), tuple(p)) == bfv_aux_basis(256, tuple(q), tuple(p), 64)
    assert BfvParams.create_tpu_param(4096).word_bits == \
        RefBfvParams.create_tpu_param(4096).word_bits == 32
    assert BfvParams.create(4096).word_bits == RefBfvParams.create(4096).word_bits == 64


def test_reference_default_word_keys_decrypt_through_port_mult_relin():
    """n = 256, t = 65537, 5 + 2 31-bit primes, seed 3, both sides on their
    default word: the reference's keys (NTT + Montgomery with R = 2^64) in
    the port's context, the port's mult_relin, batched and single."""
    n, t, level, seed = 256, 65537, 4, 3
    chain = ref_primes(n, 31, 7)
    q, p = chain[:5], chain[5:]
    ref = RefContext.create_random_context(RefBfvParams.create_custom(n, t, q, p), seed=seed)
    port = BfvContext.from_arrays(BfvParams.create_custom(n, t, q, p), ref.sk.coeffs,
                                  ref.pk.data, ref.rlk.key_q, ref.rlk.key_p, device='cpu')
    assert port.params.word_bits == ref.params.word_bits == 64
    rng = np.random.default_rng(seed)
    ma, mb = rng.integers(0, t, (2, 2, n))
    cas = [ref.encrypt(ref.encode(m, level)) for m in ma]
    cbs = [ref.encrypt(ref.encode(m, level)) for m in mb]
    out = make_batched_step(port.engine, bfv_mult_relin, level)(
        T64(np.stack([c.data for c in cas])), T64(np.stack([c.data for c in cbs])), key_tree(port))
    eng = ref.engine
    for i in range(2):
        want = eng.relinearize(np, eng.mult(np, cas[i], cbs[i]), ref.rlk)
        assert np.array_equal(A64(out[i]), np.asarray(want.data, dtype=np.uint64)), i
        got = Ciphertext(data=out[i], level=level)
        assert np.array_equal(port.decrypt_decode(got), (ma[i] * mb[i]) % t), i
    one = port.mult_relin(Ciphertext(data=T64(cas[0].data), level=level),
                          Ciphertext(data=T64(cbs[0].data), level=level))
    assert np.array_equal(port.decrypt_decode(one), (ma[0] * mb[0]) % t)


# ---------------------------------------------------------------------------
# B2: the extension into 32-bit scratch and the joint row stack
# ---------------------------------------------------------------------------

def sh(a, w, ws, q):
    """The kernels' Shoup product on uint32 words: canonical for any a < 2^32."""
    r = (a * w - tu.mulhi(a, ws) * q) & M32
    return torch.where(r >= q, r - q, r)


def extend32(x, bz):
    """The extension kernel on an int64 (..., L, n) stack, from its uint32
    constant block (layout in csrc/behz32.cu): the uint32 (..., T, n)
    scratch, as int32 bits."""
    L, T = len(bz.ring_q.moduli), len(bz.ring_aux.moduli)
    c = behz_cuda._consts(bz).long() & M32
    edge = np.cumsum([0, L, L, L, L, L, L, T, T, T, T, T, L * T, L * T, 1]).tolist()
    q, mt, mts, qhi, qhis, qmt, d, qm, qms, mti, mtis, cv, cs, nq = (
        c[a:b] for a, b in zip(edge, edge[1:]))
    assert edge[-1] == len(c)
    mtilde = 1 << 16
    y = [sh(sh(x[..., i, :], mt[i], mts[i], q[i]), qhi[i], qhis[i], q[i]) for i in range(L)]
    e = sum((yi & (mtilde - 1)) * qmt[i] for i, yi in enumerate(y)) & M32   # wraps mod 2^32
    r = ((e & (mtilde - 1)) * nq[0]) & (mtilde - 1)
    rows = []
    for t in range(T):
        acc = torch.zeros_like(r)
        for i in range(L):
            acc = (acc + sh(y[i], cv[i * T + t], cs[i * T + t], d[t])) % d[t]
        rm = torch.where(r >= mtilde // 2, d[t] - (mtilde - r), r)
        s = (acc + sh(rm, qm[t], qms[t], d[t])) % d[t]
        rows.append(sh(s, mti[t], mtis[t], d[t]))
    out = torch.stack(rows, dim=-2)
    assert int(out.max()) < 1 << 31
    return out.to(torch.int32)


def walk_prep(x, bz):
    """B2's two launches on a CPU stack: the extension into the 32-bit
    scratch, then B1's forward row loop over the joint (L + T)-row stack of
    every polynomial with the joint ring's to-Montgomery epilogue."""
    L = len(bz.ring_q.moduli)
    ext = extend32(x, bz)
    joint = behz_cuda.prep_ring(bz)
    assert joint.moduli == bz.ring_q.moduli + bz.ring_aux.moduli
    tabs = ntt_cuda._tables(joint)
    post = ((tabs['r1'].long() & M32).reshape(-1, 1), (tabs['r1_shoup'].long() & M32).reshape(-1, 1))
    rows = torch.cat([x, ext.long() & M32], dim=-2)
    out = walk(rows, joint, inverse=False, post=post)
    return out[..., :L, :], out[..., L:, :]


@pytest.mark.parametrize('n,level', [(256, 2), (1024, 4)])
def test_walk_prep_matches_plain_and_pallas(n, level):
    chain = ref_primes(n, 31, 6)
    q, p = chain[:5], chain[5:]
    bz = BfvEngine(BfvParams.create_custom(n, 257, q, p, word_bits=32), CPU).behz(level)
    ref_bz = RefContext.create_random_context(
        RefBfvParams.create_custom(n, 257, q, p, word_bits=32), seed=13).engine.behz(level)
    assert bz.ring_aux.moduli == ref_bz.ring_aux.moduli
    x = residues(n + level, q[:level + 1], n, (2,)).astype(np.int64)
    fq, fa = walk_prep(torch.from_numpy(x), bz)
    want_fq, want_fa = behz_cuda.behz_prep_plain(torch.from_numpy(x), bz)
    assert torch.equal(fq, want_fq) and torch.equal(fa, want_fa)
    ref_fq, ref_fa = ref_behz_prep32(jnp.asarray(x.astype(np.uint32)), ref_bz)
    assert np.array_equal(fq.numpy(), np.asarray(ref_fq).astype(np.int64))
    assert np.array_equal(fa.numpy(), np.asarray(ref_fa).astype(np.int64))


def test_walk_prep_all_top_residues_and_headline_shape():
    """x = q - 1 everywhere, and the main path's chain at level 7 (L = 8)
    cut to n = 256, where its primes are NTT primes too (T = 10 here, 11 at
    n = 16384: the aux basis grows with n)."""
    full = BfvParams.create_tpu_param(16384)
    params = BfvParams.create_custom(256, full.t, full.q, full.p, word_bits=32)
    bz = BfvEngine(params, CPU).behz(7)
    assert (len(bz.ring_q.moduli), len(bz.ring_aux.moduli)) == (8, 10)
    x = (bz.ring_q.q - 1).expand(3, 8, 256).contiguous()
    x[1] = torch.from_numpy(residues(1, bz.ring_q.moduli, 256).astype(np.int64))
    got, want = walk_prep(x, bz), behz_cuda.behz_prep_plain(x, bz)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# B6: lazy accumulation and the fold
# ---------------------------------------------------------------------------

def lazy_bconv(y, C, d, pinv, fold):
    """B6's kernel on a uint64 (..., L, n) array with Python integers: the
    128-bit sum of each output as two 64-bit words, folded (d off the high
    word when it reaches d) after each term past the first ``fold``, then one
    REDC, whose input must be below d·2^64. C (T, L) or, with y
    (..., G, L, n), (G, T, L)."""
    y = np.asarray(y, dtype=np.uint64)
    C = np.asarray(C, dtype=np.uint64)
    grouped = C.ndim == 3
    cg = C if grouped else C[None]
    yg = y if grouped else y[..., None, :, :]
    L, n = yg.shape[-2:]
    Tn = cg.shape[1]
    out = np.zeros((*yg.shape[:-2], Tn, n), dtype=np.uint64)
    for idx in np.ndindex(*yg.shape[:-2]):
        g = idx[-1]
        for t in range(Tn):
            q, pv = int(d[t]), int(pinv[t])
            for i in range(n):
                hi = lo = 0
                for l in range(L):
                    prod = int(yg[idx][l, i]) * int(cg[g, t, l])
                    lo += prod & M64
                    hi = (hi + (prod >> 64) + (lo >> 64)) & M64
                    lo &= M64
                    if l >= fold:
                        assert hi < 2 * q
                        hi = hi - q if hi >= q else hi
                assert hi < q                        # the sum is below d·2^64
                m = (lo * pv) & M64
                r = hi + ((m * q) >> 64) + (lo != 0)
                assert r < 2 * q
                out[idx + (t, i)] = r - q if r >= q else r
    return out if grouped else out[..., 0, :, :]


def exact_bconv(y, C, d):
    """Σ_l y_l·C_l·2^-64 mod d_t with Python integers, for C (T, L)."""
    y = np.asarray(y, dtype=np.uint64)
    out = np.zeros((*y.shape[:-2], len(d), y.shape[-1]), dtype=np.uint64)
    for idx in np.ndindex(*y.shape[:-2]):
        for t, q in enumerate(d):
            rinv = pow(1 << 64, -1, int(q))
            for i in range(y.shape[-1]):
                s = sum(int(y[idx][l, i]) * int(C[t][l]) for l in range(y.shape[-2]))
                out[idx + (t, i)] = s * rinv % int(q)
    return out


def conv_consts(conv):
    return (A64(conv.qhat_dst_mont), A64(conv.dst_q).reshape(-1), A64(conv.dst_pinv).reshape(-1))


def test_lazy_fold_bounds():
    assert bconv_cuda.lazy_fold(4, (1 << 57) - 1) == 4
    assert bconv_cuda.lazy_fold(32, (1 << 59) - 1) == 32           # 32·(2^59 - 1) < 2^64
    assert bconv_cuda.lazy_fold(6, bconv_cuda.WORD_GUARD) == 4      # 4·(2^62 - 1) < 2^64
    assert bconv_cuda.lazy_fold(5, 1 << 62) == 4                    # 4·2^62 = 2^64, the edge
    assert bconv_cuda.lazy_fold(3, M64) == 1
    for L, ymax in ((4, 1 << 62), (9, (1 << 61) - 1), (6, bconv_cuda.WORD_GUARD)):
        f = bconv_cuda.lazy_fold(L, ymax)
        assert f * ymax <= 1 << 64 and (f == L or (f + 1) * ymax > 1 << 64)


@pytest.mark.parametrize('bits,L,T', [(57, 4, 6), (59, 5, 5), (55, 2, 4), (61, 10, 3)],
                         ids=['extend', 'shenoy', 'round_div_p', 'fold'])
def test_lazy_convert_matches_plain_and_pallas(bits, L, T):
    """The convert shapes of the u64 path (all terms lazy) and ten 61-bit
    sources (a fold past the eighth term), on random decomposed residues and
    on all-(q - 1) residues, against the plain twin and exact integers; the
    fold case against the JAX kernel too (the plain twin is held against it
    at the path's shapes in ``test_torch_kernels64.py``)."""
    n = 64
    src = tuple(ref_primes(n, bits, L))
    dst = tuple(ref_primes(n, 59 if bits != 59 else 57, T, exclude=src))
    ref, port = RefBasisConv(src, dst), BasisConv(src, dst, CPU, 64)
    C, d, pinv = conv_consts(port)
    fold = bconv_cuda.lazy_fold(L, max(src) - 1)
    assert (fold == L) == (bits != 61)
    y = ref.decompose(np, residues(bits + L, src, n, (2,)))
    top = np.broadcast_to(np.asarray(src, dtype=np.uint64).reshape(-1, 1) - 1, (1, L, n))
    for yy in (y, top):
        want = A64(bconv_cuda.bconv64_plain(T64(yy), T64(C), T64(d), T64(pinv)))
        assert np.array_equal(lazy_bconv(yy, C, d, pinv, fold), want)
        assert np.array_equal(exact_bconv(yy, C, d), want)
    if fold < L:        # the JAX kernel, once: each new shape costs ~12 s to trace here
        assert np.array_equal(np.asarray(bconv_pallas.bconv_convert_fused(jnp.asarray(y), ref)),
                              lazy_bconv(y, C, d, pinv, fold))


def test_lazy_raw_grouped_matches_plain_and_pallas():
    """The key switch's mod-up shape: β = 2 digits of α = 2 limbs, 6 rows of
    q ∪ p out, each digit its own constants, residues below the word's
    guard."""
    from lattisense_tpu.schemes.keyswitch import KeySwitcher as RefKeySwitcher
    from lattisense_torch.schemes.keyswitch import KeySwitcher
    n, level = 64, 3
    chain = ref_primes(n, 57, 4) + ref_primes(n, 55, 2)
    q, p = tuple(chain[:4]), tuple(chain[4:])
    ref_sw, port = RefKeySwitcher(q, p, n), KeySwitcher(q, p, n, CPU, 64)
    _, _, _, _, qhat_conv, _ = port._level_pre(level)
    ring = port.ring_qp(level)
    C, d, pinv = A64(qhat_conv), A64(ring.q).reshape(-1), A64(ring.pinv).reshape(-1)
    fold = bconv_cuda.lazy_fold(2, bconv_cuda.WORD_GUARD)
    assert fold == 2
    y = residues(7, q, n, (2,)).reshape(2, 2, 2, n)
    got = lazy_bconv(y, C, d, pinv, fold)
    assert np.array_equal(got, A64(bconv_cuda.bconv64_raw(T64(y), T64(C), ring.q, ring.pinv)))
    consts = ref_sw._modup_consts(level)
    want = np.stack([np.asarray(bconv_pallas.bconv_raw_fused(jnp.asarray(y[:, g]), ch, cl, qd,
                                                             6, 2))
                     for g, (ch, cl, qd) in enumerate(consts)], axis=1)
    assert np.array_equal(got, want)


def test_lazy_sum_at_the_edge_and_the_fold_past_it():
    """y = 2^62 in every limb and C = d - 1: four terms make exactly
    4·2^62·(d - 1) < d·2^64 (the edge, no fold); a fifth passes d·2^64,
    which only the fold keeps exact. At the word's guard (y = 2^62 - 1), six
    terms fold past the fourth."""
    d = [p for p in ref_primes(64, 61, 2)]
    pinv = [(-pow(q, -1, 1 << 64)) % (1 << 64) for q in d]
    n = 4
    for L, ymax in ((4, 1 << 62), (5, 1 << 62), (6, bconv_cuda.WORD_GUARD)):
        C = np.array([[q - 1] * L for q in d], dtype=np.uint64)
        y = np.full((2, L, n), ymax, dtype=np.uint64)
        y[1, :, 1:] = residues(L, [ymax + 1] * L, n - 1)
        fold = bconv_cuda.lazy_fold(L, ymax)
        want = exact_bconv(y, C, d)
        assert np.array_equal(lazy_bconv(y, C, d, pinv, fold), want)
        assert np.array_equal(A64(bconv_cuda.bconv64_plain(T64(y), T64(C), T64(d), T64(pinv))),
                              want)
        if fold < L:                 # without the fold the sum passes d·2^64
            with pytest.raises(AssertionError):
                lazy_bconv(y[:1, :, :1], C, d, pinv, L)
