"""The 64-bit word of lattisense_torch (word arithmetic, ring tables, the RNS
toolbox, RoundDivP's float64 overflow estimate, the word guards) held bit
for bit against Python integers and lattisense_tpu's NumPy path.

Residues and 64-bit constants travel as int64 tensors holding the u64 bit
patterns; the helpers below convert from and to the reference's uint64
arrays without changing a bit. The tolerance is zero throughout.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lattisense_tpu.core import ntt as ref_ntt
from lattisense_tpu.core import rns as ref_rns
from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.core.modring import get_rns_ring as ref_ring
from lattisense_tpu.schemes.keyswitch import KeySwitcher as RefKeySwitcher
from lattisense_tpu.schemes.keyswitch import RoundDivP as RefRoundDivP

from lattisense_torch.core import ntt as tntt
from lattisense_torch.core import rns as trns
from lattisense_torch.core import u64 as tu
from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_torch.ops import behz_cuda, ksw_cuda, ntt_cuda
from lattisense_torch.params import BfvParams
from lattisense_torch.schemes.bfv import BfvEngine
from lattisense_torch.schemes.keyswitch import KeySwitcher, RoundDivP
from lattisense_torch.schemes.types import KeySwitchKey

CPU = torch.device('cpu')
M64 = 1 << 64


def T(a):
    """uint64 (or any integer) NumPy array → int64 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.uint64)).view(np.int64))


def A(t):
    """int64 tensor → uint64 array of the same bits."""
    return t.cpu().numpy().view(np.uint64)


def ints(t):
    return [int(v) for v in A(t).ravel()]


def residues(rng, moduli, n, lead=()):
    return np.stack([rng.integers(0, q, (*lead, n), dtype=np.uint64) for q in moduli], axis=-2)


def prime(bits: int) -> int:
    return ref_primes(1024, bits, 1)[0]


# ---------------------------------------------------------------------------
# core/u64 at the 64-bit word, against Python integers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('bits', [40, 55, 59, 61])
def test_word64_ops_match_python_integers(bits):
    p = prime(bits)
    R = 1 << 64
    pinv = (-pow(p, -1, R)) % R
    r2 = R * R % p
    rng = np.random.default_rng(bits)
    a = [int(v) for v in rng.integers(0, p, 2000, dtype=np.uint64)] + [0, 1, p - 1, p - 1, 0]
    b = [int(v) for v in rng.integers(0, p, 2000, dtype=np.uint64)] + [p - 1, 0, p - 1, 1, 0]
    ta, tb = T(np.array(a, dtype=np.uint64)), T(np.array(b, dtype=np.uint64))
    tp, tpinv, tr2 = T([p]), T([pinv]), T([r2])
    assert pinv >= 1 << 63 or ints(tpinv)[0] == pinv        # bit pattern, may read negative
    rinv = pow(R, -1, p)
    assert ints(tu.mulhi64(ta, tb)) == [x * y >> 64 for x, y in zip(a, b)]
    assert ints(tu.mont_mul64(ta, tb, tp, tpinv)) == [x * y * rinv % p for x, y in zip(a, b)]
    assert ints(tu.mulmod64(ta, tb, tp, tpinv, tr2)) == [x * y % p for x, y in zip(a, b)]
    assert ints(tu.to_mont64(ta, tp, tpinv, tr2)) == [x * R % p for x in a]
    assert ints(tu.from_mont64(ta, tp, tpinv)) == [x * rinv % p for x in a]
    hi = [x * y >> 64 for x, y in zip(a, b)]
    lo = [x * y % R for x, y in zip(a, b)]
    assert ints(tu.redc64(T(np.array(hi, dtype=np.uint64)), T(np.array(lo, dtype=np.uint64)),
                          tp, tpinv)) == [x * y * rinv % p for x, y in zip(a, b)]
    # Shoup companions reach 2^64 - 1 territory; w = p - 1 gives the largest
    for w in (1, 2, p - 1, int(rng.integers(0, p))):
        ws = (w << 64) // p
        got = tu.shoup_mul64(ta, T([w]), T([ws]), tp)
        assert ints(got) == [x * w % p for x in a], w
    # the high word of full-width patterns (pinv·m products reach 2^64 - 1)
    full = np.array([M64 - 1, M64 - 2, 1 << 63, pinv, 0], dtype=np.uint64)
    assert ints(tu.mulhi64(T(full), T(full[::-1].copy()))) == \
        [int(x) * int(y) >> 64 for x, y in zip(full, full[::-1])]
    x = np.stack([np.array(a[:50], dtype=np.uint64)] * 3)
    assert ints(tu.modsum64(T(x), tp, 0)) == [3 * v % p for v in a[:50]]


def test_word_namespaces_and_guards():
    assert tu.word(32) is tu.W32 and tu.word(64) is tu.W64
    assert tu.W64.mont_mul is tu.mont_mul64 and tu.W32.mont_mul is tu.mont_mul
    with pytest.raises(ValueError):
        tu.word(16)


# ---------------------------------------------------------------------------
# params / core/modring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [4096, 16384])
def test_ring_tables_word64_match_reference(n):
    chain = tuple(ref_primes(n, 61, 1) + ref_primes(n, 55, 1))
    ring, ref = get_rns_ring(chain, n, CPU, 64), ref_ring(chain, n, 64)
    assert ring.word_bits == 64 and ring.word is tu.W64
    for attr in ('q', 'pinv', 'r1', 'r2', 'n_inv', 'n_inv_shoup', 'psi_rev',
                 'psi_rev_shoup', 'psi_inv_rev', 'psi_inv_rev_shoup'):
        assert np.array_equal(A(getattr(ring, attr)), np.asarray(getattr(ref, attr))), attr
    # the cache is keyed by the word: the same primes below 2^31 give two rings
    small = tuple(gen_ntt_primes(n, 31, 2))
    assert get_rns_ring(small, n, CPU, 64) is not get_rns_ring(small, n, CPU, 32)
    assert get_rns_ring(small, n, CPU, 64).word_bits == 64
    with pytest.raises(ValueError, match='too large'):
        get_rns_ring(chain, n, CPU, 32)


def test_ntt_plain_word64_matches_reference():
    n = 1024
    chain = tuple(ref_primes(n, 61, 2) + ref_primes(n, 57, 1))
    ring, ref = get_rns_ring(chain, n, CPU, 64), ref_ring(chain, n, 64)
    x = residues(np.random.default_rng(2), chain, n, (2,))
    want = ref_ntt.ntt(np, x, ref)
    got = tntt.ntt(T(x), ring)
    assert np.array_equal(A(got), want)
    assert np.array_equal(A(tntt.intt(got, ring)), ref_ntt.intt(np, want, ref))
    assert np.array_equal(A(tntt.intt(got, ring)), x)


# ---------------------------------------------------------------------------
# core/rns at the 64-bit word
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def rns64():
    n = 256
    primes = ref_primes(n, 59, 6) + ref_primes(n, 55, 4)
    return n, tuple(primes[:4]), tuple(primes[4:9]), primes[9]


def test_rns_word64_matches_reference(rns64):
    n, src, dst, m_sk = rns64
    rng = np.random.default_rng(3)
    x = residues(rng, src, n, (2,))
    ref, port = ref_rns.BasisConv(src, dst, 64), trns.BasisConv(src, dst, CPU, 64)
    y = ref.decompose(np, x)
    assert np.array_equal(A(port.decompose(T(x))), y)
    assert np.array_equal(A(port.convert(T(y))), ref.convert(np, y))
    assert np.array_equal(A(port.convert(T(y), plain=True)), ref.convert(np, y))
    assert np.array_equal(A(port.convert_mtilde(T(y))), ref.convert_mtilde(np, y))
    full = dst + (m_sk,)
    ee, pe = ref_rns.ExactExtend(src, full, 64), trns.ExactExtend(src, full, CPU, 64)
    assert np.array_equal(A(pe(T(x))), ee(np, x))
    xb = residues(rng, dst, n, (2,))
    xsk = rng.integers(0, m_sk, (2, n), dtype=np.uint64)
    rs, ps = ref_rns.ShenoyConvert(dst, m_sk, src, 64), trns.ShenoyConvert(dst, m_sk, src, CPU, 64)
    assert np.array_equal(A(ps(T(xb), T(xsk))), rs(np, xb, xsk))
    xr = residues(rng, src, n, (2, 3))
    rd, pd = ref_rns.DivRoundLast(src, 64), trns.DivRoundLast(src, CPU, 64)
    assert np.array_equal(A(pd(T(xr))), rd(np, xr))


# ---------------------------------------------------------------------------
# RoundDivP: the float64 overflow estimate
# ---------------------------------------------------------------------------

def _near_integer_digits(p, n, rng):
    """Digits y_j in [0, p_j) whose float sum Σ y_j/p_j sits within 2^-40 of
    an integer k: pick y_0.. y_{α-2} at random, then solve for the last
    digit so that the exact sum is k ± ε with ε below 2^-40."""
    alpha = len(p)
    rows = []
    for i in range(n):
        ys = [int(rng.integers(0, pj)) for pj in p[:-1]]
        part = sum(y / pj for y, pj in zip(ys, p))
        k = math.ceil(part)
        # y_last / p_last ≈ k - part, nudged by at most 2^-40 either way
        eps = (i % 5 - 2) * 2.0 ** -42
        last = int(round((k - part + eps) * p[-1]))
        rows.append(ys + [min(max(last, 0), p[-1] - 1)])
    assert len(rows[0]) == alpha
    return np.array(rows, dtype=np.uint64).T.copy()            # (α, n)


@pytest.mark.parametrize('alpha', [2, 3])
def test_round_div_p_word64_matches_reference(alpha):
    n = 256
    primes = ref_primes(n, 56, 4) + ref_primes(n, 55, alpha)
    q, p = tuple(primes[:4]), tuple(primes[4:])
    rng = np.random.default_rng(alpha)
    ref, port = RefRoundDivP(q, p, 64), RoundDivP(q, p, CPU, 64)
    y = np.concatenate([residues(rng, p, n, (2,)),
                        _near_integer_digits(p, n, rng)[None]], axis=0)   # (3, α, n)
    fsum = sum(y[:, j, :].astype(np.float64) / p[j] for j in range(alpha))
    assert np.min(np.abs(fsum[2] - np.round(fsum[2]))) < 2.0 ** -40
    assert np.array_equal(A(port.overflow(T(y))), ref.overflow(np, y))
    xq, xp = residues(rng, q, n, (2,)), residues(rng, p, n, (2,))
    assert np.array_equal(A(port(T(xq), T(xp))), ref(np, xq, xp))
    assert np.array_equal(A(port(T(xq), T(xp), plain=True)), ref(np, xq, xp))


@pytest.mark.parametrize('levels', [(3, 2, 1)], ids=['alpha2-ragged'])
def test_keyswitch_word64_matches_reference(levels):
    n = 256
    chain = ref_primes(n, 57, 4) + ref_primes(n, 55, 2)
    q, p = tuple(chain[:4]), tuple(chain[4:])
    rng = np.random.default_rng(9)
    beta = 2
    kq = residues(rng, q, n, (beta, 2))
    kp = residues(rng, p, n, (beta, 2))
    ref_key = SimpleNamespace(key_q=kq, key_p=kp)
    ref_sw, port = RefKeySwitcher(q, p, n, 64), KeySwitcher(q, p, n, CPU, 64)
    ksk = KeySwitchKey(key_q=T(kq), key_p=T(kp))
    for level in levels:
        x = residues(rng, q[:level + 1], n, (2,))
        for output_ntt in (False, True):
            want = ref_sw.switch(np, x, ref_key, level, output_ntt=output_ntt)
            got = port.switch(T(x), ksk, level, output_ntt=output_ntt)
            assert np.array_equal(A(got[0]), want[0]), (level, output_ntt)
            assert np.array_equal(A(got[1]), want[1]), (level, output_ntt)


# ---------------------------------------------------------------------------
# dispatch guards: a 32-bit function handed a 64-bit holder raises
# ---------------------------------------------------------------------------

def test_32bit_functions_refuse_64bit_holders():
    from lattisense_torch.ops import bconv_cuda, ksw64_cuda, ntt64_cuda
    n = 256
    params = BfvParams.create_custom(n, 65537, ref_primes(n, 57, 3), ref_primes(n, 55, 1),
                                     word_bits=64)
    eng = BfvEngine(params, CPU)
    ring64 = eng.ring(2)
    x = torch.zeros((2, 3, n), dtype=torch.int64)
    for fn in (ntt_cuda.ntt32_fwd, ntt_cuda.ntt32_inv, ntt_cuda.ntt32_fwd_r4,
               ntt_cuda.ntt32_inv_r4, ntt_cuda.ntt32_fwd_perm, ntt_cuda.ntt32_inv_perm):
        with pytest.raises(ValueError, match='32-bit word'):
            fn(x, ring64)
    with pytest.raises(ValueError, match='32-bit word'):
        behz_cuda.behz_prep32(x, eng.behz(2))
    with pytest.raises(ValueError, match='32-bit word'):
        behz_cuda.behz_finish32(x, x, eng.behz(2))
    key = KeySwitchKey(key_q=torch.zeros((3, 2, 3, n), dtype=torch.int64),
                       key_p=torch.zeros((3, 2, 1, n), dtype=torch.int64))
    with pytest.raises(ValueError, match='32-bit word'):
        ksw_cuda.ksw_switch32(x, key, eng.switcher, 2)
    # and the 64-bit entries refuse 32-bit holders
    ring32 = get_rns_ring(gen_ntt_primes(n, 31, 3), n, CPU)
    for fn in (ntt64_cuda.ntt64_fwd, ntt64_cuda.ntt64_inv, ntt64_cuda.ntt_fused64):
        with pytest.raises(ValueError, match='64-bit word'):
            fn(x, ring32)
    with pytest.raises(ValueError, match='64-bit word'):
        bconv_cuda.bconv64_convert(x, trns.BasisConv(tuple(gen_ntt_primes(n, 31, 3)),
                                                     tuple(gen_ntt_primes(n, 30, 2)), CPU))
    with pytest.raises(ValueError, match='64-bit word'):
        ksw64_cuda.ksw_inner64(torch.zeros((1, 4, n), dtype=torch.int64), key, 2, ring32)
