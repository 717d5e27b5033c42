"""The NTT-domain tensor product of lattisense_torch (``ops/tensor_cuda.py``,
kernel B8's wrapper) on the CPU: the plain twin against the stacked
composition of four Montgomery products and an add, written out here from
``core/u64.py``, and against Python integers, on both words; kernel B8's
thread map; the checks and the strided views the kernel reads in place; and
``schemes/bfv.py`` ``tensor_product`` on a CPU tensor, over a ring and over
the sharded engine's ring views. The kernel itself runs on the card
(``tests/test_torch_cuda.py``). The tolerance is zero throughout.
"""

import numpy as np
import pytest
import torch

from lattisense_torch.core import u64 as tu
from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_torch.ops import cuda_build, tensor_cuda
from lattisense_torch.ops.tensor_cuda import (_aligned, _check, tensor_product_cuda,
                                              tensor_product_plain, thread_map)
from lattisense_torch.parallel.sharded_engine import ShardedRing, _NoRows
from lattisense_torch.schemes import bfv
from lattisense_torch.utils import observability as obs

CPU = torch.device('cpu')
BITS = {32: 31, 64: 60}         # prime sizes of each word's chains


def ring_of(word_bits, L, n=1024):
    return get_rns_ring(gen_ntt_primes(n, BITS[word_bits], L), n, CPU, word_bits)


def residues(ring, lead, seed):
    """A (*lead, L, n) stack of residues over ``ring`` from a seed."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.integers(0, q, (*lead, ring.n), dtype=np.int64)
                                      for q in ring.moduli], axis=-2))


def stacked(f, ring):
    """The product as the engines composed it on one (..., 4, L, n) stack
    (a0, a1, b0, b1), written out from the word's functions."""
    w, q, pinv = tu.word(ring.word_bits), ring.q, ring.pinv
    f0, f1, f2, f3 = (f[..., i, :, :] for i in range(4))
    d1 = tu.addmod(w.mont_mul(f0, f3, q, pinv), w.mont_mul(f1, f2, q, pinv), q)
    return torch.stack([w.mont_mul(f0, f2, q, pinv), d1, w.mont_mul(f1, f3, q, pinv)], dim=-3)


def exact(a, b, ring, a_to_mont, idx):
    """(d0, d1, d2) at one (lead..., limb, coefficient) in Python integers."""
    *lead, t, i = idx
    q, R = ring.moduli[t], 1 << ring.word_bits
    rinv = pow(R, -1, q)
    x = [int(a[(*lead, c, t, i)]) * (R if a_to_mont else 1) for c in (0, 1)]
    y = [int(b[(*lead, c, t, i)]) for c in (0, 1)]
    return [x[0] * y[0] * rinv % q, (x[0] * y[1] + x[1] * y[0]) * rinv % q,
            x[1] * y[1] * rinv % q]


@pytest.mark.parametrize('word_bits', [32, 64])
@pytest.mark.parametrize('lead', [(3,), (2, 2)])
@pytest.mark.parametrize('a_to_mont', [False, True])
def test_plain_twin_matches_the_stacked_composition(word_bits, lead, a_to_mont):
    """Separate a and b, and the halves of one stack read as strided views,
    give the stacked composition bit for bit (after ``to_mont`` of a where
    ``a_to_mont``), and Python integers at sampled coefficients."""
    ring = ring_of(word_bits, 4)
    f = residues(ring, (*lead, 4), 11 + word_bits)
    w = tu.word(word_bits)
    fm = f.clone()
    if a_to_mont:
        fm[..., :2, :, :] = w.to_mont(f[..., :2, :, :], ring.q, ring.pinv, ring.r2)
    want = stacked(fm, ring)
    a, b = f[..., :2, :, :], f[..., 2:, :, :]
    assert not a.is_contiguous() and a.stride(-3) == ring.n * 4
    for x, y in ((a, b), (a.contiguous(), b.contiguous())):
        got = tensor_product_plain(x, y, ring, a_to_mont)
        assert got.shape == (*lead, 3, 4, ring.n) and torch.equal(got, want)
        assert torch.equal(tensor_product_cuda(x, y, ring, a_to_mont), want)
    rng = np.random.default_rng(5)
    for _ in range(16):
        idx = (*(int(rng.integers(0, s)) for s in lead), int(rng.integers(0, 4)),
               int(rng.integers(0, ring.n)))
        *ld, t, i = idx
        assert [int(want[(*ld, k, t, i)]) for k in range(3)] == exact(a, b, ring, a_to_mont,
                                                                       idx)


@pytest.mark.parametrize('word_bits', [32, 64])
@pytest.mark.parametrize('view', ['ring', 'coeff_shard', 'no_rows'])
def test_bfv_tensor_product_on_cpu_is_todays(word_bits, view):
    """``schemes/bfv.py`` ``tensor_product`` on CPU halves of a stack returns
    the stacked composition and counts no launch: over a ring; over a
    coefficient-sharded view (``ShardedRing``, whose ``n`` is the full
    degree) on a shard of n / 4 coefficients; and over a view that holds no
    limb at the level (``_NoRows``), an empty product."""
    ring = ring_of(word_bits, 3, 256)
    f = residues(ring, (5, 4), 7)
    want = stacked(f, ring)
    if view == 'coeff_shard':
        ring, f, want = ShardedRing(ring, object()), f[..., 64:128], want[..., 64:128]
    elif view == 'no_rows':
        ring, f, want = _NoRows(ring.n, CPU, word_bits), f[..., :0, :], want[..., :0, :]
    before = dict(tensor_cuda.launches)
    got = bfv.tensor_product(f[..., :2, :, :], f[..., 2:, :, :], ring)
    assert got.shape == want.shape and torch.equal(got, want)
    assert tensor_cuda.launches == before


@pytest.mark.parametrize('G,L,n', [(1, 1, 2), (3, 5, 8), (7, 3, 1536), (65537, 1, 4)])
def test_thread_map_covers_every_pair_once(G, L, n):
    """Every (polynomial, limb, coefficient pair) is computed by exactly one
    thread, for batch and limb counts that divide no block, n / 2 below and
    above a block's threads, and more polynomials than the grid's third
    dimension."""
    threads, grid, work = thread_map(G, L, n)
    assert threads == min(tensor_cuda.THREADS, n // 2)
    assert grid == (-(-(n // 2) // threads), L, min(G, tensor_cuda.MAX_GRID_Z))
    assert (threads, grid) == tensor_cuda.geometry(G, L, n)
    assert len(work) == len(set(work)) == G * L * (n // 2)
    assert set(work) == {(g, t, i) for g in range(G) for t in range(L) for i in range(0, n, 2)}


@pytest.mark.parametrize('case', ['word', 'ring_word', 'shape', 'limbs', 'shapes', 'dtype',
                                  'device', 'ring_device'])
def test_check_rejects_bad_input(case):
    ring = ring_of(32, 2, 64)
    a = residues(ring, (3, 2), 1)
    b = residues(ring, (3, 2), 2)
    bad = {
        'word': (a, b, type('Holder', (), {'word_bits': 16})(), ValueError),
        'ring_word': (a, b, object(), ValueError),
        'shape': (a[..., :1, :, :], b[..., :1, :, :], ring, ValueError),
        'limbs': (a[..., :1, :], b[..., :1, :], ring, ValueError),
        'shapes': (a, b[:2], ring, ValueError),
        'dtype': (a.int(), b.int(), ring, TypeError),
        'device': (a, torch.empty(b.shape, dtype=torch.int64, device='meta'), ring, ValueError),
        'ring_device': (a.to('meta'), b.to('meta'), ring, ValueError),
    }[case]
    with pytest.raises(bad[3]):
        _check(*bad[:3])
    _check(a, b, ring)


def test_the_kernel_reads_views_in_place():
    """The halves of one (G, 4, L, n) stack reach the kernel as views of it
    (its polynomial and component strides); a misaligned start or leading
    dimensions that do not flatten to one stride are copied first."""
    ring = ring_of(64, 3, 64)
    f = residues(ring, (6, 4), 3)
    for half in (f[..., :2, :, :], f[..., 2:, :, :]):
        v = _aligned(half, 6)
        assert v.data_ptr() == half.data_ptr() and v.stride() == (4 * 3 * 64, 3 * 64, 64, 1)
    lead = residues(ring, (2, 3, 2), 4)
    for x in (lead, lead.transpose(0, 1)):
        v = _aligned(x, 6)
        assert v.shape == (6, 2, 3, 64) and torch.equal(v, x.reshape(6, 2, 3, 64))
    assert _aligned(lead, 6).data_ptr() == lead.data_ptr()
    assert _aligned(lead.transpose(0, 1), 6).is_contiguous()
    odd = torch.empty(lead.numel() + 1, dtype=torch.int64)[1:].view(lead.shape).copy_(lead)
    v = _aligned(odd, 6)
    assert v.data_ptr() % 16 == 0 and torch.equal(v, odd.reshape(6, 2, 3, 64))


@pytest.mark.parametrize('lib,files', [
    ('tensor', ['tensor.cu', 'row_fusion.cuh', 'word64.cuh', 'ntt_passes.cuh']),
    ('ksw64', ['ksw64.cu', 'word64.cuh']), ('bconv64', ['bconv64.cu', 'word64.cuh'])])
def test_the_64_bit_word_is_one_header(lib, files):
    """B6, B7 and B8 take the 64-bit word's REDC from one header, whose edit
    rebuilds all three; B8 takes the 32-bit word's from B3's and B4's; B8 is
    among the libraries built at once; its two word counts are launches."""
    assert [p.rsplit('/', 1)[1] for p in cuda_build.sources_of(lib)] == files
    assert lib in cuda_build.SOURCES
    assert obs._launch_counters['tensor_cuda'] == (tensor_cuda.launches, ('tensor32', 'tensor64'))
