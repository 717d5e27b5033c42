"""The pass schedule of kernels B1 and B5 (``csrc/ntt_passes.cuh``), walked
on the CPU.

A CUDA kernel has no CPU mode, but its index arithmetic does not need the
card. ``walk`` below moves a row exactly as the kernel does: it stages the
row through ``staging_slot``, gathers each pass's registers with
``element_index``, runs the lazy butterflies of ``csrc/ntt_passes.cuh`` with
the pass tables the kernel is handed (``ntt_cuda._tables``,
``ntt64_cuda._tables``), exchanges through ``exchange_slot`` and stores the
last window. Its output is held bit for bit against
``lattisense_tpu/core/ntt.py`` ``ntt``/``intt`` (``xp=numpy``) at every
log2 n from 1 to 12 and at n=16384, for both words, and each lazy range is
checked on the way. The swizzles are checked free of bank conflicts, and the
pass tables to hold every twiddle once.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.core import ntt as ref_ntt
from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.core.modring import get_rns_ring as ref_ring

from lattisense_torch.core import u64 as tu
from lattisense_torch.core.modring import get_rns_ring
from lattisense_torch.ops import ntt64_cuda, ntt_cuda

CPU = torch.device('cpu')
SIGN = -(1 << 63)


def uge(a, b):
    """a >= b on the unsigned 64-bit patterns of int64 tensors."""
    return (a ^ SIGN) >= (b ^ SIGN)


class Lazy32:
    """The 32-bit word's lazy butterflies: values in [0, 2q)."""
    fwd_bound = inv_bound = 2

    @staticmethod
    def shoup(a, w, ws, q):
        return a * w - tu.mulhi(a, ws) * q

    @classmethod
    def fwd(cls, x, y, w, ws, q):
        v = cls.shoup(y, w, ws, q)
        v = torch.where(v >= q, v - q, v)
        u = torch.where(x >= q, x - q, x)
        return u + v, u - v + q

    @classmethod
    def inv(cls, x, y, w, ws, q):
        u, v = torch.where(x >= q, x - q, x), torch.where(y >= q, y - q, y)
        return u + v, cls.shoup(u - v + q, w, ws, q)

    @staticmethod
    def canon(x, q):
        return torch.where(x >= q, x - q, x)


class Lazy64:
    """The 64-bit word's lazy butterflies: forward values in [0, 4q),
    inverse values in [0, 2q), on int64 bit patterns that wrap as u64."""
    fwd_bound, inv_bound = 4, 2

    @staticmethod
    def shoup(a, w, ws, q):
        return a * w - tu.mulhi64(a, ws) * q

    @classmethod
    def fwd(cls, x, y, w, ws, q):
        u = torch.where(uge(x, 2 * q), x - 2 * q, x)
        v = cls.shoup(y, w, ws, q)
        return u + v, u - v + 2 * q

    @classmethod
    def inv(cls, x, y, w, ws, q):
        s, d = x + y, x - y + 2 * q
        return torch.where(uge(s, 2 * q), s - 2 * q, s), cls.shoup(d, w, ws, q)

    @staticmethod
    def canon(x, q):
        x = torch.where(uge(x, 2 * q), x - 2 * q, x)
        return torch.where(x >= q, x - q, x)


def below(x, bound):
    """Every unsigned value of x lies below the per-limb bound."""
    return bool((~uge(x, bound)).all())


def kernel_tables(ring):
    """The (L, entries, 2) pass tables the kernel gets, as int64 values."""
    tabs = ntt_cuda.row_tables(ring) if ring.word_bits == 32 else ntt64_cuda._tables(ring)
    assert all(tabs[k].is_contiguous() for k in ('fwd', 'inv'))     # the kernel reads them flat
    if ring.word_bits == 32:
        return {k: tabs[k].long() & tu.MASK32 for k in ('fwd', 'inv')}
    return tabs


def walk(x, ring, inverse, post=None):
    """Kernel B1 / B5 on an int64 (..., L, n) stack, step for step, with the
    pass tables the kernel is handed (``walk_rows``). ``post`` is a per-limb
    (value, companion) pair of (L, 1) columns or None."""
    tab = kernel_tables(ring)['inv' if inverse else 'fwd']
    return walk_rows(x, ring.word_bits, ring.q.reshape(-1, 1), tab, inverse, post)


def walk_rows(x, bits, q, tab, inverse, post=None, lazy_end=False, staged=None):
    """The row kernel on an int64 (..., L, n) stack of ``bits``-bit words,
    row l on prime q[l] ((L, 1)) and pass table tab[l] ((L, entries, 2)
    int64), step for step: the first window (from the staging buffer, or
    from device memory through an exchange), passes, exchanges, epilogue,
    the output exchange and the store of the top window. ``lazy_end`` (the
    inverse) skips the epilogue: the last window's lazy values, in element
    order, as the cluster kernels park them. ``staged`` overrides whether
    the first window comes from the staging buffer (the row kernel's
    ``stages_rows``; the cluster kernels never stage)."""
    lazy = Lazy32 if bits == 32 else Lazy64
    per_vector = 16 // (8 if bits == 32 else 16)
    n, L = x.shape[-1], x.shape[-2]
    logn = n.bit_length() - 1
    K, windows = ntt_cuda.schedule(logn)
    E, T = 1 << K, n >> K
    order = windows[::-1] if inverse else windows
    top = windows[0][0]
    bound = (lazy.inv_bound if inverse else lazy.fwd_bound) * q
    lane = torch.arange(T).reshape(-1, 1)

    def exchange(a, lo_from, lo_to):
        buf = torch.empty_like(x)
        src = ntt_cuda.element_index(logn, lo_from)
        buf[..., ntt_cuda.exchange_slot(src, bits).reshape(-1)] = a.reshape(*a.shape[:-2], n)
        return buf[..., ntt_cuda.exchange_slot(ntt_cuda.element_index(logn, lo_to), bits)]

    if staged is None:
        staged = ntt_cuda.stages_rows(logn, bits)
    if staged:                                      # cp.async: 16-byte chunk c -> its slot
        stage = torch.empty_like(x)
        stage[..., ntt_cuda.staging_slot(torch.arange(n))] = x
        a = stage[..., ntt_cuda.staging_slot(ntt_cuda.element_index(logn, order[0][0]))]
    else:
        a = x[..., ntt_cuda.element_index(logn, top)]                 # (..., L, T, E)
        if inverse and len(order) > 1:
            a = exchange(a, top, 0)
    off = 0
    for step, (lo, kp) in enumerate(order):
        idx = ntt_cuda.element_index(logn, lo)
        assert torch.equal(idx.reshape(-1).sort().values, torch.arange(n))
        pos = off + ntt_cuda.table_position(logn, lo, lane, torch.arange(E), per_vector)
        tw = tab[:, pos]                                               # (L, T, E, 2)
        w, ws = tw[..., 0], tw[..., 1]
        regs = list(a.unbind(-1))
        GS = 1 << kp
        for j in range(kp):
            cnt = 1 << (kp - 1 - j) if inverse else 1 << j
            first = GS - (GS >> j) if inverse else 1 << j
            dist = 1 << j if inverse else 1 << (kp - 1 - j)
            span = 1 << (j + 1) if inverse else 1 << (kp - j)
            for g in range(E // GS):
                for h in range(cnt):
                    slot = g * GS + first + h
                    for r in range(span):
                        if r & dist:
                            continue
                        i0 = g * GS + h * span + r
                        fn = lazy.inv if inverse else lazy.fwd
                        regs[i0], regs[i0 + dist] = fn(regs[i0], regs[i0 + dist],
                                                       w[..., slot], ws[..., slot], q)
        a = torch.stack(regs, dim=-1)
        assert below(a, bound.reshape(L, 1, 1)), (step, lo, kp)
        off += 1 << (logn - lo)
        if step + 1 < len(order):                  # the exchange through shared memory
            a = exchange(a, lo, order[step + 1][0])
    assert off == tab.shape[1]
    qq = q.reshape(L, 1, 1)
    if lazy_end:
        assert inverse
    elif post is None:
        a = lazy.canon(a, qq)
    else:
        a = lazy.canon(lazy.shoup(a, post[0].reshape(L, 1, 1), post[1].reshape(L, 1, 1), qq), qq)
    if not inverse and len(order) > 1:
        a = exchange(a, 0, top)
    y = torch.empty_like(x)
    y[..., ntt_cuda.element_index(logn, top).reshape(-1)] = a.reshape(*a.shape[:-2], n)
    return y


def chain_of(bits, n, count):
    if bits == 32:
        return tuple(ref_primes(n, 31, count))
    return tuple(ref_primes(n, 61, 1) + ref_primes(n, 55, count - 1))[:count]


def case(bits, logn, lead, count=2, seed=0):
    n = 1 << logn
    chain = chain_of(bits, n, count)
    rng = np.random.default_rng(seed + logn)
    x = np.stack([rng.integers(0, q, (*lead, n), dtype=np.uint64) for q in chain], axis=-2)
    ref = ref_ring(chain, n, bits)
    x = x.astype(np.uint32) if bits == 32 else x
    return x, ref, get_rns_ring(chain, n, CPU, bits)


def as_tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint64).view(np.int64))


def as_array(t, bits):
    a = t.numpy().view(np.uint64)
    return a.astype(np.uint32) if bits == 32 else a


@pytest.mark.parametrize('logn', range(1, 13))
@pytest.mark.parametrize('bits', [32, 64])
def test_walk_matches_reference(bits, logn):
    x, ref, ring = case(bits, logn, (2,))
    want = ref_ntt.ntt(np, x, ref)
    got = walk(as_tensor(x), ring, inverse=False)
    assert np.array_equal(as_array(got, bits), want)
    back = walk(as_tensor(want), ring, inverse=True, post=(ring.n_inv, ring.n_inv_shoup))
    assert np.array_equal(as_array(back, bits), ref_ntt.intt(np, want, ref))
    assert np.array_equal(as_array(back, bits), x)
    # the epilogues of B2 (to-Montgomery) and B4 / the u64 mult (from-Montgomery folded in)
    tabs = ntt_cuda.row_tables(ring) if bits == 32 else ntt64_cuda._tables(ring)
    col = ((lambda k: tabs[k].long().reshape(-1, 1) & tu.MASK32) if bits == 32
           else (lambda k: tabs[k].reshape(-1, 1)))
    xt = as_tensor(x)
    assert torch.equal(walk(xt, ring, False, (col('r1'), col('r1_shoup'))),
                       ntt_cuda.ntt_plain(xt, ring, to_mont=True))
    yt = as_tensor(want)
    w = ring.word
    assert torch.equal(walk(yt, ring, True, (col('n_inv_rinv'), col('n_inv_rinv_shoup'))),
                       ntt_cuda.intt_plain(w.from_mont(yt, ring.q, ring.pinv), ring))


@pytest.mark.parametrize('bits', [32, 64])
def test_walk_matches_reference_headline(bits):
    """One row at n = 16384: four passes, the last a chunk of two stages."""
    x, ref, ring = case(bits, 14, (), count=1)
    want = ref_ntt.ntt(np, x, ref)
    assert np.array_equal(as_array(walk(as_tensor(x), ring, inverse=False), bits), want)
    back = walk(as_tensor(want), ring, inverse=True, post=(ring.n_inv, ring.n_inv_shoup))
    assert np.array_equal(as_array(back, bits), x)


def test_schedule_shapes():
    """Passes, register counts and threads of the sizes the kernels take."""
    assert ntt_cuda.schedule(14) == (4, [(10, 4), (6, 4), (2, 4), (0, 2)])
    assert ntt_cuda.schedule(15) == (5, [(10, 5), (5, 5), (0, 5)])
    assert ntt_cuda.schedule(3) == (3, [(0, 3)])
    for logn in range(1, 16):
        K, windows = ntt_cuda.schedule(logn)
        assert sum(kp for _, kp in windows) == logn and logn - K <= 10
        assert all(kp == K for _, kp in windows[:-1]) and windows[-1][0] == 0


@pytest.mark.parametrize('logn', [10, 14, 15])
def test_shared_memory_access_is_conflict_free(logn):
    """Every exchange hits distinct banks: 32-bit words (B1), one warp of 32
    lanes per register; 64-bit words (B5, n <= 2^14), a half-warp of 16
    lanes per register. B1's first windows read its staging buffer without
    conflicts: 8-byte reads by half-warps, 16-byte pair reads by
    quarter-warps."""
    n = 1 << logn
    K, windows = ntt_cuda.schedule(logn)
    for bits, lanes, slots in ((32, 32, 32), (64, 16, 16)):
        if bits == 64 and logn > 14:
            continue
        assert sorted(ntt_cuda.exchange_slot(np.arange(n), bits)) == list(range(n))
        for lo, _ in windows:
            idx = ntt_cuda.element_index(logn, lo).numpy()
            banks = ntt_cuda.exchange_slot(idx, bits).reshape(-1, lanes, idx.shape[1]) % slots
            assert all(len(set(banks[w, :, i])) == lanes
                       for w in range(banks.shape[0]) for i in range(idx.shape[1])), (bits, lo)
    if not ntt_cuda.stages_rows(logn, 32):
        return
    assert sorted(ntt_cuda.staging_slot(np.arange(n))) == list(range(n))
    first_fwd = ntt_cuda.element_index(logn, windows[0][0]).numpy()
    st = ntt_cuda.staging_slot(first_fwd).reshape(-1, 16, first_fwd.shape[1]) % 16
    assert all(len(set(st[h, :, i])) == 16 for h in range(st.shape[0])
               for i in range(first_fwd.shape[1]))
    first_inv = ntt_cuda.element_index(logn, 0).numpy()[:, ::2]
    chunks = (ntt_cuda.staging_slot(first_inv) // 2).reshape(-1, 8, first_inv.shape[1]) % 8
    assert all(len(set(chunks[h, :, i])) == 8 for h in range(chunks.shape[0])
               for i in range(first_inv.shape[1]))


@pytest.mark.parametrize('logn', [1, 7, 14, 15])
@pytest.mark.parametrize('inverse', [False, True])
@pytest.mark.parametrize('per_vector', [1, 2])
def test_pass_tables_hold_each_twiddle_once(logn, inverse, per_vector):
    """The slots of a direction's table name every twiddle 1 .. n-1 once
    (the unused slot of each group names entry 0): each is read once per
    row. A warp's read of one vector index is one contiguous piece."""
    idx = ntt_cuda.pass_indices(logn, inverse, per_vector)
    used = idx[idx != 0]
    assert sorted(used) == list(range(1, 1 << logn))
    K, windows = ntt_cuda.schedule(logn)
    assert len(idx) == sum(1 << (logn - lo) for lo, _ in windows)
    lanes = torch.arange(min(32, 1 << (logn - K)))
    for lo, _ in windows:
        for k in range(0, 1 << K, per_vector):
            vec = ntt_cuda.table_position(logn, lo, lanes, k, per_vector) // per_vector
            assert int(vec.max() - vec.min()) + 1 == len(set(vec.tolist())), (lo, k)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every header it includes from
    csrc/, so an edited shared header is rebuilt rather than a stale library
    loaded."""
    from lattisense_torch.ops import cuda_build
    assert [p.rsplit('/', 1)[1] for p in cuda_build.sources_of('ntt64')] == \
        ['ntt64.cu', 'ntt_passes.cuh', 'ntt_cluster.cuh']
    assert [p.rsplit('/', 1)[1] for p in cuda_build.sources_of('ntt32')] == \
        ['ntt32.cu', 'ntt_passes.cuh', 'ntt_cluster.cuh']
    (tmp_path / 'k.cu').write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / 'a.cuh').write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / 'b.cuh').write_text('int b = 1;\n')
    monkeypatch.setattr(cuda_build, 'CSRC', str(tmp_path))
    first = cuda_build.library_path('k')
    assert [p.rsplit('/', 1)[1] for p in cuda_build.sources_of('k')] == ['k.cu', 'a.cuh', 'b.cuh']
    (tmp_path / 'b.cuh').write_text('int b = 2;\n')
    assert cuda_build.library_path('k') != first
