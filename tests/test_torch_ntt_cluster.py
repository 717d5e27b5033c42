"""Kernel B5's cluster kernel (``csrc/ntt_cluster.cuh``) and B7's thread map
(``csrc/ksw64.cu``), walked on the CPU.

Above the row kernel's cap (n = 2^15 and 2^16) B5 runs one launch in which
a thread-block cluster of C = 2^k blocks holds a row, block s owning sub-row
s in its exchange buffer. ``walk_cluster`` below moves the data as the
kernel does: which block and thread own which columns, which cells each
reads straight from device memory (forward) or through distributed shared
memory (inverse), the k cross stages with the word's lazy butterflies and
the column tables, which buffer slot each cell lands in, and the row body
over the virtual limbs (``walk_rows`` of ``tests/test_torch_ntt_schedule.py``
with the tables of ``split_pass_tables``). It is held bit for bit against
``lattisense_tpu/core/ntt.py`` (``xp=numpy``) at n = 2^15 and 2^16 on primes
of the parameter table's u64 chains, both directions, with and without the
epilogues, with the tables the wrapper hands the kernel; and at every
cluster depth k = 1..3 at n = 256 and 1024 against the unsplit walk.

B7's grid and thread map (``ksw64_cuda.thread_map``) are walked at the
path's shapes and at a polynomial count that is no multiple of the chunk:
every output is written exactly once.
"""

import json
import os

import numpy as np
import pytest
import torch

from lattisense_tpu.core import ntt as ref_ntt

from lattisense_torch.core.modring import get_rns_ring
from lattisense_torch.ops import ksw64_cuda, ntt64_cuda, ntt_cuda

from tests.test_torch_ntt_schedule import Lazy64, as_array, as_tensor, below, ref_ring, walk, walk_rows
from tests.test_torch_ntt_split import split_tables, wrapper_tables

PARAMS = os.path.join(os.path.dirname(ntt64_cuda.__file__), '..', 'parameter.json')


def cluster_columns(logs: int, k: int) -> torch.Tensor:
    """(C, T, 16 / C): the column that thread ``lane`` of block s takes as
    its j-th, c = s·2^logs/C + j·T + lane (T = 2^logs / 16 threads)."""
    C, sub = 1 << k, 1 << logs
    K, _ = ntt_cuda.schedule(logs)
    T = sub >> K
    s = torch.arange(C).reshape(C, 1, 1)
    lane = torch.arange(T).reshape(1, T, 1)
    j = torch.arange((1 << K) // C).reshape(1, 1, -1)
    return s * (sub // C) + j * T + lane


def cross_stages(regs, tab, k, inverse, q):
    """The k column stages on registers ``regs`` (list over cell r of
    (..., L, C, T, cols) tensors), the limbs' column tables tab ((L, 2^k, 2)),
    q of shape (L, 1, 1, 1)."""
    L = tab.shape[0]
    for j in range(k):
        dist = 1 << j if inverse else 1 << (k - 1 - j)
        m = 1 << (k - 1 - j) if inverse else 1 << j
        for r in range(1 << k):
            if r & dist:
                continue
            h = m + (r >> (j + 1) if inverse else r >> (k - j))
            w, ws = tab[:, h, 0].reshape(L, 1, 1, 1), tab[:, h, 1].reshape(L, 1, 1, 1)
            fn = Lazy64.inv if inverse else Lazy64.fwd
            regs[r], regs[r + dist] = fn(regs[r], regs[r + dist], w, ws, q)
        bound = (Lazy64.inv_bound if inverse else Lazy64.fwd_bound) * q
        assert all(below(a, bound) for a in regs), j
    return regs


def walk_cluster(x, q, tabs, logs, inverse, post=None):
    """The cluster kernel on an int64 (..., L, n) stack of the 64-bit word:
    limb l on prime q[l] ((L, 1)); ``tabs`` holds the virtual pass tables
    ('fwd'/'inv', (L·2^k, entries, 2)) and the column tables
    ('cols_fwd'/'cols_inv', (L, 2^k, 2)); ``post`` a per-virtual-limb
    (value, companion) pair of (L·2^k, 1) columns or None."""
    n, L, lead = x.shape[-1], x.shape[-2], x.shape[:-2]
    k = n.bit_length() - 1 - logs
    C, sub = 1 << k, 1 << logs
    cols = cluster_columns(logs, k)                                  # (C, T, cols)
    assert torch.equal(cols.reshape(-1).sort().values, torch.arange(sub))
    slots = ntt_cuda.exchange_slot(cols, 64)
    assert torch.equal(slots.reshape(-1).sort().values, torch.arange(sub))
    by_slot = ntt_cuda.exchange_slot(torch.arange(sub), 64)          # element e's slot
    qc = q.reshape(L, 1, 1, 1)
    vq = q.repeat_interleave(C, dim=0)
    d = 'inv' if inverse else 'fwd'
    if not inverse:
        # block s reads the C cells c + r·2^logs of its columns from device memory
        rows = x.reshape(*lead, L, C, sub)
        regs = [rows[..., r, :][..., cols] for r in range(C)]       # (..., L, C_s, T, cols)
        regs = cross_stages(regs, tabs['cols_fwd'], k, False, qc)
        # cell r goes to slot xslot(c) of block r's buffer
        buf = torch.empty_like(rows)
        for r in range(C):
            buf[..., r, slots.reshape(-1)] = regs[r].reshape(*lead, L, -1)
        # each block takes its first window from its buffer: element e at its slot
        mine = buf[..., by_slot].reshape(*lead, L * C, sub)
        return walk_rows(mine, 64, vq, tabs[d], False, post).reshape(x.shape)
    z = walk_rows(x.reshape(*lead, L * C, sub), 64, vq, tabs[d], True, lazy_end=True)
    assert below(z, 2 * vq)
    buf = torch.empty_like(z)
    buf[..., by_slot] = z                                            # parked at the slots
    buf = buf.reshape(*lead, L, C, sub)
    # block s reads cell r of its columns from block r's buffer
    regs = [buf[..., r, :][..., slots] for r in range(C)]
    regs = cross_stages(regs, tabs['cols_inv'], k, True, qc)
    y = torch.empty_like(buf)
    for r in range(C):
        a = regs[r]
        if post is None:
            a = Lazy64.canon(a, qc)
        else:      # block s applies its virtual limb's constant (each limb's, repeated)
            pv, pvs = (p.reshape(L, C, 1, 1) for p in post)
            a = Lazy64.canon(Lazy64.shoup(a, pv, pvs, qc), qc)
        y[..., r, cols.reshape(-1)] = a.reshape(*lead, L, -1)
    return y.reshape(x.shape)


def table_chain(logn):
    """Two primes of the parameter table's u64 chains that take n = 2^logn,
    the chain's widest q and special primes: BFV 32768's (59 and 61 bits)
    at 2^15, CKKS 65536's at 2^16."""
    with open(PARAMS) as f:
        table = json.load(f)
    entry = table['BFV']['32768'] if logn == 15 else table['CKKS']['65536']
    chain = (max(entry['q']), max(entry['p']))
    assert all((q - 1) % (2 << logn) == 0 for q in chain)
    return chain


@pytest.mark.parametrize('logn', [15, 16])
def test_cluster_walk_matches_reference(logn):
    """The wrapper's cluster kernel (sub-rows of 2^SUB_LOGN) with the
    wrapper's own tables, both directions, with and without the epilogues,
    bit for bit against the reference."""
    n = 1 << logn
    chain = table_chain(logn)
    ring = get_rns_ring(chain, n, 'cpu', 64)
    ref = ref_ring(chain, n, 64)
    k = ntt64_cuda.cluster_depth(logn)
    assert k == logn - ntt64_cuda.SUB_LOGN
    tabs = wrapper_tables(ring)
    assert tabs['fwd'].shape[0] == tabs['q'].shape[0] == len(chain) << k
    assert tuple(tabs['cols_fwd'].shape) == (len(chain), 1 << k, 2)
    rng = np.random.default_rng(logn)
    x = np.stack([rng.integers(0, q, (1, n), dtype=np.uint64) for q in chain], axis=-2)
    q = ring.q.reshape(-1, 1)
    want = ref_ntt.ntt(np, x, ref)
    xt = as_tensor(x)
    got = walk_cluster(xt, q, tabs, ntt64_cuda.SUB_LOGN, False)
    assert np.array_equal(as_array(got, 64), want)
    yt = as_tensor(want)
    back = walk_cluster(yt, q, tabs, ntt64_cuda.SUB_LOGN, True, (tabs['n_inv'], tabs['n_inv_shoup']))
    assert np.array_equal(as_array(back, 64), ref_ntt.intt(np, want, ref))
    assert np.array_equal(as_array(back, 64), x)
    # the u64 mult's to-Montgomery, and the from-Montgomery folded into n^-1
    assert torch.equal(walk_cluster(xt, q, tabs, ntt64_cuda.SUB_LOGN, False,
                                    (tabs['r1'], tabs['r1_shoup'])),
                       ntt_cuda.ntt_plain(xt, ring, to_mont=True))
    assert torch.equal(
        walk_cluster(yt, q, tabs, ntt64_cuda.SUB_LOGN, True,
                     (tabs['n_inv_rinv'], tabs['n_inv_rinv_shoup'])),
        ntt_cuda.intt_plain(ring.word.from_mont(yt, ring.q, ring.pinv), ring))


@pytest.mark.parametrize('logn', [8, 10])
@pytest.mark.parametrize('k', [1, 2, 3])
def test_cluster_depths_match_unsplit_walk(logn, k):
    """Clusters of 2, 4 and 8 blocks give the unsplit walk's output in both
    directions: the ownership map, the slots and the virtual tables at every
    depth the kernel's instances use."""
    n = 1 << logn
    chain = tuple(table_chain(15))
    ring = get_rns_ring(chain, n, 'cpu', 64)
    rng = np.random.default_rng(k + logn)
    x = np.stack([rng.integers(0, q, (3, n), dtype=np.uint64) for q in chain], axis=-2)
    xt = as_tensor(x)
    tabs = split_tables(ring, k)
    q = ring.q.reshape(-1, 1)
    f = walk(xt, ring, inverse=False)
    assert torch.equal(walk_cluster(xt, q, tabs, logn - k, False), f)
    post = (ring.n_inv.repeat_interleave(1 << k, 0), ring.n_inv_shoup.repeat_interleave(1 << k, 0))
    assert torch.equal(walk_cluster(f, q, tabs, logn - k, True, post),
                       walk(f, ring, inverse=True, post=(ring.n_inv, ring.n_inv_shoup)))
    assert np.array_equal(as_array(f, 64), ref_ntt.ntt(np, x, ref_ring(chain, n, 64)))


@pytest.mark.parametrize('logs,k', [(13, 2), (13, 3), (14, 1), (14, 2)])
def test_cluster_cells_and_slots_once(logs, k):
    """At the kernel's instances every cell of a row is read by one thread
    of one block, every slot of every buffer written once, and a warp's lanes
    take consecutive columns (coalesced device memory, 256 bytes a warp)."""
    C, sub = 1 << k, 1 << logs
    cols = cluster_columns(logs, k)
    cells = (cols.unsqueeze(0) + sub * torch.arange(C).reshape(C, 1, 1, 1)).reshape(-1)
    assert torch.equal(cells.sort().values, torch.arange(sub << k))
    assert torch.equal(ntt_cuda.exchange_slot(cols, 64).reshape(-1).sort().values,
                       torch.arange(sub))
    warp = cols[:, :32, :].permute(0, 2, 1)                          # (C, cols, lanes)
    assert bool((warp[..., 1:] - warp[..., :-1] == 1).all())
    for s in range(C):                                               # block s: its C-th of the columns
        assert cols[s].min() == s * sub // C and cols[s].max() == (s + 1) * sub // C - 1


def test_cluster_depths_of_the_wrapper():
    """B5 takes its row kernel up to 2^14 and clusters of 2^(log2 n -
    SUB_LOGN) blocks above, at most 8 (the portable cluster size); the
    wrapper's tables at 2^16 hold one virtual limb a block."""
    assert [ntt64_cuda.cluster_depth(b) for b in (13, 14)] == [0, 0]
    depths = [ntt64_cuda.cluster_depth(b) for b in (15, 16)]
    assert depths == [15 - ntt64_cuda.SUB_LOGN, 16 - ntt64_cuda.SUB_LOGN] and max(depths) <= 3
    assert ntt64_cuda.SUB_LOGN in (13, 14) and ntt64_cuda.MAX_LOGN == 16
    ring = get_rns_ring(table_chain(16), 1 << 16, 'cpu', 64)
    tabs = ntt64_cuda._tables(ring)
    k = depths[1]
    assert tabs['fwd'].shape == (2 << k, ntt_cuda.pass_indices(16 - k, False, 1).size, 2)
    assert torch.equal(tabs['r1'].reshape(2, -1), tabs['r1'].reshape(2, -1)[:, :1].expand(2, 1 << k))


@pytest.mark.parametrize('G,beta,T,n', [(32, 4, 15, 512), (32, 2, 6, 512), (7, 3, 5, 256),
                                        (5, 1, 2, 16)])
def test_b7_thread_map_writes_each_output_once(G, beta, T, n):
    """B7's grid: chunks of polynomials fastest, then blocks of coefficient
    pairs, then limbs. Every (polynomial, component, limb, coefficient) of
    the output is written by exactly one thread, also where G is no
    multiple of the chunk and where n / 2 is below a block."""
    threads, grid, work = ksw64_cuda.thread_map(G, T, n)
    assert threads == min(ksw64_cuda.THREADS, n // 2)
    assert grid == (-(-G // ksw64_cuda.CHUNK), -(-(n // 2) // threads), T)
    hits = np.zeros((G, 2, T, n), dtype=np.int64)
    for (g0, g1), t, i in work:
        assert 0 <= g0 < g1 <= G and g1 - g0 <= ksw64_cuda.CHUNK and i % 2 == 0
        hits[g0:g1, :, t, i:i + 2] += 1
    assert (hits == 1).all()
