"""The split of the transform that kernels B1 and B5 run above their row
kernel's cap (one launch of the cluster kernel, ``csrc/ntt_cluster.cuh``),
walked on the CPU as columns, then rows.

At n = 2^logn with k = logn - (sub-row) the forward runs the k stages whose
butterflies span sub-rows of n/2^k on columns of 2^k cells, then the row
body over the virtual limbs (limb, sub-row) with the re-indexed tables of
``ntt_cuda.split_pass_tables``; the inverse runs the rows first, with the
full n^-1 in its epilogue, then the columns. ``walk_columns`` below moves
the columns with 2^k registers a thread at stride n/2^k, the word's lazy
butterflies and a canonical store; the rows go through ``walk_rows`` of
``tests/test_torch_ntt_schedule.py``; ``tests/test_torch_ntt_cluster.py``
walks the cluster kernel's own data movement. The result is held
bit for bit against ``lattisense_tpu/core/ntt.py`` ``ntt``/``intt``
(``xp=numpy``) at log2 n = 15 and 16 for both words, with the tables and
constants the wrappers hand the kernels, both directions, with and without
the to-/from-Montgomery epilogues; and at split depths 1..3 at n = 256 and
1024 against the unsplit walk.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.core import ntt as ref_ntt

from lattisense_torch.core import u64 as tu
from lattisense_torch.ops import ntt64_cuda, ntt_cuda

from tests.test_torch_ntt_schedule import (Lazy32, Lazy64, as_array, as_tensor, below, case, walk,
                                           walk_rows)


def walk_columns(x, bits, q, tab, k, inverse):
    """The column stages on an int64 (..., L, n) stack: limb l on prime
    q[l] ((L, 1)) and column table tab[l] ((L, 2^k, 2) int64, entry h the
    (value, companion) of psi_rev[h] or psi_inv_rev[h]). Each column's 2^k
    elements c + s·n/2^k are registers s; forward stage m = 2^j pairs
    registers 2^(k-1-j) apart (block r >> (k-j)), inverse stage
    m = 2^(k-1-j) pairs them 2^j apart (block r >> (j+1)); the store is
    canonical."""
    lazy = Lazy32 if bits == 32 else Lazy64
    n, L = x.shape[-1], x.shape[-2]
    regs = list(x.reshape(*x.shape[:-1], 1 << k, n >> k).unbind(-2))
    for j in range(k):
        dist = 1 << j if inverse else 1 << (k - 1 - j)
        m = 1 << (k - 1 - j) if inverse else 1 << j
        for r in range(1 << k):
            if r & dist:
                continue
            h = m + (r >> (j + 1) if inverse else r >> (k - j))
            w, ws = tab[:, h, 0].reshape(L, 1), tab[:, h, 1].reshape(L, 1)
            fn = lazy.inv if inverse else lazy.fwd
            regs[r], regs[r + dist] = fn(regs[r], regs[r + dist], w, ws, q)
        bound = (lazy.inv_bound if inverse else lazy.fwd_bound) * q
        assert all(below(a, bound) for a in regs), j
    return torch.stack([lazy.canon(a, q) for a in regs], dim=-2).reshape(x.shape)


def walk_split(x, bits, q, tabs, k, inverse, post=None):
    """The split at depth k: ``tabs`` holds the virtual pass tables
    ('fwd'/'inv', (L·2^k, entries, 2)) and the column tables
    ('cols_fwd'/'cols_inv', (L, 2^k, 2)) as int64 values; ``post`` is a
    per-virtual-limb (value, companion) pair of (L·2^k, 1) columns or None.
    q is the limbs' (L, 1) primes."""
    n, L = x.shape[-1], x.shape[-2]
    virtual = (*x.shape[:-2], L << k, n >> k)
    qv = q.repeat_interleave(1 << k, dim=0)
    d = 'inv' if inverse else 'fwd'
    if inverse:
        y = walk_rows(x.reshape(virtual), bits, qv, tabs[d], True, post).reshape(x.shape)
        return walk_columns(y, bits, q, tabs['cols_' + d], k, True)
    y = walk_columns(x, bits, q, tabs['cols_' + d], k, False)
    return walk_rows(y.reshape(virtual), bits, qv, tabs[d], False, post).reshape(x.shape)


def split_tables(ring, k):
    """The cluster kernels' tables at any depth k, built from the ring's with
    ``split_pass_tables`` and ``column_tables`` (64-bit: one entry a
    16-byte vector; 32-bit: two)."""
    per_vector = 2 if ring.word_bits == 32 else 1
    logn = ring.n.bit_length() - 1
    out = {}
    for d, attr, inverse in (('fwd', 'psi_rev', False), ('inv', 'psi_inv_rev', True)):
        tw = np.stack([getattr(r, attr) for r in ring.rings])
        tws = np.stack([getattr(r, attr + '_shoup') for r in ring.rings])
        out[d] = torch.from_numpy(ntt_cuda.split_pass_tables(tw, tws, logn, k, inverse,
                                                             per_vector))
        out['cols_' + d] = torch.from_numpy(ntt_cuda.column_tables(tw, tws, k))
    return out


def wrapper_tables(ring):
    """The tables and constants the wrapper hands the kernels (B1's uint32
    ones as int64 values), each constant as a (rows, 1) column."""
    if ring.word_bits == 64:
        tabs = ntt64_cuda._tables(ring)
        return {key: (t.reshape(-1, 1) if t.dim() == 1 else t) for key, t in tabs.items()}
    k = ntt_cuda.cluster_depth(ring.n.bit_length() - 1)
    tabs = ntt_cuda.cluster_tables(ring, k) if k else ntt_cuda.row_tables(ring)
    return {key: (t.long() & tu.MASK32).reshape(-1, 1) if t.dim() == 1 else t.long() & tu.MASK32
            for key, t in tabs.items()}


def depth(bits, logn):
    """The split depth of the wrapper's tables: the cross stages of B1's or
    B5's cluster kernel."""
    if bits == 32:
        return ntt_cuda.cluster_depth(logn)
    return ntt64_cuda.cluster_depth(logn)


@pytest.mark.parametrize('bits,logn', [(32, 16), (64, 15), (64, 16)])
def test_split_walk_matches_reference(bits, logn):
    """The split at the wrappers' depths (the cluster kernels at 2^15 and
    2^16, k = log2 n - SUB_LOGN) with the wrapper's own
    tables, both directions, with and without the epilogues, bit for bit
    against the reference."""
    x, ref, ring = case(bits, logn, (), count=2)
    k = depth(bits, logn)
    tabs = wrapper_tables(ring)
    assert tabs['fwd'].shape[0] == tabs['q'].shape[0] == 2 << k
    assert torch.equal(tabs['cols_q'].reshape(-1, 1), ring.q)
    q = ring.q.reshape(-1, 1)
    want = ref_ntt.ntt(np, x, ref)
    xt = as_tensor(x)
    got = walk_split(xt, bits, q, tabs, k, False)
    assert np.array_equal(as_array(got, bits), want)
    yt = as_tensor(want)
    back = walk_split(yt, bits, q, tabs, k, True, (tabs['n_inv'], tabs['n_inv_shoup']))
    assert np.array_equal(as_array(back, bits), ref_ntt.intt(np, want, ref))
    assert np.array_equal(as_array(back, bits), x)
    # B2's / the u64 mult's to-Montgomery and the from-Montgomery folded into n^-1
    assert torch.equal(walk_split(xt, bits, q, tabs, k, False, (tabs['r1'], tabs['r1_shoup'])),
                       ntt_cuda.ntt_plain(xt, ring, to_mont=True))
    w = ring.word
    assert torch.equal(
        walk_split(yt, bits, q, tabs, k, True, (tabs['n_inv_rinv'], tabs['n_inv_rinv_shoup'])),
        ntt_cuda.intt_plain(w.from_mont(yt, ring.q, ring.pinv), ring))


@pytest.mark.parametrize('bits', [32, 64])
@pytest.mark.parametrize('logn', [8, 10])
@pytest.mark.parametrize('k', [1, 2, 3])
def test_split_depths_match_unsplit_walk(bits, logn, k):
    """Any depth of the split gives the unsplit walk's output: the index
    math of ``split_indices`` and the column stages at k = 1, 2, 3."""
    x, ref, ring = case(bits, logn, (3,), count=2, seed=k)
    xt = as_tensor(x)
    tabs = split_tables(ring, k)
    if bits == 32:
        tabs = {key: t & tu.MASK32 for key, t in tabs.items()}
    q = ring.q.reshape(-1, 1)
    f = walk(xt, ring, inverse=False)
    assert torch.equal(walk_split(xt, bits, q, tabs, k, False), f)
    post = (ring.n_inv.repeat_interleave(1 << k, 0), ring.n_inv_shoup.repeat_interleave(1 << k, 0))
    assert torch.equal(walk_split(f, bits, q, tabs, k, True, post),
                       walk(f, ring, inverse=True, post=(ring.n_inv, ring.n_inv_shoup)))
    assert np.array_equal(as_array(f, bits), ref_ntt.ntt(np, x, ref))


@pytest.mark.parametrize('logn', [6, 10, 16])
def test_split_indices_hold_each_twiddle_once(logn):
    """The column entries 1 .. 2^k - 1 and the sub-rows' slots 1 .. n/2^k - 1
    name every twiddle of the full table once; at k = 0 the map is the
    identity, so an unsplit row's tables are unchanged."""
    assert np.array_equal(ntt_cuda.split_indices(logn, 0)[0], np.arange(1 << logn))
    for k in range(1, 4):
        idx = ntt_cuda.split_indices(logn, k)
        assert idx.shape == (1 << k, 1 << (logn - k)) and not idx[:, 0].any()
        used = np.concatenate([np.arange(1, 1 << k), idx[:, 1:].reshape(-1)])
        assert np.array_equal(np.sort(used), np.arange(1, 1 << logn))


def test_split_depths_of_the_wrappers():
    """B1 and B5 split at 2^15 and 2^16 (their cluster kernels, over
    sub-rows of 2^SUB_LOGN); neither above."""
    sub32 = ntt_cuda.SUB_LOGN
    assert [depth(32, b) for b in (14, 15, 16)] == [0, 15 - sub32, 16 - sub32]
    sub = ntt64_cuda.SUB_LOGN
    assert [depth(64, b) for b in (14, 15, 16)] == [0, 15 - sub, 16 - sub]
    assert ntt_cuda.MAX_LOGN == ntt64_cuda.MAX_LOGN == 16
