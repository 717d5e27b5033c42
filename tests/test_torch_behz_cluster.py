"""The cluster route of kernels B2 and B4 (``csrc/behz32.cu`` on the cluster
body of ``csrc/ntt_cluster.cuh``), walked on the CPU.

Above the row loops' cap (n = 2^15 and 2^16 on the card) each half of the
BEHZ multiply runs one cluster launch over the joint rows of ring q ∪ aux
(``behz_cuda.prep_ring``), a thread-block cluster of C = 2^k blocks a row.

- ``walk_prep_cluster`` moves B2's data as its launches do: the extension
  into the 32-bit scratch from its uint32 constant block, then, for every
  joint row, the cells of each block's columns read from the row's own
  source (x as int64 for a q row, the scratch for an aux row), the k cross
  stages with the word's lazy butterflies and the column tables, the slot
  of its owner's buffer each cell lands in, the row passes over the
  virtual limbs (``walk_rows``), the to-Montgomery epilogue and the paired
  16-byte stores (every element of a sub-row stored once).
- ``walk_finish_cluster`` moves B4's: every dq and da sub-row through the
  inverse row passes straight from device memory, its last window parked at
  its slots, each block's cells gathered from the C buffers, the inverse
  cross stages, the epilogue (n^-1 with the from-Montgomery folded in, per
  virtual limb), then the dq rows' end ``DecomposeQ`` (y_i = [t X_i
  (Q/q_i)^-1]_{q_i}) and the da rows' ``Store32`` as 32-bit cells, every
  (row, coefficient) written once, and the per-coefficient scale-back, all
  from the kernels' uint32 constant blocks.

Both are held bit for bit against the JAX package's ``behz_prep32`` /
``behz_finish32`` run on the CPU (interpret mode) at n = 256 and 1024 at
every cluster depth k = 1..3, with the tables the wrapper hands the kernel
at that depth, and at n = 2^15 (the wrapper's own depth, sub-rows of
2^``SUB_LOGN``) against the JAX package's NumPy composition (the XLA path
of its ``BfvEngine.mult``) on a low level of ``create_tpu_param(32768)``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lattisense_tpu.core import ntt as ref_ntt
from lattisense_tpu.core import u64 as ref_u
from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.ops.behz_pallas32 import behz_finish32 as ref_behz_finish32
from lattisense_tpu.ops.behz_pallas32 import behz_prep32 as ref_behz_prep32
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.schemes.bfv import BfvEngine as RefEngine

from lattisense_torch.core import u64 as tu
from lattisense_torch.ops import behz_cuda, ntt_cuda
from lattisense_torch.params import BfvParams
from lattisense_torch.schemes.bfv import BfvEngine
from tests.test_torch_fused_rows import scale_back, sh, u32
from tests.test_torch_ntt_cluster import cluster_columns, cross_stages
from tests.test_torch_ntt_schedule import Lazy32, below, walk_rows
from tests.test_torch_prep_bconv import extend32

CPU = torch.device('cpu')
M32 = tu.MASK32
LEVEL = 3          # L = 4 q limbs of a 6-prime chain (one special prime)


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    """One torch intra-op thread: the suite's parallel workers, each with a
    thread per core, would oversubscribe the host."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def cluster_map(logs, k):
    """The cluster's index maps at sub-rows of 2^logs and C = 2^k blocks:
    the columns (C_s, threads, cols), the cells each block's threads hold
    (C_s, threads, cols, C_r), the buffer slot of each column, and each
    element's slot."""
    C, sub = 1 << k, 1 << logs
    cols = cluster_columns(logs, k)
    cell = cols.unsqueeze(-1) + sub * torch.arange(C)
    assert torch.equal(cell.reshape(-1).sort().values, torch.arange(sub << k))
    slots = ntt_cuda.exchange_slot(cols, 32)
    assert torch.equal(slots.reshape(-1).sort().values, torch.arange(sub))
    return cols, cell, slots, ntt_cuda.exchange_slot(torch.arange(sub), 32)


def joint_tables(bz, k):
    """B1's cluster tables of the joint ring at depth k, as the wrapper hands
    them to B2's and B4's cluster launches, uint32 as int64 values."""
    joint = behz_cuda.prep_ring(bz)
    assert joint.moduli == bz.ring_q.moduli + bz.ring_aux.moduli
    tabs = {key: u32(v) for key, v in ntt_cuda.cluster_tables(joint, k).items()}
    R, C = len(joint.moduli), 1 << k
    assert torch.equal(tabs['q'], tabs['cols_q'].repeat_interleave(C))
    assert tuple(tabs['cols_fwd'].shape) == (R, C, 2) and tabs['fwd'].shape[0] == R * C
    return tabs


def pair_elements(logs):
    """The elements of a sub-row that the paired stores (``store_row_pairs``)
    write: thread ``lane``'s pair j holds elements 2 lane + {0, 1} +
    j 2^(logs - K + 1); each element once."""
    K, _ = ntt_cuda.schedule(logs)
    lane = torch.arange(1 << (logs - K)).reshape(-1, 1)
    j = torch.arange(1 << (K - 1)).reshape(1, -1)
    e = (lane << 1) | (j << (logs - K + 1))
    both = torch.stack([e, e + 1], dim=-1).reshape(-1)
    assert torch.equal(both.sort().values, torch.arange(1 << logs))
    return both


def walk_prep_cluster(x, bz, logs):
    """B2's cluster route on an int64 (..., L, n) CPU stack at sub-rows of
    2^logs: the extension, then one cluster of 2^k blocks a joint row."""
    L, T, n = len(bz.ring_q.moduli), len(bz.ring_aux.moduli), bz.ring_q.n
    R, k = L + T, n.bit_length() - 1 - logs
    C, sub = 1 << k, 1 << logs
    cols, cell, slots, by_slot = cluster_map(logs, k)
    tabs = joint_tables(bz, k)
    ext = extend32(x, bz).long() & M32                              # the uint32 scratch
    lead = x.shape[:-2]
    # block s reads the cells of its columns from its row's own source
    regs = torch.cat([(x & M32)[..., cell], ext[..., cell]], dim=-5)  # (.., R, C_s, thr, cols, C_r)
    q4 = tabs['cols_q'].reshape(R, 1, 1, 1)
    regs = cross_stages(list(regs.unbind(-1)), tabs['cols_fwd'], k, False, q4, Lazy32)
    buf = torch.full((*lead, R, C, sub), -1, dtype=torch.int64)
    for r in range(C):                                              # cell r -> block r's buffer
        buf[..., r, slots.reshape(-1)] = regs[r].reshape(*lead, R, -1)
    assert bool((buf >= 0).all())                                   # every slot written
    mine = buf[..., by_slot].reshape(*lead, R * C, sub)             # virtual limb k·C + s
    post = (tabs['r1'].reshape(-1, 1), tabs['r1_shoup'].reshape(-1, 1))
    f = walk_rows(mine, 32, tabs['q'].reshape(-1, 1), tabs['fwd'], False, post, staged=False)
    out = torch.empty_like(f)
    pairs = pair_elements(logs)
    out[..., pairs] = f[..., pairs]                                 # the 16-byte paired stores
    out = out.reshape(*lead, R, n)
    return out[..., :L, :], out[..., L:, :]


def walk_finish_cluster(dq, da, bz, logs):
    """B4's cluster route on CPU stacks dq (..., L, n) and da (..., T, n) at
    sub-rows of 2^logs: one cluster of 2^k blocks a joint row, then the
    scale-back."""
    L, T, n = len(bz.ring_q.moduli), len(bz.ring_aux.moduli), bz.ring_q.n
    R, k = L + T, n.bit_length() - 1 - logs
    C, sub = 1 << k, 1 << logs
    cols, cell, slots, by_slot = cluster_map(logs, k)
    tabs = joint_tables(bz, k)
    c = u32(behz_cuda._finish_consts(bz))
    lead = dq.shape[:-2]
    vq = tabs['q'].reshape(-1, 1)
    rows = torch.cat([dq, da], dim=-2)                              # the joint rows, int64
    z = walk_rows(rows.reshape(*lead, R * C, sub), 32, vq, tabs['inv'], True, lazy_end=True,
                  staged=False)
    assert below(z, 2 * vq)
    parked = torch.empty_like(z)
    parked[..., by_slot] = z                                        # the last window, parked
    parked = parked.reshape(*lead, R, C, sub)
    q4 = tabs['cols_q'].reshape(R, 1, 1, 1)
    # block s reads cell r of its columns from block r's buffer
    regs = cross_stages([parked[..., r, :][..., slots] for r in range(C)], tabs['cols_inv'], k,
                        True, q4, Lazy32)
    post = (tabs['n_inv_rinv'].reshape(R, C, 1, 1), tabs['n_inv_rinv_shoup'].reshape(R, C, 1, 1))
    tq, tqs, qhi, qhis = (c[j * L:(j + 1) * L].reshape(L, 1, 1, 1) for j in range(1, 5))
    assert torch.equal(c[:L], tabs['cols_q'][:L])
    out = torch.full((*lead, R, n), -1, dtype=torch.int64)
    for r in range(C):
        a = Lazy32.canon(Lazy32.shoup(regs[r], *post, q4) & M32, q4)         # the epilogue
        y = sh(sh(a[..., :L, :, :, :], tq, tqs, q4[:L]), qhi, qhis, q4[:L])  # DecomposeQ
        a = torch.cat([y, a[..., L:, :, :, :]], dim=-4)                      # Store32: X_aux
        out[..., (r * sub + cols).reshape(-1)] = a.reshape(*lead, R, -1)
    assert bool((out >= 0).all()) and int(out.max()) < 1 << 32     # each cell once, 32-bit
    return scale_back(out[..., :L, :], out[..., L:, :], c, L, T)


def behz_pair(n, level=LEVEL, t=257):
    """The port's and the JAX package's BehzMult on one 31-bit chain at n."""
    chain = ref_primes(n, 31, 6)
    q, p = chain[:5], chain[5:]
    bz = BfvEngine(BfvParams.create_custom(n, t, q, p, word_bits=32), CPU).behz(level)
    ref_bz = RefEngine(RefBfvParams.create_custom(n, t, q, p, word_bits=32)).behz(level)
    assert bz.ring_aux.moduli == ref_bz.ring_aux.moduli
    return bz, ref_bz


def residues(seed, moduli, n, lead):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, (*lead, n), dtype=np.uint64) for q in moduli],
                    axis=-2).astype(np.int64)


@functools.lru_cache(maxsize=None)
def prep_case(n):
    """An input stack and the JAX ``behz_prep32`` of it, once per n."""
    bz, ref_bz = behz_pair(n)
    x = residues(n, bz.ring_q.moduli, n, (2,))
    fq, fa = ref_behz_prep32(jnp.asarray(x.astype(np.uint32)), ref_bz)
    return bz, x, np.asarray(fq).astype(np.int64), np.asarray(fa).astype(np.int64)


@functools.lru_cache(maxsize=None)
def finish_case(n):
    """Input products and the JAX ``behz_finish32`` of them, once per n."""
    bz, ref_bz = behz_pair(n)
    dq = residues(n + 1, bz.ring_q.moduli, n, (2,))
    da = residues(n + 2, bz.ring_aux.moduli, n, (2,))
    out = ref_behz_finish32(jnp.asarray(dq.astype(np.uint32)), jnp.asarray(da.astype(np.uint32)),
                            ref_bz)
    return bz, dq, da, np.asarray(out).astype(np.int64)


@pytest.mark.parametrize('n', [256, 1024])
@pytest.mark.parametrize('k', [1, 2, 3])
def test_walk_prep_cluster_matches_reference(n, k):
    """B2's cluster route at clusters of 2, 4 and 8 blocks bit for bit
    against the JAX ``behz_prep32`` (interpret mode)."""
    bz, x, want_fq, want_fa = prep_case(n)
    fq, fa = walk_prep_cluster(torch.from_numpy(x), bz, n.bit_length() - 1 - k)
    assert np.array_equal(fq.numpy(), want_fq) and np.array_equal(fa.numpy(), want_fa)


@pytest.mark.parametrize('n', [256, 1024])
@pytest.mark.parametrize('k', [1, 2, 3])
def test_walk_finish_cluster_matches_reference(n, k):
    """B4's cluster route at clusters of 2, 4 and 8 blocks bit for bit
    against the JAX ``behz_finish32`` (interpret mode)."""
    bz, dq, da, want = finish_case(n)
    got = walk_finish_cluster(torch.from_numpy(dq), torch.from_numpy(da), bz,
                              n.bit_length() - 1 - k)
    assert np.array_equal(got.numpy(), want)


def test_walk_cluster_n32768_matches_reference():
    """Both halves at n = 2^15 with the wrapper's depth and tables
    (``ntt_cuda.cluster_depth``, sub-rows of 2^SUB_LOGN) on
    ``create_tpu_param(32768)`` at level 1, one polynomial, against the JAX
    package's NumPy composition of ``BfvEngine.mult``: extend, NTT,
    to-Montgomery; from-Montgomery, inverse NTT, ``scale_and_back``."""
    n, level = 1 << 15, 1
    assert behz_cuda.route(n) == 'cluster' and behz_cuda.route(n >> 1) == 'rows'
    logs = n.bit_length() - 1 - ntt_cuda.cluster_depth(n.bit_length() - 1)
    assert logs == ntt_cuda.SUB_LOGN
    bz = BfvEngine(BfvParams.create_tpu_param(n), CPU).behz(level)
    ref_bz = RefEngine(RefBfvParams.create_tpu_param(n)).behz(level)
    rq, ra = ref_bz.ring_q, ref_bz.ring_aux
    x = residues(15, bz.ring_q.moduli, n, (1,))
    fq, fa = walk_prep_cluster(torch.from_numpy(x), bz, logs)
    x32 = x.astype(np.uint32)
    want_fq = ref_u.to_mont(np, ref_ntt.ntt(np, x32, rq), rq.q, rq.pinv, rq.r2)
    want_fa = ref_u.to_mont(np, ref_ntt.ntt(np, ref_bz.extend(np, x32), ra), ra.q, ra.pinv, ra.r2)
    assert np.array_equal(fq.numpy(), want_fq.astype(np.int64))
    assert np.array_equal(fa.numpy(), want_fa.astype(np.int64))
    dq = residues(16, bz.ring_q.moduli, n, (1,))
    da = residues(17, bz.ring_aux.moduli, n, (1,))
    got = walk_finish_cluster(torch.from_numpy(dq), torch.from_numpy(da), bz, logs)
    dq_i = ref_ntt.intt(np, ref_u.from_mont(np, dq.astype(np.uint32), rq.q, rq.pinv), rq)
    da_i = ref_ntt.intt(np, ref_u.from_mont(np, da.astype(np.uint32), ra.q, ra.pinv), ra)
    assert np.array_equal(got.numpy(), ref_bz.scale_and_back(np, dq_i, da_i).astype(np.int64))


def test_routes_of_the_wrapper():
    """B2 and B4 take their row loops up to B1's row cap and the cluster
    route at 2^15 and 2^16, with the joint ring's cluster tables at B1's
    cluster depth: one virtual limb a block, the cross stages' tables a
    limb."""
    assert [behz_cuda.route(1 << b) for b in (1, 10, 14, 15, 16)] == \
        ['rows', 'rows', 'rows', 'cluster', 'cluster']
    assert behz_cuda.ROWS_MAX_LOGN == ntt_cuda.ROW_MAX_LOGN == 14
    assert not [key for key in ntt_cuda.launches if key.startswith('behz32_split')]
    assert {'behz32_prep_cluster', 'behz32_finish_cluster'} <= set(behz_cuda.launches)
    bz, _ = behz_pair(1024)
    for k in (1, 2, 3):
        tabs = joint_tables(bz, k)
        assert tabs['n_inv_rinv'].shape[0] == (len(bz.ring_q.moduli) + len(bz.ring_aux.moduli)) << k
