"""The schedules of kernels B3 (``csrc/ksw32.cu``) and B4
(``csrc/behz32.cu``), walked on the CPU.

A CUDA kernel has no CPU mode, but what it does with each row does not need
the card. ``walk_finish`` moves B4's rows as its three launches do: the dq
rows through kernel B1's passes (``walk`` of ``test_torch_ntt_schedule``)
with the from-Montgomery folded into n^-1 and each row ended by the q half
of the scale-back, y_i, the da rows likewise ended by X_aux,k, both as
32-bit rows, then the per-coefficient scale-back in the kernel's loop
order, from the uint32 constant block the kernel is handed. ``walk_switch``
does the same for B3's blocks of (ciphertext, row t): the mod-up of each
digit's row t at the forward's first window from x's limbs, the forward
passes, the key read at the chunk window's positions (each thread's E
consecutive elements) and accumulated at the parking slots, the inverse
passes from there, the 32-bit intermediate and the mod-down from its
constant block. Both are held bit for bit against the plain twins
``behz_finish_plain`` and ``KeySwitcher.switch_plain`` at n = 256 and 1024,
at levels with and without a ragged last digit, with ``output_ntt``; B3's
shape → route choice is checked too.

``walk_switch_cluster`` moves B3's cluster route (n = 2^15, 2^16 on the
card) the same way at a forced small sub-row: which block of the cluster
builds which cells of each digit row (the mod-up at its columns' cells),
the cross stages, the slot of its owner's buffer where each cell lands, the
row passes over the virtual limbs, the key product parked in each block's
accumulators, the inverse's park, gather and n^-1, and that every
(component, row, coefficient) of the 32-bit product is written once. It is
held against the JAX package's ``KeySwitcher.switch`` (NumPy).
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.schemes.keyswitch import KeySwitcher as RefKeySwitcher
from lattisense_tpu.schemes.types import KeySwitchKey as RefKeySwitchKey

from lattisense_torch.core import u64 as tu
from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_torch.ops import behz_cuda, ksw_cuda, ntt_cuda
from lattisense_torch.params import BfvParams
from lattisense_torch.schemes.bfv import BfvEngine
from lattisense_torch.schemes.keyswitch import KeySwitcher
from lattisense_torch.schemes.types import KeySwitchKey
from tests.test_torch_ntt_cluster import cluster_columns, cross_stages
from tests.test_torch_ntt_schedule import Lazy32, walk, walk_rows

CPU = torch.device('cpu')
M32 = tu.MASK32


def u32(table):
    """A uint32 constant block (int32 bits) as int64 values."""
    return table.long() & M32


def sh(a, w, ws, q):
    """The kernels' Shoup product on uint32 words: canonical for any a < 2^32."""
    r = (a * w - tu.mulhi(a, ws) * q) & M32
    return torch.where(r >= q, r - q, r)


def residues(seed, moduli, n, lead):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.integers(0, q, (*lead, n), dtype=np.int64)
                                      for q in moduli], axis=-2))


# ---------------------------------------------------------------------------
# B4
# ---------------------------------------------------------------------------

def scale_back(y, xa, c, L, T):
    """The scale-back kernel on (..., L, m) y rows and (..., T, m) X_aux
    rows, constant block c (the layout in csrc/behz32.cu), each B row folded
    into the sums as it is made."""
    Tb = T - 1
    edge = np.cumsum([0, L, L, L, L, L, L, L, T, T, T, T, T, L * T, L * T, Tb, Tb,
                      Tb * (L + 1), Tb * (L + 1), 3]).tolist()
    q, tq, tqs, qhi, qhis, bq, bqs, d, td, tds, qinv, qinvs, c1v, c1s, shi, shis, c2v, c2s, sc = (
        c[a:b] for a, b in zip(edge, edge[1:]))
    assert edge[-1] == len(c)
    msk = d[Tb]

    def aux_w(k):
        conv = sum(sh(y[..., i, :], c1v[i * T + k], c1s[i * T + k], d[k]) for i in range(L)) % d[k]
        tx = sh(xa[..., k, :], td[k], tds[k], d[k])
        w = sh((tx - conv) % d[k], qinv[k], qinvs[k], d[k])
        return sh(w, shi[k], shis[k], d[k]) if k < Tb else w

    acc = [torch.zeros_like(y[..., 0, :]) for _ in range(L)]
    conv_sk = torch.zeros_like(acc[0])
    for k in range(Tb):
        wd = aux_w(k)
        base = k * (L + 1)
        conv_sk = (conv_sk + sh(wd, c2v[base + L], c2s[base + L], msk)) % msk
        acc = [(acc[i] + sh(wd, c2v[base + i], c2s[base + i], q[i])) % q[i] for i in range(L)]
    alpha = sh((conv_sk - aux_w(Tb)) % msk, sc[0], sc[1], msk)
    out = []
    for i in range(L):
        amod = torch.where(alpha >= sc[2], (q[i] - (msk - alpha)) & M32, alpha)
        out.append((acc[i] - sh(amod, bq[i], bqs[i], q[i])) % q[i])
    return torch.stack(out, dim=-2)


def walk_finish(dq, da, bz):
    """B4's three launches on CPU stacks."""
    L, T = len(bz.ring_q.moduli), len(bz.ring_aux.moduli)
    c = u32(behz_cuda._finish_consts(bz))

    def inverse(x, ring):                      # B1's passes, n^-1·2^-32 folded in
        tabs = ntt_cuda.row_tables(ring)
        post = (u32(tabs['n_inv_rinv']).reshape(-1, 1),
                u32(tabs['n_inv_rinv_shoup']).reshape(-1, 1))
        return walk(x, ring, inverse=True, post=post)

    q = c[:L].reshape(-1, 1)
    tq, tqs, qhi, qhis = (c[k * L:(k + 1) * L].reshape(-1, 1) for k in range(1, 5))
    y = sh(sh(inverse(dq, bz.ring_q), tq, tqs, q), qhi, qhis, q)     # the dq rows' end
    xa = inverse(da, bz.ring_aux)                                     # the da rows' end
    assert int(max(y.max(), xa.max())) < 1 << 32                      # 32-bit rows
    return scale_back(y, xa, c, L, T)


@pytest.mark.parametrize('n', [256, 1024])
@pytest.mark.parametrize('level', [5, 2])
def test_walk_finish_matches_plain(n, level):
    chain = gen_ntt_primes(n, 31, 7)
    params = BfvParams.create_custom(n, 65537, list(chain[:6]), [chain[6]], word_bits=32)
    bz = BfvEngine(params, CPU).behz(level)
    dq = residues(n + level, bz.ring_q.moduli, n, (2, 3))
    da = residues(n + level + 1, bz.ring_aux.moduli, n, (2, 3))
    assert torch.equal(walk_finish(dq, da, bz), behz_cuda.behz_finish_plain(dq, da, bz))


# ---------------------------------------------------------------------------
# B3
# ---------------------------------------------------------------------------

def moddown(cin, c, L, alpha):
    """The mod-down kernel on (..., L+alpha, m) coefficient-domain residues
    from its constant block (the layout in csrc/ksw32.cu)."""
    edge = np.cumsum([0, L, L, L, L, alpha, alpha, alpha, alpha, alpha, alpha * L,
                      alpha * L]).tolist()
    q, hq, pi, pis, p, hp, rhi, rhis, fx, cv, cs = (c[a:b] for a, b in zip(edge, edge[1:]))
    assert edge[-1] == len(c)
    y = [sh((cin[..., L + k, :] + hp[k]) % p[k], rhi[k], rhis[k], p[k]) for k in range(alpha)]
    over = sum(yk * fx[k] for k, yk in enumerate(y))        # wraps as the kernel's uint64
    v = (over >> 62) & 3
    out = []
    for i in range(L):
        conv = sum(sh(y[k], cv[k * L + i], cs[k * L + i], q[i]) for k in range(alpha)) % q[i]
        num = ((cin[..., i, :] + hq[i]) % q[i] - conv) % q[i]
        out.append((sh(num, pi[i], pis[i], q[i]) + v) % q[i])
    return torch.stack(out, dim=-2)


def walk_switch(x, ksk, sw, level, output_ntt):
    """The fused B3 on CPU stacks: the blocks of every (ciphertext, row t) at
    once (row t on limb t of Q_ℓ ∪ P), then the mod-down kernel."""
    L, n = level + 1, sw.n
    alpha, beta = sw.alpha, sw.beta(level)
    T, BA = L + alpha, beta * alpha
    assert ksw_cuda.switch_route(n) == 'fused'
    logn = n.bit_length() - 1
    K, windows = ntt_cuda.schedule(logn)
    top = ntt_cuda.element_index(logn, windows[0][0])            # the forward's first window
    chunk = ntt_cuda.element_index(logn, 0)                      # its last
    E = 1 << K
    assert torch.equal(chunk, torch.arange(n).reshape(-1, E))    # base | i: E consecutive
    assert E % 2 == 0                                            # read in 16-byte pairs
    tabs = {k: u32(v) for k, v in ksw_cuda._consts(sw, level).items()}
    srcq, qhi, qhis = tabs['modup'][:BA], tabs['modup'][BA:2 * BA], tabs['modup'][2 * BA:3 * BA]
    qp = tabs['modup'][3 * BA:3 * BA + T]
    mv = tabs['modup'][3 * BA + T:3 * BA + T + BA * T]
    ms = tabs['modup'][3 * BA + T + BA * T:]
    q, pinv = tabs['inner'][:T].reshape(-1, 1), tabs['inner'][T:].reshape(-1, 1)
    assert torch.equal(q.reshape(-1), qp)
    ring_qp = get_rns_ring(tuple(sw.q_moduli[:L]) + sw.p_moduli, n, CPU)
    ntab = ntt_cuda.row_tables(ring_qp)
    slot = ntt_cuda.exchange_slot(chunk.reshape(-1), 32)          # the accumulators' slots
    lead = x.shape[:-2]
    acc = torch.zeros((*lead, 2, T, n), dtype=torch.int64)
    for d in range(beta):
        digit = torch.zeros((*lead, T, *top.shape), dtype=torch.int64)
        for k in range(alpha):                                   # limbs d·α + k, in order
            r = d * alpha + k
            if r >= L:
                break
            y = sh(x[..., r, :][..., top], qhi[r], qhis[r], srcq[r])               # (..., thr, E)
            terms = torch.stack([sh(y, mv[r * T + t], ms[r * T + t], qp[t]) for t in range(T)],
                                dim=-3)
            digit = (digit + terms) % qp.reshape(-1, 1, 1)
        rows = torch.empty((*lead, T, n), dtype=torch.int64)
        rows[..., top.reshape(-1)] = digit.reshape(*lead, T, n)
        f = walk(rows, ring_qp, inverse=False)
        for comp in range(2):
            key = torch.cat([ksk.key_q[d, comp, :L], ksk.key_p[d, comp]], dim=0)   # (T, n)
            prod = tu.mont_mul(f[..., chunk.reshape(-1)], key[:, chunk.reshape(-1)], q, pinv)
            acc[..., comp, :, slot] = (acc[..., comp, :, slot] + prod) % q
    post = (u32(ntab['n_inv']).reshape(-1, 1), u32(ntab['n_inv_shoup']).reshape(-1, 1))
    unparked = acc[..., ntt_cuda.exchange_slot(torch.arange(n), 32)]
    coef = walk(unparked, ring_qp, inverse=True, post=post)      # the (G, 2, T, n) intermediate
    assert int(coef.max()) < 1 << 32
    e = moddown(coef, tabs['moddown'], L, alpha)
    if output_ntt:
        e = ntt_cuda.ntt_plain(e, get_rns_ring(sw.q_moduli[:L], n, CPU))
    return e[..., 0, :, :], e[..., 1, :, :]


@pytest.mark.parametrize('n', [256, 1024])
@pytest.mark.parametrize('alpha,level,output_ntt', [
    (4, 5, False),      # L = 6, alpha = 4: the second digit is ragged
    (4, 5, True),
    (4, 3, False),      # one digit
    (2, 4, True),       # alpha = 2, ragged third digit
])
def test_walk_switch_matches_plain(n, alpha, level, output_ntt):
    chain = gen_ntt_primes(n, 31, 6 + alpha)
    q, p = tuple(chain[:6]), tuple(chain[6:])
    sw = KeySwitcher(q, p, n, CPU)
    beta = (len(q) + alpha - 1) // alpha
    ksk = KeySwitchKey(key_q=residues(7, q, n, (beta, 2)), key_p=residues(8, p, n, (beta, 2)))
    x = residues(n + level, q[:level + 1], n, (3,))
    got = walk_switch(x, ksk, sw, level, output_ntt)
    want = sw.switch_plain(x, ksk, level, output_ntt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_switch_route():
    assert [ksw_cuda.switch_route(1 << k) for k in (1, 10, 14, 15)] == \
        ['fused', 'fused', 'fused', 'cluster']


def walk_switch_cluster(x, ksk, sw, level, output_ntt, logs):
    """B3's cluster route on CPU stacks at sub-rows of 2^logs: the clusters
    of every (ciphertext, row t) at once, C = 2^k blocks each, then the
    mod-down kernel."""
    L, n = level + 1, sw.n
    alpha, beta = sw.alpha, sw.beta(level)
    T, BA = L + alpha, beta * alpha
    k = n.bit_length() - 1 - logs
    C, sub = 1 << k, 1 << logs
    cols = cluster_columns(logs, k)                                 # (C_s, threads, cols)
    # block s builds cells r·2^logs + c of its columns c, register j·C + r
    cell = cols.unsqueeze(-1) + sub * torch.arange(C)               # (C_s, threads, cols, C_r)
    assert torch.equal(cell.reshape(-1).sort().values, torch.arange(n))
    w = min(32, cols.shape[1])
    assert torch.equal(cell[0, :w, 0, 0], torch.arange(w))         # a warp's reads coalesce
    slots = ntt_cuda.exchange_slot(cols, 32)                        # cell r -> block r, this slot
    assert torch.equal(slots.reshape(-1).sort().values, torch.arange(sub))
    by_slot = ntt_cuda.exchange_slot(torch.arange(sub), 32)         # element e's slot
    tabs = {key: u32(v) for key, v in ksw_cuda._consts(sw, level).items()}
    srcq, qhi, qhis = tabs['modup'][:BA], tabs['modup'][BA:2 * BA], tabs['modup'][2 * BA:3 * BA]
    qp = tabs['modup'][3 * BA:3 * BA + T]
    mv = tabs['modup'][3 * BA + T:3 * BA + T + BA * T]
    ms = tabs['modup'][3 * BA + T + BA * T:]
    q, pinv = tabs['inner'][:T].reshape(-1, 1), tabs['inner'][T:].reshape(-1, 1)
    ring_qp = get_rns_ring(tuple(sw.q_moduli[:L]) + sw.p_moduli, n, CPU)
    ntab = {key: u32(v) for key, v in ntt_cuda.cluster_tables(ring_qp, k).items()}
    vq, q4 = ntab['q'].reshape(-1, 1), q.reshape(T, 1, 1, 1)
    assert torch.equal(vq, q.repeat_interleave(C, 0))
    lead = x.shape[:-2]
    acc = torch.zeros((*lead, 2, T, C, sub), dtype=torch.int64)    # parked: [.., s, slot]
    for d in range(beta):
        digit = torch.zeros((*lead, T, *cell.shape), dtype=torch.int64)
        for j in range(alpha):                                      # limbs d·α + j, in order
            r = d * alpha + j
            if r >= L:
                break
            y = sh(x[..., r, :][..., cell], qhi[r], qhis[r], srcq[r])
            terms = torch.stack([sh(y, mv[r * T + t], ms[r * T + t], qp[t]) for t in range(T)],
                                dim=-5)
            digit = (digit + terms) % qp.reshape(-1, 1, 1, 1, 1)
        regs = cross_stages(list(digit.unbind(-1)), ntab['cols_fwd'], k, False, q4, Lazy32)
        buf = torch.full((*lead, T, C, sub), -1, dtype=torch.int64)
        for r in range(C):                                          # to block r's buffer
            buf[..., r, slots.reshape(-1)] = regs[r].reshape(*lead, T, -1)
        assert bool((buf >= 0).all())                               # every slot written
        mine = buf[..., by_slot].reshape(*lead, T * C, sub)         # virtual limb t·C + s
        f = walk_rows(mine, 32, vq, ntab['fwd'], False, staged=False).reshape(*lead, T, C, sub)
        for comp in range(2):                                       # element s·2^logs + e
            key = torch.cat([ksk.key_q[d, comp, :L], ksk.key_p[d, comp]], dim=0)
            prod = tu.mont_mul(f, key.reshape(T, C, sub), q.reshape(T, 1, 1),
                               pinv.reshape(T, 1, 1))
            acc[..., comp, :, :, by_slot] = (acc[..., comp, :, :, by_slot] + prod) % q.reshape(T, 1, 1)
    coef = torch.empty((*lead, 2, T, n), dtype=torch.int64)
    hits = torch.zeros((2, T, n), dtype=torch.int64)
    post = (ntab['n_inv'].reshape(T, C, 1, 1), ntab['n_inv_shoup'].reshape(T, C, 1, 1))
    for comp in range(2):
        mine = acc[..., comp, :, :, :][..., by_slot].reshape(*lead, T * C, sub)
        z = walk_rows(mine, 32, vq, ntab['inv'], True, lazy_end=True, staged=False)
        parked = torch.empty_like(z)
        parked[..., by_slot] = z
        parked = parked.reshape(*lead, T, C, sub)
        # block s reads cell r of its columns from block r's accumulator
        regs = cross_stages([parked[..., r, :][..., slots] for r in range(C)], ntab['cols_inv'], k,
                            True, q4, Lazy32)
        for r in range(C):
            a = Lazy32.canon(Lazy32.shoup(regs[r], *post, q4) & M32, q4)
            coef[..., comp, :, (r * sub + cols).reshape(-1)] = a.reshape(*lead, T, -1)
            hits[comp, :, (r * sub + cols).reshape(-1)] += 1
    assert bool((hits == 1).all())                                  # each output written once
    assert int(coef.max()) < 1 << 32
    e = moddown(coef, tabs['moddown'], L, alpha)
    if output_ntt:
        e = ntt_cuda.ntt_plain(e, get_rns_ring(sw.q_moduli[:L], n, CPU))
    return e[..., 0, :, :], e[..., 1, :, :]


@pytest.mark.parametrize('n,k', [(256, 2), (1024, 3)])
@pytest.mark.parametrize('alpha,level,output_ntt', [
    (4, 5, False),      # L = 6, alpha = 4: the second digit is ragged
    (4, 5, True),
    (4, 3, False),      # one digit
    (2, 4, True),       # alpha = 2, ragged third digit
])
def test_walk_switch_cluster_matches_reference(n, k, alpha, level, output_ntt):
    """B3's cluster route at sub-rows of n / 2^k against the JAX package's
    ``KeySwitcher.switch`` on NumPy, same key and input."""
    chain = gen_ntt_primes(n, 31, 6 + alpha)
    q, p = tuple(chain[:6]), tuple(chain[6:])
    sw = KeySwitcher(q, p, n, CPU)
    beta = (len(q) + alpha - 1) // alpha
    ksk = KeySwitchKey(key_q=residues(7, q, n, (beta, 2)), key_p=residues(8, p, n, (beta, 2)))
    x = residues(n + level, q[:level + 1], n, (3,))
    got = walk_switch_cluster(x, ksk, sw, level, output_ntt, n.bit_length() - 1 - k)
    ref = RefKeySwitcher(q, p, n, 32)
    want = ref.switch(np, x.numpy().astype(np.uint32),
                      RefKeySwitchKey(key_q=ksk.key_q.numpy().astype(np.uint32),
                                      key_p=ksk.key_p.numpy().astype(np.uint32)),
                      level, output_ntt=output_ntt)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32), w)
