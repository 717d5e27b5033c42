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
"""

import numpy as np
import pytest
import torch

from lattisense_torch.core import u64 as tu
from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_torch.ops import behz_cuda, ksw_cuda, ntt_cuda
from lattisense_torch.params import BfvParams
from lattisense_torch.schemes.bfv import BfvEngine
from lattisense_torch.schemes.keyswitch import KeySwitcher
from lattisense_torch.schemes.types import KeySwitchKey
from tests.test_torch_ntt_schedule import walk

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
        tabs = ntt_cuda._tables(ring)
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
    ntab = ntt_cuda._tables(ring_qp)
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
        ['fused', 'fused', 'fused', 'split']
