"""Coefficient-axis (ring-dimension) sharding: the distributed NTT and the
coefficient-sharded key switches, rotation and relinearization.

Port of the primitives of ``lattisense_tpu/parallel/coeff_sharded.py``. One
polynomial's n coefficients are split contiguously over the mesh's ``coeff``
axis: rank d holds x[d·C:(d+1)·C], C = n/D.

Distributed four-step negacyclic NTT (n = R·C with R = D):

1. pre-scale by ψ^j (pointwise, local);
2. ``all_to_all`` #1: transpose the (R, C) view, so each rank holds all R
   rows of its C/D-column chunk;
3. an R-point DFT across the former rank axis (a small dense modular product
   with ω^{C·jr·kr}), then the four-step twiddle ω^{jc·kr} merged with the
   C-point ring's ψ_C^{-jc}, which turns step 5's transform into the plain
   negacyclic C-point NTT;
4. bit-reverse the kr axis and ``all_to_all`` #2, so rank d receives row
   kr = brv(d) over all columns;
5. the local C-point NTT over the moduli's ring at degree C.

The output lands sharded in the single-device order: out[d·C + t] is the
brv_n-ordered evaluation, so every pointwise step after it (base
conversions, gadget products, mod-down) stays local. The inverse mirrors the
steps (the local INTT divides by C; R^-1 is folded into the inverse R-point
constants). Step 5 is a genuine ring: the moduli at degree C
(``get_rns_ring(moduli, C)``), whose psi the twiddles of step 3 are built
from, so on the card it is B1 or B5 with that ring's own tables (B1 and B5
key their cached pass tables by the ring, and a degree-C ring is a ring of
its own), never a full-n ring's tables.

The key switchers are ``ShardedKeySwitcher`` (``keyswitch_sharded.py``) with
a coefficient axis: digit decomposition, FastBConv, the gadget product and
the mod-down are pointwise and local, the NTTs are the distributed bodies
above (4 ``all_to_all``s a switch), and keys live coefficient-sharded.
``LimbCoeffKeySwitcher`` adds the limb axis's digit split and
``psum_scatter``. The rotation is ``galois_body``: an ``all_gather`` of the
coefficient axis, then a static gather with sign flips that keeps this rank's
chunk.

Entries on whole tensors (``DistNtt.ntt``/``intt``, the switchers'
``__call__``, the rotator and relinearizer) take whole polynomials on every
rank and return whole results (gathered over ``coeff``); the ``*_body``
methods work on this rank's local shards.
"""

import functools

import numpy as np
import torch

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import bit_reverse_indices, get_rns_ring
from ..core.rns import _shoup
from ..schemes.galois import coeff_automorphism_maps
from .keyswitch_sharded import ShardedKeySwitcher


def _powers(start: int, step: int, count: int, q: int) -> list:
    """start·step^k mod q for k < count."""
    out = []
    for _ in range(count):
        out.append(start)
        start = start * step % q
    return out


@functools.lru_cache(maxsize=None)
def _dist_rows(q: int, psi: int, psiC: int, n: int, D: int, d: int, word_bits: int) -> dict:
    """One modulus's rows of rank d's ``DistNtt`` tables: {name: (values,
    Shoup companions)} as int64 arrays, made once a (modulus, rank, degree)
    and shared by every ``DistNtt`` that holds the modulus (a key switch at
    each level of a bootstrap builds one over its Q_ℓ ∪ P)."""
    R, C = D, n // D
    chunk = C // D
    logR = R.bit_length() - 1
    kr_mine = int(bit_reverse_indices(logR)[d]) if logR else 0
    psi_inv = pow(psi, -1, q)
    om = psi * psi % q
    om_inv = pow(om, -1, q)
    psiC_inv = pow(psiC, -1, q)
    R_inv = pow(R, -1, q)
    omC, omC_inv = pow(om, C, q), pow(om_inv, C, q)
    vals = {
        # this rank's ψ^j, ψ^-j for j in [d·C, (d+1)·C)
        'pre': _powers(pow(psi, d * C, q), psi, C, q),
        'post': _powers(pow(psi_inv, d * C, q), psi_inv, C, q),
        'WR': [[pow(omC, kr * jr, q) for jr in range(R)] for kr in range(R)],
        # R^-1 folded into the inverse product, (jr, kr) layout
        'WRi': [[pow(omC_inv, kr * jr, q) * R_inv % q for kr in range(R)] for jr in range(R)],
        # twf: ω^{jc·kr}·ψ_C^{-jc} for this rank's columns jc
        'twf': [_powers(pow(om, d * chunk * kr, q) * pow(psiC_inv, d * chunk, q) % q,
                        pow(om, kr, q) * psiC_inv % q, chunk, q) for kr in range(R)],
        # twi: ω^{-jc·kr}·ψ_C^{jc} for the row kr = brv(d) this rank holds
        'twi': _powers(1, pow(om_inv, kr_mine, q) * psiC % q, C, q),
    }

    def arr(v, f=int):
        return np.vectorize(lambda x: _u.to_s64(f(int(x))), otypes=[np.int64])(
            np.asarray(v, dtype=object))
    return {k: (arr(v), arr(v, lambda x: _shoup(x, q, word_bits))) for k, v in vals.items()}


class DistNtt:
    """Distributed four-step negacyclic NTT/INTT of ``moduli`` at degree n
    over one mesh axis, holding this rank's slices of the tables."""

    def __init__(self, moduli, n: int, mesh, axis: str = 'coeff', word_bits: int = 64):
        self.moduli = tuple(int(m) for m in moduli)
        self.n, self.mesh, self.axis, self.word_bits = n, mesh, axis, word_bits
        D = mesh.shape[axis]
        if D < 2 or D & (D - 1):
            raise ValueError(f'coeff mesh axis must be a power of two >= 2, got {D}')
        if n % (D * D):
            raise ValueError(f'n={n} must be divisible by D^2={D * D}')
        self.D = R = D
        self.C = C = n // D
        self.word = _u.word(word_bits)
        d = mesh.index(axis)
        dev = mesh.device
        self.ring_n = get_rns_ring(self.moduli, n, dev, word_bits)
        ring_C = get_rns_ring(self.moduli, C, dev, word_bits)
        logR = R.bit_length() - 1
        brvR = [int(v) for v in bit_reverse_indices(logR)]
        self._brvR = torch.tensor(brvR, dtype=torch.int64, device=dev)
        rows = [_dist_rows(q, self.ring_n.rings[l].psi, ring_C.rings[l].psi, n, D, d, word_bits)
                for l, q in enumerate(self.moduli)]

        def table(key):
            return (torch.from_numpy(np.stack([r[key][0] for r in rows])).to(dev),
                    torch.from_numpy(np.stack([r[key][1] for r in rows])).to(dev))
        self.pre, self.pre_sh = table('pre')          # (L, C)
        self.post, self.post_sh = table('post')       # (L, C)
        self.WR, self.WR_sh = table('WR')             # (L, kr, jr)
        self.WRi, self.WRi_sh = table('WRi')          # (L, jr, kr)
        self.twf, self.twf_sh = table('twf')          # (L, kr, C/D)
        self.twi, self.twi_sh = table('twi')          # (L, C)
        self.q = self.ring_n.q                        # (L, 1)

    def _ring_C(self, lo: int, size: int):
        return get_rns_ring(self.moduli[lo:lo + size], self.C, self.mesh.device, self.word_bits)

    def fwd_body(self, x, rows=None):
        """x: this rank's shard (..., L, C), coefficient domain → its shard of
        the bit-reversed NTT. ``rows=(start, size)`` transforms the rows
        start..start+size of the moduli (x's L axis is that many)."""
        lo, size = rows or (0, len(self.moduli))
        w, D, C, axis = self.word, self.D, self.C, self.axis
        sl = slice(lo, lo + size)
        q2 = self.q[sl]
        q3, q4 = q2[:, None], q2[:, None, None]
        x = w.shoup_mul(x, self.pre[sl], self.pre_sh[sl], q2)
        lead = x.shape[:-1]
        xs = self.mesh.all_to_all(x.reshape(*lead, D, C // D), axis, -2, -2)  # (.., L, jr, C/D)
        terms = w.shoup_mul(xs[..., None, :, :], self.WR[sl][:, :, :, None],
                            self.WR_sh[sl][:, :, :, None], q4)
        B = w.modsum(terms, q3, dim=-2)                                        # (.., L, kr, C/D)
        B = w.shoup_mul(B, self.twf[sl], self.twf_sh[sl], q3)
        B = B.index_select(-2, self._brvR)
        B = self.mesh.all_to_all(B, axis, -2, -1)                              # (.., L, 1, C)
        return ntt_mod.ntt(B.reshape(*lead, C).contiguous(), self._ring_C(lo, size))

    def inv_body(self, y, rows=None):
        """Inverse of ``fwd_body``: this rank's shard of the bit-reversed NTT
        → its shard of the natural-order coefficients (× n^-1)."""
        lo, size = rows or (0, len(self.moduli))
        w, D, C, axis = self.word, self.D, self.C, self.axis
        sl = slice(lo, lo + size)
        q2 = self.q[sl]
        q3, q4 = q2[:, None], q2[:, None, None]
        z = ntt_mod.intt(y.contiguous(), self._ring_C(lo, size))
        z = w.shoup_mul(z, self.twi[sl], self.twi_sh[sl], q2)                # B[kr=brv(d), jc]
        lead = z.shape[:-1]
        zs = self.mesh.all_to_all(z.reshape(*lead, D, C // D), axis, -2, -2)  # src s → brv(s)
        zs = zs.index_select(-2, self._brvR)                                   # natural kr
        terms = w.shoup_mul(zs[..., None, :, :], self.WRi[sl][:, :, :, None],
                            self.WRi_sh[sl][:, :, :, None], q4)
        M = w.modsum(terms, q3, dim=-2)                                        # (.., L, jr, C/D)
        M = self.mesh.all_to_all(M, axis, -2, -1).reshape(*lead, C)
        return w.shoup_mul(M, self.post[sl], self.post_sh[sl], q2)

    def _local(self, x):
        return x.narrow(-1, self.mesh.index(self.axis) * self.C, self.C).contiguous()

    def ntt(self, x):
        """Whole (..., L, n) coefficient domain → the whole bit-reversed NTT,
        computed coefficient-sharded: bit for bit ``core/ntt.py``."""
        return self.mesh.all_gather(self.fwd_body(self._local(x)), self.axis, -1)

    def intt(self, x):
        return self.mesh.all_gather(self.inv_body(self._local(x)), self.axis, -1)


class CoeffShardedKeySwitcher(ShardedKeySwitcher):
    """Hybrid key switch with the coefficient axis sharded: every stage but
    the NTTs is pointwise and local; the distributed NTT's transposes are
    the only traffic. The mesh's limb axis must be 1 (with a limb axis, use
    ``LimbCoeffKeySwitcher``)."""

    def __init__(self, switcher, level: int, mesh, axis: str = 'coeff'):
        if mesh.shape['limb'] != 1:
            raise ValueError('CoeffShardedKeySwitcher takes a mesh without a limb axis; '
                             'use LimbCoeffKeySwitcher')
        super().__init__(switcher, level, mesh, coeff_axis=axis)

    def prep_keys(self, ksk):
        """KeySwitchKey → this rank's coefficient shard of its digits."""
        return self.pad_keys(ksk.key_q, ksk.key_p)

    def decompose_modup_ntt_body(self, x):
        """x local (..., L, C) → NTT-domain digits (..., β, T, C): the
        hoisted entry under coefficient sharding."""
        return self._local_digits(x)

    def from_digits_body(self, xd, kd):
        """Gadget product, distributed INTT, mod-down: (2, L, C) local."""
        e0, e1 = self._tail(xd, kd)
        return torch.stack([e0, e1], dim=-3)

    def switch_body(self, x, kd):
        return self.from_digits_body(self.decompose_modup_ntt_body(x), kd)

    def __call__(self, x, key_q, key_p):
        """x (..., L, n) whole → (e0, e1) whole over Q_ℓ, bit for bit
        ``KeySwitcher.switch``."""
        e0, e1 = self.traced(self.local(x).contiguous(), self.pad_keys(key_q, key_p))
        return (self.mesh.all_gather(e0, self.coeff_axis, -1),
                self.mesh.all_gather(e1, self.coeff_axis, -1))


class LimbCoeffKeySwitcher(ShardedKeySwitcher):
    """The two-dimensional switch over (limb, coeff): digits split over
    ``limb`` with one psum_scatter, polynomials over ``coeff`` with the
    distributed NTT's all_to_alls."""

    def __init__(self, switcher, level: int, mesh, limb_axis: str = 'limb',
                 coeff_axis: str = 'coeff'):
        super().__init__(switcher, level, mesh, axis=limb_axis, coeff_axis=coeff_axis)

    def __call__(self, x, key_q, key_p):
        e0, e1 = self.traced(self.local(x).contiguous(), self.pad_keys(key_q, key_p))
        return (self.mesh.all_gather(e0, self.coeff_axis, -1),
                self.mesh.all_gather(e1, self.coeff_axis, -1))


def galois_body(mesh, x, src, neg, q_col, axis: str, C: int):
    """σ_g on a coefficient-domain local shard x (..., L, C): all_gather the
    coefficient axis, static gather with the sign flips of x^n = -1, keep
    this rank's chunk. ``src`` and ``neg`` are the whole maps (n,)."""
    d = mesh.index(axis)
    full = mesh.all_gather(x, axis, x.dim() - 1)
    vals = full.index_select(-1, src[d * C:(d + 1) * C])
    negv = torch.where(vals == 0, vals, q_col - vals)
    return torch.where(neg[d * C:(d + 1) * C], negv, vals)


class CoeffShardedRotator:
    """Coefficient-sharded rotation: σ_g on both polynomials, then the
    coefficient-sharded key switch of σ_g(c1) (``apply_galois`` on a
    coefficient-domain ciphertext)."""

    def __init__(self, switcher, level: int, mesh, galois_elt: int, axis: str = 'coeff'):
        self.ks = CoeffShardedKeySwitcher(switcher, level, mesh, axis)
        self.elt, self.mesh, self.axis = galois_elt, mesh, axis
        src, neg = coeff_automorphism_maps(switcher.n, galois_elt)
        self._src = torch.from_numpy(src).to(mesh.device)
        self._neg = torch.from_numpy(neg.astype(bool)).to(mesh.device)
        self._q = self.ks.ring_qp.q[:level + 1]

    def body(self, ct, kd):
        """ct local (..., 2, L, C) → the rotated local shard."""
        rot = galois_body(self.mesh, ct, self._src, self._neg, self._q, self.axis,
                          self.ks.n_loc)
        e = self.ks.switch_body(rot[..., 1, :, :], kd)
        c0 = _u.addmod(rot[..., 0, :, :], e[..., 0, :, :], self._q)
        return torch.stack([c0, e[..., 1, :, :]], dim=-3)

    def __call__(self, ct_data, glk):
        """ct_data (..., 2, L, n) whole → whole, bit for bit
        ``apply_galois`` on a coefficient-domain ciphertext."""
        out = self.body(self.ks.local(ct_data).contiguous(), self.ks.prep_keys(glk))
        return self.mesh.all_gather(out, self.axis, -1)


class CoeffShardedRelin:
    """Coefficient-sharded relinearization ct3 → ct (``relinearize``)."""

    def __init__(self, switcher, level: int, mesh, axis: str = 'coeff'):
        self.ks = CoeffShardedKeySwitcher(switcher, level, mesh, axis)
        self.mesh, self.axis = mesh, axis
        self._q = self.ks.ring_qp.q[:level + 1]

    def body(self, ct3, kd):
        """ct3 local (..., 3, L, C) → (..., 2, L, C)."""
        e = self.ks.switch_body(ct3[..., 2, :, :], kd)
        c0 = _u.addmod(ct3[..., 0, :, :], e[..., 0, :, :], self._q)
        c1 = _u.addmod(ct3[..., 1, :, :], e[..., 1, :, :], self._q)
        return torch.stack([c0, c1], dim=-3)

    def __call__(self, ct3_data, rlk):
        out = self.body(self.ks.local(ct3_data).contiguous(), self.ks.prep_keys(rlk))
        return self.mesh.all_gather(out, self.axis, -1)
