"""The limb-sharded engine view: each rank holds some RNS limbs of every
ciphertext, alone or with its coefficients sharded too.

The JAX package shards a bootstrap's limbs by placement: GSPMD inserts the
collectives where limbs meet (``tests/test_parallel.py``, the bootstrap
segments over ``limb`` and over ``limb × coeff``). The port states them: a
view of the CKKS engine (``make_sharded_engine`` in ``sharded_engine.py``
with ``LimbRows`` as its limb layout) whose ops take and return this rank's
limbs, on which

- every pointwise step and every NTT runs on the rank's own limbs (B1 or B5
  over its rows, or ``DistNtt`` over them with a coefficient axis);
- a key switch gathers the input's limbs, splits its digits over ``limb``
  (``ShardedKeySwitcher``, ``LimbCoeffKeySwitcher``: one psum_scatter of the
  inner product, a psum of the special rows) and keeps its own limbs of the
  output;
- the rescale's divide-and-round needs the last limb on every rank: one
  ``psum`` of it from its owner;
- ModRaise needs the base limbs on every rank (``whole_limbs``: one
  ``all_gather``), then lifts onto the rank's own limbs of the full chain.

The layout is cyclic: rank r of D holds limbs r, r + D, r + 2D, ... A level
drop removes the last limbs, so the ranks stay within one limb of each other
at every level (a contiguous block would go uneven as a bootstrap's level
falls by some twenty limbs, or need moving), and dropping levels is local. A
rank that holds no limb at a level (the bootstrap's input at level 0 on the
ranks past r = 0) holds an empty (..., 0, n) tensor, takes part in every
collective, and computes nothing.

The view takes CKKS only: BFV's BEHZ extension mixes all limbs in every
multiply.
"""

import torch

from ..core import ntt as ntt_mod
from ..core.rns import DivRoundLast, _col, _mont
from .sharded_engine import ShardedBootstrap, make_sharded_bootstrapper, make_sharded_engine


class LimbRows:
    """The cyclic limb layout over a mesh axis: rank r holds the limbs
    i ≡ r (mod D) of a stack of L limbs, in increasing order."""

    sharded = True

    def __init__(self, mesh, axis: str = 'limb'):
        self.mesh, self.axis = mesh, axis
        self.D = mesh.shape[axis]
        self.r = mesh.index(axis)
        self._idx: dict = {}

    def own(self, L: int) -> list:
        return list(range(self.r, L, self.D))

    def take(self, x, L: int):
        """This rank's limbs of a whole stack x (..., L, n)."""
        idx = self._idx.get(('take', L, x.device))
        if idx is None:
            idx = self._idx[('take', L, x.device)] = torch.tensor(self.own(L), dtype=torch.int64,
                                                                  device=x.device)
        return x.index_select(-2, idx)

    def gather(self, x, L: int):
        """Every rank's limbs → the whole stack (..., L, n) on every rank: one
        all_gather of ceil(L/D) rows a rank (zero rows pad the short ones)."""
        D = self.D
        k = -(-L // D)
        if x.shape[-2] < k:
            pad = torch.zeros((*x.shape[:-2], k - x.shape[-2], x.shape[-1]), dtype=x.dtype,
                              device=x.device)
            x = torch.cat([x, pad], dim=-2)
        g = self.mesh.all_gather(x.contiguous(), self.axis, x.dim() - 2)   # row r·k + j
        idx = self._idx.get(('gather', L, x.device))
        if idx is None:
            idx = self._idx[('gather', L, x.device)] = torch.tensor(
                [(i % D) * k + i // D for i in range(L)], dtype=torch.int64, device=x.device)
        return g.index_select(-2, idx)

    def row(self, x, L: int, i: int):
        """Limb i of a stack of L limbs on every rank, (..., 1, n): a psum of
        its owner's row and the others' zeros."""
        owner, j = i % self.D, i // self.D
        if owner == self.r:
            buf = x[..., j:j + 1, :].contiguous()
        else:
            buf = torch.zeros((*x.shape[:-2], 1, x.shape[-1]), dtype=x.dtype, device=x.device)
        return self.mesh.psum(buf, self.axis)


class LimbView:
    """The limb-aware overrides of the view (mixed in before the sharded
    engine class): the rescale, the level drop, constant columns and the
    whole base limbs of ModRaise."""

    def rescale(self, ct):
        """Divide by the last prime with exact rounding: the INTT of the own
        limbs, the last limb from its owner, the divide-and-round of the own
        limbs below it, the NTT over the shorter chain."""
        level = ct.level
        rows = self._sh_rows
        coeff = ntt_mod.intt(ct.data.contiguous(), self.ring(level))
        last = rows.row(coeff, level + 1, level)
        own = rows.own(level)
        rest = coeff[..., :len(own), :]
        if own:
            rs = self._sh_rescaler.get(level)
            if rs is None:
                rs = self._sh_rescaler[level] = DivRoundLast(
                    tuple(self.q[i] for i in own) + (self.q[level],), self.device,
                    self.word_bits)
            rest = rs(torch.cat([rest, last], dim=-2))
        data = ntt_mod.ntt(rest.contiguous(), self.ring(level - 1))
        return self._ct(data, ct, level=level - 1, scale=ct.scale / self.q[level])

    def drop_level(self, ct, levels: int = 1):
        k = len(self._sh_rows.own(ct.level + 1 - levels))
        return self._ct(ct.data[..., :k, :], ct, level=ct.level - levels)

    def mont_col(self, value: int, level: int):
        return _col([_mont(value % self.q[i], self.q[i], self.word_bits)
                     for i in self._sh_rows.own(level + 1)], self.device)

    def whole_limbs(self, x, level: int):
        return self._sh_rows.gather(x, level + 1)


def make_limb_sharded_engine(engine, mesh):
    """The view of a ``CkksEngine`` (either word) whose ops take and return
    this rank's limbs over ``mesh``'s ``limb`` axis (``LimbRows``) and, when
    the mesh has a ``coeff`` axis, its coefficients over that."""
    if hasattr(engine, 'behz'):
        raise ValueError('the limb-sharded view takes a CkksEngine: the BEHZ extension of a '
                         'BFV multiply mixes every limb')
    if mesh.shape['limb'] < 2:
        raise ValueError('the limb axis has one rank')
    coeff = 'coeff' if mesh.shape['coeff'] > 1 else None
    eng = make_sharded_engine(engine, mesh, LimbRows(mesh), coeff, mixin=LimbView)
    eng._sh_rescaler = {}
    return eng


class LimbShardedBootstrap(ShardedBootstrap):
    """``ShardedBootstrap`` on the limb view of ``mesh`` (limb, or limb ×
    coeff): each rank refreshes its limbs (and coefficients) of one
    ciphertext."""

    def __init__(self, ctx, mesh):
        super().__init__(ctx, make_sharded_bootstrapper(
            ctx.engine.bootstrapper, make_limb_sharded_engine(ctx.engine, mesh)))
