"""Sharded ENGINE views: the unmodified scheme layer on this rank's shards.

Port of ``lattisense_tpu/parallel/sharded_engine.py``. ``parallel/
coeff_sharded.py`` has the primitives (``DistNtt``, the coefficient-sharded
key switchers); this module composes them into an engine VIEW whose every
transform runs on this rank's shard, so that the scheme layer — the
``CkksEngine`` and ``BfvEngine`` ops, ``EncodedLinearTransform``'s BSGS,
``ChebyshevEvaluator`` and the whole ``CkksBootstrapper`` — runs sharded
without a change to that code.

The JAX package is single-controller: its view is used inside a
``shard_map``, whose body sees the local shards. The port is SPMD (one
process a rank, ``parallel/launch.py``), so the view is simply this rank's
engine: every evaluation op takes and returns this rank's shards, and
``shard_ct`` / ``gather_ct`` cut a whole ciphertext into them and put it back
together. The seams:

- ``ring(level)`` is a ``ShardedRing``: this rank's rows of the per-limb
  constants (pointwise steps broadcast over local coefficients unchanged)
  and ``dist``, the transform of its shard, to which ``core.ntt.ntt`` /
  ``intt`` dispatch: ``DistNtt`` over the coefficient axis (two
  ``all_to_all``s a transform, B1 or B5 on the degree-C ring inside).
- ``behz(level)`` (BFV): a ``BehzMult`` whose dual-basis rings are such
  views; every BEHZ stage but the NTTs is pointwise per coefficient, so the
  whole ct × ct multiply runs sharded. A ring that carries ``dist`` turns
  the fused 32-bit kernels B2 and B4 off (``schemes/bfv.py``), and the view's
  switcher never calls B3: each holds a full-length NTT in its body, and a
  coefficient shard is not a ring row. The tensor product (B8) is pointwise
  per coefficient and runs on the shard.
- ``switcher`` is ``ShardedKeySwitcher`` per level over the mesh's ``limb``
  axis and, with a coefficient axis, its ``coeff`` axis
  (``CoeffShardedKeySwitcher``, ``LimbCoeffKeySwitcher``): digit
  decomposition, mod-up, gadget product and mod-down are pointwise per
  coefficient and local; the digits split over ``limb``.
- the automorphisms under ``apply_galois`` and ``apply_galois_decomposed``
  (the engines' ``_auto_ntt`` / ``_auto_coeff``): in the NTT domain a global
  permutation of the evaluation points, one ``all_gather`` over ``coeff``
  and a local take; in the coefficient domain ``galois_body``.
- plaintext operands, which the host entries (``encode*``, the base
  engine's) make whole, are cut to this rank's shard at op entry;
  ``PlaintextRingt`` is refused, as in the JAX package.
- the limb rows: a view may also hold only some RNS limbs of each
  ciphertext (``parallel/limb_engine.py``, ``LimbRows``); here ``rows`` is
  ``AllRows``, every limb on every rank.

Host entries (encode, encrypt, decrypt) are the base engine's, on whole
polynomials.

The reference never splits one ciphertext across devices; this is the
capability the JAX package adds to lift the limb axis's width cap.
"""

import copy
import functools

import torch

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..schemes.galois import coeff_automorphism_maps, ntt_automorphism_perm
from ..schemes.types import Plaintext, PlaintextMul, PlaintextRingt
from .coeff_sharded import (CoeffShardedKeySwitcher, DistNtt, LimbCoeffKeySwitcher,
                            galois_body)
from .keyswitch_sharded import ShardedKeySwitcher


class AllRows:
    """The limb layout of a view that holds every limb on every rank."""

    sharded = False

    def own(self, L: int) -> list:
        return list(range(L))

    def take(self, x, L: int):
        return x

    def gather(self, x, L: int):
        return x


class _NoRows:
    """The ring of a rank that holds no limb at this level (a limb-sharded
    view below the limb axis's width): empty constants, identity transforms."""

    def __init__(self, n: int, device, word_bits: int):
        self.n, self.device, self.word_bits = n, device, word_bits
        self.word = _u.word(word_bits)
        self.moduli = ()
        self.q = self.pinv = self.r2 = torch.zeros((0, 1), dtype=torch.int64, device=device)
        self.dist = self

    def fwd_body(self, x):
        return x

    def inv_body(self, x):
        return x


class ShardedRing:
    """A ring whose NTT/INTT are those of this rank's shard (``dist``); every
    other attribute is ``host``'s, the ring of this rank's limbs at degree n."""

    def __init__(self, host, dist):
        self.host = host
        self.dist = dist

    def __getattr__(self, name):            # q, pinv, r2, moduli, word, n, ...
        return getattr(self.host, name)


class _SwitcherView:
    """``KeySwitcher`` surface (``switch``, ``switch_from_digits``,
    ``decompose_modup_ntt``) with sharded bodies: a ``ShardedKeySwitcher``
    a level over the view's axes. Inputs and outputs are the view's shards;
    under limb rows the input's limbs are gathered first and the output's
    own limbs kept. A key's digit group and coefficients are made once and
    kept with the key they came from, so a captured graph reads them in
    place."""

    def __init__(self, eng):
        self.base = eng._sh_base.switcher
        self.eng = eng
        self._sk: dict = {}
        self._kd: dict = {}

    def __getattr__(self, name):            # q_moduli, p_moduli, alpha, beta, n, ...
        return getattr(self.base, name)

    def at(self, level: int) -> ShardedKeySwitcher:
        sk = self._sk.get(level)
        if sk is None:
            mesh, coeff = self.eng._sh_mesh, self.eng._sh_coeff
            if coeff is None:
                sk = ShardedKeySwitcher(self.base, level, mesh)
            elif mesh.shape['limb'] == 1:
                sk = CoeffShardedKeySwitcher(self.base, level, mesh, coeff)
            else:
                sk = LimbCoeffKeySwitcher(self.base, level, mesh, coeff_axis=coeff)
            self._sk[level] = sk
        return sk

    def keys(self, ksk, level: int):
        k = (ksk.key_q.data_ptr(), ksk.key_p.data_ptr(), tuple(ksk.key_q.shape), level)
        hit = self._kd.get(k)
        if hit is None:
            hit = self._kd[k] = (ksk.key_q, ksk.key_p,
                                 self.at(level).pad_keys(ksk.key_q, ksk.key_p))
        return hit[2]

    def decompose_modup_ntt(self, x, level: int):
        """This rank's x (..., L_own, C) → its digit group's NTT-domain digits
        (..., β_pad/D, T, C)."""
        x = self.eng._sh_rows.gather(x, level + 1)
        return self.at(level)._local_digits(x.contiguous())

    def switch_from_digits(self, digits, ksk, level: int, output_ntt: bool = False):
        e0, e1 = self.at(level).traced_from_digits(digits, self.keys(ksk, level))
        e = self.eng._sh_rows.take(torch.stack([e0, e1], dim=-3), level + 1)
        if output_ntt:
            e = ntt_mod.ntt(e.contiguous(), self.eng.ring(level))
        return e[..., 0, :, :], e[..., 1, :, :]

    def switch(self, x, ksk, level: int, output_ntt: bool = False):
        return self.switch_from_digits(self.decompose_modup_ntt(x, level), ksk, level,
                                       output_ntt)


# the base engine's host entries, which a view hands on unchanged (whole
# polynomials, all limbs)
_HOST = ('encode', 'encode_const', 'encode_ringt', 'encode_mul', 'encode_coeffs',
         'encode_coeffs_ringt', 'encode_coeffs_mul', 'decode', 'encrypt_asymmetric',
         'encrypt_symmetric', 'encrypt_symmetric_compressed', 'decompress_ciphertext',
         'decrypt', 'decrypt_coeffs', 'decrypt_decode', 'noise_budget')


def _host_entry(name):
    def entry(self, *args, **kwargs):
        return getattr(self._sh_base, name)(*args, **kwargs)
    entry.__name__ = name
    return entry


def _make_subclass(cls):
    """Engine subclass with the sharded overrides (one a class)."""

    class Sharded(cls):
        # -- rings -------------------------------------------------------
        def _sh_ring(self, moduli):
            """The view's ring of ``moduli`` (this rank's limbs)."""
            r = self._sh_rings.get(moduli)
            if r is None:
                dev, wb = self.device, self.word_bits
                if not moduli:
                    r = _NoRows(self.n, dev, wb)
                elif self._sh_coeff is None:
                    r = get_rns_ring(moduli, self.n, dev, wb)
                else:
                    r = ShardedRing(get_rns_ring(moduli, self.n, dev, wb),
                                    DistNtt(moduli, self.n, self._sh_mesh, self._sh_coeff, wb))
                self._sh_rings[moduli] = r
            return r

        def ring(self, level: int):
            return self._sh_ring(tuple(self.q[i] for i in self._sh_rows.own(level + 1)))

        def behz(self, level: int):
            """``BehzMult`` whose dual-basis rings are coefficient-sharded
            views (coefficient axis only: the BEHZ extension mixes limbs)."""
            v = self._sh_behz.get(level)
            if v is None:
                base = self._sh_base.behz(level)
                v = copy.copy(base)
                v.ring_q = self._sh_ring(base.ring_q.moduli)
                v.ring_aux = self._sh_ring(base.ring_aux.moduli)
                self._sh_behz[level] = v
            return v

        # -- shards ------------------------------------------------------
        def _sh_local(self, x):
            """This rank's coefficients of whole polynomials (..., n)."""
            if self._sh_coeff is None:
                return x
            C = self.n // self._sh_mesh.shape[self._sh_coeff]
            return x.narrow(-1, self._sh_mesh.index(self._sh_coeff) * C, C).contiguous()

        def shard_ct(self, ct):
            """A whole ciphertext → this rank's shard (its limbs, its
            coefficients)."""
            data = self._sh_rows.take(self._sh_local(ct.data), ct.level + 1)
            return _replace(ct, data.contiguous())

        def gather_ct(self, ct):
            """This rank's shard → the whole ciphertext, on every rank."""
            data = ct.data
            if self._sh_coeff is not None:
                data = self._sh_mesh.all_gather(data, self._sh_coeff, data.dim() - 1)
            return _replace(ct, self._sh_rows.gather(data, ct.level + 1))

        def _sh_pt(self, b, level: int):
            """A whole plaintext operand cut to this rank's shard."""
            if self._sh_coeff is None and not self._sh_rows.sharded:
                return b
            if isinstance(b, PlaintextRingt):
                raise NotImplementedError(
                    'PlaintextRingt operands are not supported under sharding '
                    '(encode to Plaintext or PlaintextMul)')
            if isinstance(b, (Plaintext, PlaintextMul)):
                data = self._sh_local(b.data)
                if self._sh_rows.sharded:
                    data = self._sh_rows.take(data[..., :level + 1, :], level + 1)
                return _replace(b, data)
            return b

        def add(self, a, b):
            return super().add(a, self._sh_pt(b, a.level))

        def sub(self, a, b):
            return super().sub(a, self._sh_pt(b, a.level))

        def mult(self, a, b):
            return super().mult(a, self._sh_pt(b, a.level))

        # -- Galois: all_gather + local take ------------------------------
        def _auto_ntt(self, x, g: int):
            """σ_g on NTT-domain shards: a permutation of the evaluation
            points."""
            if self._sh_coeff is None:
                return super()._auto_ntt(x, g)
            perm = self._sh_perm.get(g)
            if perm is None:
                mesh, C = self._sh_mesh, self.n // self._sh_mesh.shape[self._sh_coeff]
                d = mesh.index(self._sh_coeff)
                perm = self._sh_perm[g] = torch.from_numpy(
                    ntt_automorphism_perm(self.n, g)[d * C:(d + 1) * C].copy()).to(self.device)
            full = self._sh_mesh.all_gather(x, self._sh_coeff, x.dim() - 1)
            return full.index_select(-1, perm)

        def _auto_coeff(self, x, g: int, q):
            """σ_g on coefficient-domain shards: permutation and sign
            (x^n = -1)."""
            if self._sh_coeff is None:
                return super()._auto_coeff(x, g, q)
            maps = self._sh_maps.get(g)
            if maps is None:
                src, neg = coeff_automorphism_maps(self.n, g)
                maps = self._sh_maps[g] = (torch.from_numpy(src).to(self.device),
                                           torch.from_numpy(neg.astype(bool)).to(self.device))
            mesh = self._sh_mesh
            return galois_body(mesh, x, maps[0], maps[1], q, self._sh_coeff,
                               self.n // mesh.shape[self._sh_coeff])

    for name in _HOST:
        if hasattr(cls, name):
            setattr(Sharded, name, _host_entry(name))
    Sharded.__name__ = 'Sharded' + cls.__name__
    Sharded.__qualname__ = Sharded.__name__
    return Sharded


@functools.lru_cache(maxsize=None)
def _subclass(cls):
    return _make_subclass(cls)


def _replace(carrier, data):
    """A copy of a ciphertext or plaintext carrier holding ``data``."""
    out = copy.copy(carrier)
    out.data = data
    return out


def make_sharded_engine(engine, mesh, rows=None, coeff: str | None = 'coeff', mixin=None):
    """The view of ``engine`` on this rank's shards over ``mesh``: its
    coefficients over the ``coeff`` axis (None: whole polynomials), its limbs
    laid out by ``rows`` (``AllRows`` by default; key switches split their
    digits over the mesh's ``limb`` axis either way). ``mixin`` is a class
    whose methods override the view's (``parallel/limb_engine.py``)."""
    if getattr(engine, '_sh_base', None) is not None:
        raise ValueError('the engine is a sharded view already')
    if coeff is not None:
        D = mesh.shape[coeff]
        if D < 2:
            coeff = None
        elif engine.n % (D * D):
            raise ValueError(f'n={engine.n} not divisible by D^2={D * D}')
    cls = _subclass(type(engine))
    if mixin is not None:
        cls = _mixed(mixin, cls)
    obj = object.__new__(cls)
    obj.__dict__.update(engine.__dict__)
    obj._sh_base = engine
    obj._sh_mesh = mesh
    obj._sh_coeff = coeff
    obj._sh_rows = rows or AllRows()
    obj._sh_rings = {}
    obj._sh_behz = {}
    obj._sh_perm = {}
    obj._sh_maps = {}
    obj.bootstrapper = None
    obj.switcher = _SwitcherView(obj)
    return obj


@functools.lru_cache(maxsize=None)
def _mixed(mixin, cls):
    return type(mixin.__name__ + cls.__name__, (mixin, cls), {})


def make_coeff_sharded_engine(engine, mesh, axis: str = 'coeff'):
    """The view of ``engine`` (``BfvEngine`` or ``CkksEngine``, either word)
    whose ops take and return this rank's coefficient shards (..., L, n/D)
    over ``mesh``'s ``axis``; every limb on every rank, key switches with
    their digits split over the mesh's ``limb`` axis when it has one."""
    if mesh.shape[axis] < 2:
        raise ValueError(f'the {axis} axis has one rank')
    return make_sharded_engine(engine, mesh, AllRows(), axis)


def _swap_engine(obj, eng):
    """A shallow copy of a precompute holder (``EncodedLinearTransform``,
    ``ChebyshevEvaluator``, ``CkksBootstrapper``) on the view; its encoded
    plaintexts stay shared with the original (whole, cut at op entry)."""
    o2 = copy.copy(obj)
    o2.engine = eng
    return o2


def make_sharded_bootstrapper(btp, eng):
    """A ``CkksBootstrapper`` whose segments run on the view ``eng``."""
    b2 = _swap_engine(btp, eng)
    b2.cts = [_swap_engine(lt, eng) for lt in btp.cts]
    b2.cts_last_re = _swap_engine(btp.cts_last_re, eng)
    b2.cts_last_im = _swap_engine(btp.cts_last_im, eng)
    b2.stc = [_swap_engine(lt, eng) for lt in btp.stc]
    b2.evalmod = _swap_engine(btp.evalmod, eng)
    b2._scale_up = {}              # columns of the view's limbs
    eng.bootstrapper = b2
    return b2


def make_coeff_sharded_bootstrapper(btp, mesh, axis: str = 'coeff'):
    """A ``CkksBootstrapper`` whose segments run on the coefficient view of
    its engine over ``mesh``'s ``axis``."""
    return make_sharded_bootstrapper(btp, make_coeff_sharded_engine(btp.engine, mesh, axis))


class ShardedBootstrap:
    """A whole CKKS bootstrap on a sharded view: one ciphertext refreshed
    across the ranks, its data and its keys sharded.

    ``segments`` are ``CkksBootstrapper.segments`` on the view (a task's
    partitioned run captures each as its own graphs, cut at the
    collectives); ``__call__(ct)`` takes this rank's shard of a level-(step−1)
    ciphertext (``shard``) and returns this rank's shard of the refreshed
    one (``gather`` puts it together), bit for bit the single-device walk.
    The keys are the context's, whole: the view's switcher cuts each to this
    rank's digits and coefficients once (``_SwitcherView.keys``)."""

    def __init__(self, ctx, btp):
        """``btp``: the context's bootstrapper on a sharded view
        (``make_sharded_bootstrapper``)."""
        self.ctx = ctx
        self.btp = btp
        self.engine = btp.engine
        self.rlk = ctx.rlk
        self.glk = ctx.glk.keys
        self.swk = getattr(ctx, 'swk', None) or {}

    def shard(self, ct):
        """A whole ciphertext → this rank's shard at the base level."""
        return self.engine.shard_ct(self.ctx.engine.bootstrapper.prepare(ct))

    def gather(self, ct):
        return self.engine.gather_ct(ct)

    def segments(self, caller_scale: float):
        return self.btp.segments(caller_scale, self.swk.get('swk_dts'),
                                 self.swk.get('swk_std'))

    def __call__(self, ct):
        return self.btp(ct, self.rlk, self.glk, self.swk.get('swk_dts'),
                        self.swk.get('swk_std'))


class CoeffShardedBootstrap(ShardedBootstrap):
    """``ShardedBootstrap`` on the coefficient view over ``mesh``'s ``axis``
    (the counterpart of the JAX package's ``CoeffShardedBootstrap``): the
    ciphertext, the keys and every intermediate hold n/D coefficients a
    rank."""

    def __init__(self, ctx, mesh, axis: str = 'coeff'):
        super().__init__(ctx, make_coeff_sharded_bootstrapper(ctx.engine.bootstrapper, mesh,
                                                              axis))
