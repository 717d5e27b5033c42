"""Batched FHE pipelines, on one device or over a mesh.

Port of ``lattisense_tpu/parallel/batch.py``: the reference vmaps a
single-ciphertext step and jits it; here the batch dimension is written out
— every engine op takes (B, ..., L, n) data — and PyTorch runs the step
eagerly.

Over a mesh (``parallel/mesh.py``) the port is SPMD: a step takes this
rank's pieces of the batch and returns its piece of the output.

- ``make_batched_step(..., mesh=...)``: on the ``op`` axis each rank runs
  its B/op members. ``limb_sharded`` fixes the layout of the inputs and
  outputs (``ct_batch_spec(True)``: each rank holds L/limb limbs of its
  members). The JAX package leaves the partitioning inside the step to
  GSPMD; here a member's limbs are all-gathered over the limb ranks, the
  member is computed once on each of them, and each keeps its own rows.
- ``make_limb_tp_*``: the explicit tensor parallelism over ``limb``. The
  product or automorphism runs on the rank's op shard through the engine
  (its kernels: B2/B4 at 32 bits, B5 and B6 at 64), the key switch through
  ``ShardedKeySwitcher`` (digits split over ``limb``, one psum_scatter).
  Inputs and outputs are the op shard, replicated over ``limb``.
"""

import torch

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..params import CkksParams
from ..schemes.galois import apply_automorphism_coeff, apply_automorphism_ntt
from ..schemes.types import Ciphertext, KeySwitchKey
from ..utils.observability import span
from .keyswitch_sharded import ShardedKeySwitcher


def make_batched_step(engine, step_fn, level: int, n_inputs: int = 2, is_ntt: bool = False,
                      *, mesh=None, limb_sharded: bool = False):
    """``step_fn(engine, *cts, keys) -> ct`` as a callable over raw tensors:
    f(a_data[B,2,L,n], ..., keys) -> out_data[B,...] with ``n_inputs``
    ciphertext arguments before the keys. The inputs are wrapped at
    ``level`` in the domain ``is_ntt`` (CKKS: True) and at the parameter
    set's scale (BFV carries 1.0).

    With ``mesh`` the tensors are this rank's pieces under
    ``ct_batch_spec(limb_sharded)`` and so is the output; the keys are
    whole. Each call is the root span ``step`` of the program's tracer,
    carrying B (this rank's batch) and the level."""
    scale = getattr(engine.params, 'scale', 1.0)
    if mesh is None and limb_sharded:
        raise ValueError('limb_sharded needs a mesh')

    def batched(*args):
        if len(args) != n_inputs + 1:
            raise TypeError(f'expected {n_inputs} ciphertext tensors and the keys, '
                            f'got {len(args)} arguments')
        with span('step') as sp:
            if sp:
                sp.attrs.update(B=len(args[0]), level=level)
            datas = list(args[:n_inputs])
            if limb_sharded:
                datas = [mesh.all_gather(a, 'limb', 2) for a in datas]
            cts = [Ciphertext(data=a, level=level, is_ntt=is_ntt, scale=scale) for a in datas]
            out = step_fn(engine, *cts, args[n_inputs]).data
            if limb_sharded:
                D = mesh.shape['limb']
                if out.shape[2] % D:
                    raise ValueError(f'{out.shape[2]} output limbs do not split over {D} ranks')
                k = out.shape[2] // D
                out = out.narrow(2, mesh.index('limb') * k, k).contiguous()
            return out

    return batched


def make_limb_tp_mult_relin(engine, level: int, mesh):
    """BFV mult + relinearize over (op × limb): the BEHZ product on this
    rank's op shard, the relinearization through the limb-sharded key
    switch. → (f, prep_keys): f(a[B/op,2,L,n], b, kd) → (B/op, 2, L, n),
    bit for bit the single-device step; ``prep_keys(key_q, key_p)`` gives
    this rank's digit group of the key."""
    sharded = ShardedKeySwitcher(engine.switcher, level, mesh)
    ring = engine.ring(level)

    def f(a, b, kd):
        d3 = engine.mult(Ciphertext(data=a, level=level), Ciphertext(data=b, level=level)).data
        e0, e1 = sharded.traced(d3[:, 2], kd)
        return torch.stack([_u.addmod(d3[:, 0], e0, ring.q), _u.addmod(d3[:, 1], e1, ring.q)],
                           dim=1)

    return f, sharded.pad_keys


def make_limb_tp_mult_relin_rescale(engine, level: int, mesh):
    """The CKKS twin: NTT-domain tensor product on the op shard, the
    relinearization's switch limb-sharded, the rescale on the rank; bit for
    bit ``rescale(relinearize(mult(a, b)))``, output at ``level - 1``."""
    sharded = ShardedKeySwitcher(engine.switcher, level, mesh)
    ring, ring2 = engine.ring(level), engine.ring(level - 1)
    rescaler = engine.rescaler(level)
    scale = engine.params.scale

    def f(a, b, kd):
        d3 = engine.mult(Ciphertext(data=a, level=level, is_ntt=True, scale=scale),
                         Ciphertext(data=b, level=level, is_ntt=True, scale=scale)).data
        c2 = ntt_mod.intt(d3[:, 2].contiguous(), ring)
        e0, e1 = sharded.traced(c2, kd)
        c0 = _u.addmod(d3[:, 0], ntt_mod.ntt(e0, ring), ring.q)
        c1 = _u.addmod(d3[:, 1], ntt_mod.ntt(e1, ring), ring.q)
        coeff = ntt_mod.intt(torch.stack([c0, c1], dim=1), ring)
        return ntt_mod.ntt(rescaler(coeff), ring2)

    return f, sharded.pad_keys


def make_limb_tp_rotate(engine, galois_elt: int, level: int, mesh):
    """BFV rotate (σ_g on coefficient-domain input, local on every rank) with
    the key switch of σ_g(c1) limb-sharded; bit for bit ``apply_galois``.
    → (f, prep_keys): f(a[B/op,2,L,n], kd)."""
    sharded = ShardedKeySwitcher(engine.switcher, level, mesh)
    ring = engine.ring(level)

    def f(a, kd):
        c0 = apply_automorphism_coeff(a[:, 0], ring.q, engine.n, galois_elt)
        c1 = apply_automorphism_coeff(a[:, 1], ring.q, engine.n, galois_elt)
        e0, e1 = sharded.traced(c1, kd)
        return torch.stack([_u.addmod(c0, e0, ring.q), e1], dim=1)

    return f, sharded.pad_keys


def make_limb_tp_hoisted_rotations(engine, galois_elts, level: int, mesh):
    """A hoisted bundle of rotations of one ciphertext: one digit
    decomposition, then per element a digit permutation and the
    limb-sharded switch from digits. → (f, prep): f(ct[2,L,n], kds) →
    {elt: (2, L, n)} (coefficient domain for BFV, NTT domain for CKKS);
    ``prep(glk_keys)`` gives each element's digit group of its key."""
    sharded = ShardedKeySwitcher(engine.switcher, level, mesh)
    ring = engine.ring(level)
    elts = tuple(galois_elts)
    ntt_dom = engine.params.algo == 'CKKS'

    def prep(glk_keys):
        return {e: sharded.pad_keys(glk_keys[e].key_q, glk_keys[e].key_p) for e in elts}

    def f(data, kds):
        c1 = ntt_mod.intt(data[1].contiguous(), ring) if ntt_dom else data[1]
        digits = sharded.pad_digits(engine.switcher.decompose_modup_ntt(c1, level))
        out = {}
        for e in elts:
            if ntt_dom:
                c0r = apply_automorphism_ntt(data[0], engine.n, e)
            else:
                c0r = apply_automorphism_coeff(data[0], ring.q, engine.n, e)
            e0, e1 = sharded.traced_from_digits(apply_automorphism_ntt(digits, engine.n, e),
                                                kds[e])
            if ntt_dom:
                e0, e1 = ntt_mod.ntt(e0, ring), ntt_mod.ntt(e1, ring)
            out[e] = torch.stack([_u.addmod(c0r, e0, ring.q), e1])
        return out

    return f, prep


def bfv_mult_relin(engine, a, b, keys):
    """BFV mult + relinearize (the reference's benchmark_cpu.cpp:27-51 op)."""
    return engine.relinearize(engine.mult(a, b), keys['rlk'])


def ckks_mult_relin_rescale(engine, a, b, keys):
    """CKKS mult + relinearize + rescale (benchmark_cpu.cpp:53-78)."""
    return engine.rescale(engine.relinearize(engine.mult(a, b), keys['rlk']))


def ckks_mult_relin_rescale2(engine, a, b, keys):
    """CKKS mult + relinearize + two rescales: one multiplicative level on a
    composite chain of 31-bit primes (two primes a level, scale about
    2^60), the 32-bit word's counterpart of the u64 measurement."""
    return engine.rescale(ckks_mult_relin_rescale(engine, a, b, keys))


def ckks_composite_params(n: int = 16384) -> CkksParams:
    """The chain ``ckks_mult_relin_rescale2`` runs on: the 31-bit primes of
    ``CkksParams.create_tpu_param(n)`` at scale 2^60 (two primes a level),
    as the JAX package's ``bench.py`` measures it."""
    tpu = CkksParams.create_tpu_param(n)
    return CkksParams.create_custom(n, tpu.q, tpu.p, slots=n // 2, scale=2.0 ** 60,
                                    word_bits=32)


def make_rotate_step(galois_elt: int):
    """A one-input step applying the Galois automorphism ``galois_elt``
    (e.g. ``galois_elt_col(1, n)``: rotate_col by 1) with its key."""
    def rot(engine, a, keys):
        return engine.apply_galois(a, galois_elt, keys['glk'][galois_elt])
    return rot


def key_tree(context, galois_elts=()):
    """Context keys (BFV or CKKS) → the ``keys`` argument of a batched step:
    the relinearization key, and under ``'glk'`` the Galois keys of
    ``galois_elts``."""
    rlk = context.rlk
    tree = {'rlk': KeySwitchKey(key_q=rlk.key_q, key_p=rlk.key_p, level=rlk.level,
                                sp_level=rlk.sp_level)}
    if galois_elts:
        tree['glk'] = {e: context.glk.keys[e] for e in galois_elts}
    return tree
