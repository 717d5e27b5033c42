"""Rank-side code of the port's mesh tests (``tests/test_torch_mesh.py``,
``test_torch_keyswitch_sharded.py``, ``test_torch_coeff_sharded.py``).

Each function runs on every rank of a gloo world on the CPU
(``lattisense_torch.parallel.launch.World``), builds the port's objects from
NumPy arrays the test made with the JAX package, runs one sharded function of
the port and returns its whole result as NumPy. This module imports neither
JAX nor ``lattisense_tpu``: the ranks load only the port.
"""

import numpy as np
import torch
import torch.distributed as dist

from lattisense_torch.parallel import batch as pb
from lattisense_torch.parallel import coeff_sharded as cs
from lattisense_torch.parallel.keyswitch_sharded import ShardedKeySwitcher
from lattisense_torch.parallel.mesh import ct_batch_spec, make_mesh, shard, unshard
from lattisense_torch.params import BfvParams, CkksParams
from lattisense_torch.runtime import BfvContext, CkksContext, FheTask
from lattisense_torch.schemes.types import Ciphertext


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def A(t):
    return t.cpu().numpy()


def context(spec: dict):
    """A CPU context of the port holding the keys in ``spec`` (arrays of the
    JAX context): 'algo', 'n', 'q', 'p', 'wb', 't' or 'scale', 'sk', 'pk',
    'rlk', and 'glk' {elt: (key_q, key_p)}."""
    if spec['algo'] == 'BFV':
        params = BfvParams.create_custom(spec['n'], spec['t'], spec['q'], spec['p'],
                                         word_bits=spec['wb'])
        cls = BfvContext
    else:
        params = CkksParams.create_custom(spec['n'], spec['q'], spec['p'], scale=spec['scale'],
                                          word_bits=spec['wb'])
        cls = CkksContext
    ctx = cls.from_arrays(params, spec['sk'], spec['pk'], *spec['rlk'], device='cpu')
    for e, (kq, kp) in spec.get('glk', {}).items():
        ctx.add_galois_key_arrays(e, kq, kp)
    return ctx


def _mesh(shape):
    return make_mesh(*shape, device='cpu')


def batched_step(spec, level, shape, limb_sharded, a, b):
    """``make_batched_step(bfv_mult_relin, mesh=...)`` on this rank's pieces
    of the batch; → the whole output."""
    mesh = _mesh(shape)
    ctx = context(spec)
    spec_ct = ct_batch_spec(limb_sharded)
    step = pb.make_batched_step(ctx.engine, pb.bfv_mult_relin, level, mesh=mesh,
                                limb_sharded=limb_sharded)
    out = step(shard(mesh, T(a), spec_ct), shard(mesh, T(b), spec_ct), pb.key_tree(ctx))
    return A(unshard(mesh, out, spec_ct))


def limb_tp(spec, level, shape, kind, a, b=None, elts=()):
    """One of the four ``make_limb_tp_*`` pipelines; → whole outputs."""
    mesh = _mesh(shape)
    ctx = context(spec)
    eng = ctx.engine
    spec_ct = ct_batch_spec(False)
    if kind == 'mult_relin':
        f, prep = pb.make_limb_tp_mult_relin(eng, level, mesh)
        out = f(shard(mesh, T(a), spec_ct), shard(mesh, T(b), spec_ct),
                prep(ctx.rlk.key_q, ctx.rlk.key_p))
    elif kind == 'mult_relin_rescale':
        f, prep = pb.make_limb_tp_mult_relin_rescale(eng, level, mesh)
        out = f(shard(mesh, T(a), spec_ct), shard(mesh, T(b), spec_ct),
                prep(ctx.rlk.key_q, ctx.rlk.key_p))
    elif kind == 'rotate':
        f, prep = pb.make_limb_tp_rotate(eng, elts[0], level, mesh)
        k = ctx.glk.keys[elts[0]]
        out = f(shard(mesh, T(a), spec_ct), prep(k.key_q, k.key_p))
    else:
        f, prep = pb.make_limb_tp_hoisted_rotations(eng, elts, level, mesh)
        got = f(T(a), prep(ctx.glk.keys))
        return {e: A(v) for e, v in got.items()}
    return A(unshard(mesh, out, spec_ct))


def sharded_switch(spec, level, shape, x, from_digits):
    """``ShardedKeySwitcher`` over the limb axis, directly or from the
    digits of ``KeySwitcher.decompose_modup_ntt``; → (e0, e1)."""
    mesh = _mesh(shape)
    ctx = context(spec)
    sw = ctx.engine.switcher
    sks = ShardedKeySwitcher(sw, level, mesh)
    if from_digits:
        e = sks.switch_from_digits(sw.decompose_modup_ntt(T(x), level), ctx.rlk.key_q,
                                   ctx.rlk.key_p)
    else:
        e = sks(T(x), ctx.rlk.key_q, ctx.rlk.key_p)
    return A(e[0]), A(e[1])


def dist_ntt(moduli, n, wb, shape, x):
    """``DistNtt`` forward of x, inverse of that, and inverse of x."""
    mesh = _mesh(shape)
    dn = cs.DistNtt(moduli, n, mesh, word_bits=wb)
    y = dn.ntt(T(x))
    return A(y), A(dn.intt(y)), A(dn.intt(T(x)))


def coeff_switch(spec, level, shape, kind, data, elt=None):
    """The coefficient-sharded switchers: 'coeff' (CoeffShardedKeySwitcher),
    'limb_coeff' (LimbCoeffKeySwitcher) on x; 'relin' on ct3, 'rotate' on
    ct; → whole outputs."""
    mesh = _mesh(shape)
    ctx = context(spec)
    sw = ctx.engine.switcher
    kq, kp = ctx.rlk.key_q, ctx.rlk.key_p
    if kind == 'coeff':
        e = cs.CoeffShardedKeySwitcher(sw, level, mesh)(T(data), kq, kp)
    elif kind == 'limb_coeff':
        e = cs.LimbCoeffKeySwitcher(sw, level, mesh)(T(data), kq, kp)
    elif kind == 'relin':
        return A(cs.CoeffShardedRelin(sw, level, mesh)(T(data), ctx.rlk))
    else:
        return A(cs.CoeffShardedRotator(sw, level, mesh, elt)(T(data), ctx.glk.keys[elt]))
    return A(e[0]), A(e[1])


def task_run(spec, task_dir, shape, mode, inputs, level):
    """``FheTask(task_dir, mode, mesh=...)`` on ciphertexts {name: data} at
    ``level``; → {output: data} and the mesh's collective counters."""
    mesh = _mesh(shape)
    ctx = context(spec)
    task = FheTask(task_dir, mode=mode, device='cpu', mesh=mesh)
    vals = {k: Ciphertext(data=T(v), level=level) for k, v in inputs.items()}
    out, _ = task.run(ctx, vals)
    return {k: A(v.data) for k, v in out.items()}, mesh.stats


def rank_or_raise(bad: int):
    """This rank's number, or a ValueError on rank ``bad``."""
    if dist.get_rank() == bad:
        raise ValueError(f'rank {bad} refuses')
    return dist.get_rank()
