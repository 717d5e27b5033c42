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


def _ct(data, level, scale=None, is_ntt=None):
    ntt = scale is not None if is_ntt is None else is_ntt
    return Ciphertext(data=T(data), level=level, is_ntt=ntt,
                      scale=1.0 if scale is None else scale)


def engine_view(spec, shape, kind, level, datas, elt=None, scale=None):
    """One op of the coefficient-sharded engine view (``make_coeff_sharded_
    engine``) on this rank's shards of ``datas``; → the whole output.
    CKKS kinds: 'mult_relin_rescale', 'rotate', 'hoisted'; BFV kinds:
    'mult' (ct × ct → ct3), 'relin' (of a ct3), 'rotate' (rotate_cols by
    ``elt``'s step), 'mult_relin_rotate'."""
    from lattisense_torch.parallel.sharded_engine import make_coeff_sharded_engine
    mesh = _mesh(shape)
    ctx = context(spec)
    eng = make_coeff_sharded_engine(ctx.engine, mesh)
    cts = [eng.shard_ct(_ct(d, level, scale)) for d in datas]
    glk = ctx.glk.keys.get(elt) if elt is not None else None
    if kind == 'mult_relin_rescale':
        out = eng.rescale(eng.relinearize(eng.mult(cts[0], cts[1]), ctx.rlk))
    elif kind == 'rotate':
        out = eng.apply_galois(cts[0], elt, glk)
    elif kind == 'hoisted':
        out = eng.apply_galois_decomposed(eng.rns_sp_decomp(cts[0]), elt, glk)
    elif kind == 'mult':
        out = eng.mult(cts[0], cts[1])
    elif kind == 'relin':
        out = eng.relinearize(cts[0], ctx.rlk)
    else:
        out = eng.apply_galois(eng.relinearize(eng.mult(cts[0], cts[1]), ctx.rlk), elt, glk)
    return A(eng.gather_ct(out).data)


_btp_contexts: dict = {}


def btp_context(args):
    """The port's bootstrapping context of a JAX test's fixture:
    ``args`` = (n, q, p, scale, word, seed, h, cfg), keys from the seed; made
    once a process (the cases of one fixture share it)."""
    from lattisense_torch.runtime import CkksBtpContext
    from lattisense_torch.schemes.bootstrap import BootstrapConfig
    key = repr(args)
    ctx = _btp_contexts.get(key)
    if ctx is None:
        n, q, p, scale, word, seed, h, cfg = args
        params = CkksParams.create_custom(n, q, p, scale=scale, word_bits=word)
        ctx = _btp_contexts[key] = CkksBtpContext.create_random_context(
            params, seed=seed, h=h, btp_config=BootstrapConfig(**cfg), device='cpu')
    return ctx


def btp_walk(args, shape, kind, data, level, scale, call=False):
    """The bootstrap of one base-level ciphertext on the sharded view ('coeff':
    ``CoeffShardedBootstrap``, 'limb': ``LimbShardedBootstrap``), segment by
    segment; → [(name, [(whole data, level, scale), ...])] at every
    boundary, and the bootstrap's output through ``__call__``."""
    from lattisense_torch.parallel.limb_engine import LimbShardedBootstrap
    from lattisense_torch.parallel.sharded_engine import CoeffShardedBootstrap
    mesh = _mesh(shape)
    ctx = btp_context(args)
    bs = (CoeffShardedBootstrap(ctx, mesh) if kind == 'coeff'
          else LimbShardedBootstrap(ctx, mesh))
    ct = bs.shard(_ct(data, level, scale))
    cts, out = (ct,), []
    for name, fn in bs.segments(ct.scale):
        cts = fn(cts, bs.rlk, bs.glk)
        out.append((name, [(A(bs.gather(c).data), c.level, c.scale) for c in cts]))
    if not call:
        return out, None
    whole = bs.gather(bs(ct))
    return out, (A(whole.data), whole.level, whole.scale)


def engine_view_refusal(spec, shape):
    """The error a ``PlaintextRingt`` operand raises on the view."""
    from lattisense_torch.parallel.sharded_engine import make_coeff_sharded_engine
    ctx = context(spec)
    eng = make_coeff_sharded_engine(ctx.engine, _mesh(shape))
    ct = eng.shard_ct(ctx.encrypt(ctx.encode(np.arange(spec['n']) % 7, 1)))
    try:
        eng.add(ct, eng.encode_ringt(np.arange(spec['n']) % 7))
    except NotImplementedError as e:
        return str(e)
    return 'accepted'


def btp_task_run(word, shape, modes, data, scale):
    """The committed n = 256 one-bootstrap task (``tasks.BOOTSTRAP_N256``)
    with ``mesh=shape`` in each of ``modes`` on the port's context of
    ``tasks.bootstrap_n256(word)``; → {mode: (whole output, level, scale)}."""
    from lattisense_torch.runtime import tasks
    b = tasks.bootstrap_n256(word)
    ctx = btp_context((b['n'], b['q'], b['p'], b['scale'], word, b['seed'], b['h'], b['cfg']))
    mesh = _mesh(shape)
    out = {}
    for mode in modes:
        task = FheTask(tasks.task_dir(tasks.BOOTSTRAP_N256[word]), mode=mode, device='cpu',
                       mesh=mesh)
        z = task.run(ctx, {'x': _ct(data, b['level'], scale)})[0]['z']
        out[mode] = (A(z.data), z.level, z.scale)
    return out
