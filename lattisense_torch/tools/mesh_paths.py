"""The mesh paths on the card: rank-side code that ``chip_smoke.py`` (and the
card tests) run in a world of ranks (``parallel/launch.py``).

The parent saves what a path needs with ``save`` into a directory: a
context's parameters and keys (``save_context``) and the path's input and
expected output tensors. Each rank loads them onto its card (once per world:
``_loaded`` keeps them for the world's later calls) and rebuilds the context
with ``from_arrays``, which costs a load where keygen of the same seed would
cost seconds of host sampling. ``rank_path`` then runs one path:

- ``mesh_op``: ``make_batched_step(bfv_mult_relin, mesh=...)`` on the rank's
  op shard of the batch;
- ``limb_tp`` / ``limb_tp_rotate``: ``make_limb_tp_mult_relin`` /
  ``make_limb_tp_rotate`` on the rank's op shard;
- ``coeff_ksw``: ``CoeffShardedRelin`` on the rank's coefficient shard of the
  product ``mult(a, b)`` (computed once, outside the timing);
- ``task_eager`` / ``task_jit``: ``FheTask(task, mode, mesh=...)``;
- ``coeff_engine``: the coefficient-sharded engine view
  (``parallel/sharded_engine.py``) on the rank's coefficient shard of the
  batch: BFV mult + relinearize, or (a CKKS context) mult + relinearize +
  rescale;
- ``coeff_btp`` / ``limb_btp``: ``CoeffShardedBootstrap`` /
  ``LimbShardedBootstrap`` (``parallel/limb_engine.py``) of one ciphertext
  on the toy bootstrap profile (or the n = 256 chain), whose context each
  rank makes from its seed (``btp:toy``, ``btp:n256``);
- ``btp_task``: the committed toy bootstrap task with ``mesh=...``,
  partitioned.

Each runs one warm-up step, then times ``iters`` steps with CUDA events
between barriers, the first of them the counted step, whose whole output
it compares bit for bit with the expected tensor. It returns whether the output was equal, its ms a
step, the launches of every kernel in the counted step, the collectives'
calls and bytes in that step and the bytes staged through the host, and the
backend; and the launches of the warm-up, which for a captured task
(``task_jit``, ``btp_task``) are those of its capture, since a replay
launches nothing through a wrapper.
"""

import json
import os
import time

import torch

from ..ops import (bconv_cuda, behz_cuda, ksw64_cuda, ksw_cuda, ntt64_cuda, ntt_cuda,
                   ntt_mxu, tensor_cuda)
from ..parallel import batch as pb
from ..parallel.coeff_sharded import CoeffShardedRelin
from ..parallel.limb_engine import LimbShardedBootstrap
from ..parallel.mesh import ct_batch_spec, make_mesh, shard, unshard
from ..parallel.sharded_engine import CoeffShardedBootstrap, make_coeff_sharded_engine
from ..params import CkksParams
from ..runtime import BfvContext, CkksBtpContext, CkksContext, FheTask, tasks
from ..schemes.bootstrap import BootstrapConfig
from ..schemes.types import Ciphertext
from .profile_step import bootstrap_context

COUNTS = (ntt_cuda.launches, behz_cuda.launches, ksw_cuda.launches, ntt64_cuda.launches,
          bconv_cuda.launches, ksw64_cuda.launches, ntt_mxu.launches, tensor_cuda.launches)

_loaded: dict = {}


def save_context(ctx, galois_elts=()) -> dict:
    """A context's parameters and keys as CPU tensors (``torch.save``-able)."""
    return {'params': ctx.params, 'ckks': isinstance(ctx, CkksContext), 'sk': torch.as_tensor(ctx.sk.coeffs).cpu(),
            'pk': ctx.pk.data.cpu(), 'rlk': (ctx.rlk.key_q.cpu(), ctx.rlk.key_p.cpu()),
            'glk': {e: (ctx.glk.keys[e].key_q.cpu(), ctx.glk.keys[e].key_p.cpu())
                    for e in galois_elts}}


def save(directory: str, name: str, obj):
    torch.save(obj, os.path.join(directory, f'{name}.pt'))


def load(directory: str, name: str, device):
    key = (directory, name, str(device))
    if key not in _loaded and name.startswith('btp:'):
        # a bootstrapping context from its seed ('btp:toy', the toy profile;
        # 'btp:n256', the JAX tests' n = 256 u64 chain), with the Galois
        # keys its committed task's signature lists
        if name == 'btp:n256':
            b = tasks.bootstrap_n256(64)
            ctx = CkksBtpContext.create_random_context(
                CkksParams.create_custom(b['n'], b['q'], b['p'], scale=b['scale']),
                seed=b['seed'], h=b['h'], btp_config=BootstrapConfig(**b['cfg']), device=device)
            task = tasks.BOOTSTRAP_N256[64]
        else:
            ctx = bootstrap_context(name[4:], device)[0]
            task = tasks.CKKS_BOOTSTRAP_TOY
        with open(os.path.join(tasks.task_dir(task), 'task_signature.json')) as f:
            ctx.gen_galois_keys_for_elements([int(e) for e in json.load(f)['key']['glk']])
        _loaded[key] = ctx
    if key not in _loaded:
        obj = torch.load(os.path.join(directory, f'{name}.pt'), weights_only=False)
        if isinstance(obj, dict) and 'params' in obj:
            cls = CkksContext if obj.get('ckks') else BfvContext
            ctx = cls.from_arrays(obj['params'], obj['sk'], obj['pk'], *obj['rlk'],
                                  device=device)
            for e, (kq, kp) in obj['glk'].items():
                ctx.add_galois_key_arrays(e, kq, kp)
            obj = ctx
        elif isinstance(obj, dict):
            obj = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in obj.items()}
        _loaded[key] = obj
    return _loaded[key]


def _reset():
    for c in COUNTS:
        for k in c:
            c[k] = 0


def _read():
    return {k: v for c in COUNTS for k, v in c.items() if v}


def rank_path(directory: str, path: str, ctx_name: str, data_name: str, shape, level: int,
              iters: int, elt: int | None = None, device=None, task_dir: str | None = None
              ) -> dict:
    """Run ``path`` on this rank over a mesh of ``shape`` (op, limb, coeff)
    with the context ``ctx_name`` and the data ``data_name`` ({'a', 'b',
    'out'}) saved in ``directory``; the task paths run ``task_dir`` (by
    default the committed 32-``mult_relin`` task). Steps are timed with CUDA
    events on the card, with the host clock on the CPU."""
    mesh = make_mesh(*shape, device=device)
    dev = mesh.device
    ctx = load(directory, ctx_name, dev)
    data = load(directory, data_name, dev)
    eng = ctx.engine
    spec = ct_batch_spec()
    a, b, want = data['a'], data.get('b'), data['out']
    if path == 'mesh_op':
        step = pb.make_batched_step(eng, pb.bfv_mult_relin, level, mesh=mesh)
        keys = pb.key_tree(ctx)
        a_loc, b_loc = shard(mesh, a, spec), shard(mesh, b, spec)

        def fn():
            return unshard(mesh, step(a_loc, b_loc, keys), spec)
    elif path == 'limb_tp':
        f, prep = pb.make_limb_tp_mult_relin(eng, level, mesh)
        kd = prep(ctx.rlk.key_q, ctx.rlk.key_p)
        a_loc, b_loc = shard(mesh, a, spec), shard(mesh, b, spec)

        def fn():
            return unshard(mesh, f(a_loc, b_loc, kd), spec)
    elif path == 'limb_tp_rotate':
        f, prep = pb.make_limb_tp_rotate(eng, elt, level, mesh)
        glk = ctx.glk.keys[elt]
        kd = prep(glk.key_q, glk.key_p)
        a_loc = shard(mesh, a, spec)

        def fn():
            return unshard(mesh, f(a_loc, kd), spec)
    elif path == 'coeff_ksw':
        relin = CoeffShardedRelin(eng.switcher, level, mesh)
        ct3 = eng.mult(Ciphertext(data=a, level=level), Ciphertext(data=b, level=level)).data
        c3 = relin.ks.local(ct3).contiguous()
        del ct3
        kd = relin.ks.prep_keys(ctx.rlk)

        def fn():
            return mesh.all_gather(relin.body(c3, kd), 'coeff', -1)
    elif path == 'coeff_engine':
        view = make_coeff_sharded_engine(eng, mesh)
        ckks = data.get('scale') is not None
        ca, cb = (view.shard_ct(Ciphertext(data=x, level=level, is_ntt=ckks,
                                           scale=data.get('scale') or 1.0)) for x in (a, b))

        def fn():
            out = view.relinearize(view.mult(ca, cb), ctx.rlk)
            return view.gather_ct(view.rescale(out) if ckks else out).data
    elif path in ('coeff_btp', 'limb_btp'):
        bs = (CoeffShardedBootstrap if path == 'coeff_btp' else LimbShardedBootstrap)(ctx, mesh)
        x = bs.shard(Ciphertext(data=a, level=data['level'], is_ntt=True, scale=data['scale']))

        def fn():
            return bs.gather(bs(x)).data
    elif path == 'btp_task':
        task = FheTask(task_dir or tasks.task_dir(tasks.CKKS_BOOTSTRAP_TOY), mode='partitioned',
                       mesh=mesh)
        x = Ciphertext(data=a, level=data['level'], is_ntt=True, scale=data['scale'])

        def fn():
            return task.run(ctx, {'x': x})[0]['z'].data
    elif path in ('task_eager', 'task_jit'):
        task = FheTask(task_dir or tasks.task_dir(tasks.MULT_RELIN), mode=path[5:], mesh=mesh)
        online = tasks.mult_relin_arguments(
            [Ciphertext(data=a[k], level=level) for k in range(a.shape[0])],
            [Ciphertext(data=b[k], level=level) for k in range(b.shape[0])])

        def fn():
            out, _ = task.run(ctx, online)
            return torch.stack([out[f'z{k}'].data for k in range(a.shape[0])])
    else:
        raise ValueError(f'unknown mesh path {path!r}')
    cuda = dev.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
    _reset()
    fn()                                          # warm-up: tables, caches, graphs
    sync()
    warmup = _read()
    mesh.barrier()
    _reset()
    mesh.reset_stats()
    if cuda:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = fn()                                    # the counted step, the first timed one
    launches = _read()
    stats = {k: dict(v) if isinstance(v, dict) else v for k, v in mesh.stats.items()}
    for _ in range(iters - 1):
        fn()
    if cuda:
        stop.record()
    sync()
    ms = start.elapsed_time(stop) / iters if cuda else (time.perf_counter() - t0) * 1e3 / iters
    equal = bool(torch.equal(out, want))
    del out
    mesh.barrier()
    graphs = None
    if path in ('task_jit', 'btp_task'):
        graphs = sum(g.graphs for g in task._graphs.values())
    return {'equal': equal, 'ms_per_step': ms,
            'launches': launches, 'warmup_launches': warmup, 'collectives': stats,
            'backend': mesh.backend,
            'mesh': dict(mesh.shape), 'graphs': graphs}
