"""The port's mesh (``parallel/mesh.py``), op axis and limb-TP pipelines
(``parallel/batch.py``) and the task runtime's mesh, on one gloo world of 4
ranks on the CPU, each case bit for bit against the JAX package's sharded
function on the virtual mesh of the same shape (conftest's 8 CPU devices)
on the same inputs and keys. The rank-side code is ``tests/torch_mesh_ranks.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.frontend import custom_task as fct
from lattisense_tpu.parallel import batch as jb
from lattisense_tpu.parallel.mesh import ct_batch_spec, key_spec, make_mesh, shard
from lattisense_tpu.params import BfvParams, CkksParams
from lattisense_tpu.runtime import BfvContext, CkksContext, FheTaskTpu
from lattisense_tpu.schemes.galois import galois_elt_col

from lattisense_torch.parallel.launch import World
from lattisense_torch.runtime import FheTask

from . import torch_mesh_ranks as ranks

N, T_MOD = 64, 65537
WORLD = 4


def spec_of(ctx, algo, wb, t=None, scale=None):
    """The arrays a rank rebuilds the context from."""
    p = ctx.params
    glk = getattr(ctx, 'glk', None)
    return {'algo': algo, 'n': p.n, 'q': [int(v) for v in p.q], 'p': [int(v) for v in p.p],
            'wb': wb, 't': t, 'scale': scale, 'sk': np.asarray(ctx.sk.coeffs),
            'pk': np.asarray(ctx.pk.data),
            'rlk': (np.asarray(ctx.rlk.key_q), np.asarray(ctx.rlk.key_p)),
            'glk': {e: (np.asarray(k.key_q), np.asarray(k.key_p))
                    for e, k in (glk.keys.items() if glk is not None else ())}}


def jmesh(op, limb=1):
    return make_mesh(op=op, limb=limb, devices=jax.devices()[:op * limb])


def same(per_rank, want):
    want = np.asarray(want).astype(np.int64)
    return all(np.array_equal(np.asarray(g), want) for g in per_rank)


@pytest.fixture(scope='module')
def world():
    with World(WORLD, backend='gloo', device='cpu') as w:
        yield w


@pytest.fixture(scope='module')
def u64():
    q = gen_ntt_primes(N, 50, 4)
    p = gen_ntt_primes(N, 51, 2, exclude=tuple(q))
    ctx = BfvContext.create_random_context(BfvParams.create_custom(N, T_MOD, q, p), seed=21)
    ctx.gen_galois_keys_for_elements([galois_elt_col(s, N) for s in (1, 2, 5)])
    return ctx


@pytest.fixture(scope='module')
def w32():
    chain = tuple(gen_ntt_primes(N, 31, 10))
    params = BfvParams.create_custom(N, T_MOD, list(chain[:8]), list(chain[8:]), word_bits=32)
    ctx = BfvContext.create_random_context(params, seed=23)
    ctx.gen_galois_keys_for_elements([galois_elt_col(1, N)])
    return ctx


@pytest.fixture(scope='module')
def ckks():
    q = gen_ntt_primes(N, 45, 5)
    p = gen_ntt_primes(N, 46, 2, exclude=tuple(q))
    ctx = CkksContext.create_random_context(CkksParams.create_custom(N, q, p,
                                                                     scale=float(1 << 40)),
                                            seed=31)
    ctx.gen_galois_keys_for_elements([galois_elt_col(s, N) for s in (1, 3)])
    return ctx


def bfv_pair(ctx, level, batch, seed):
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, T_MOD, (2 * batch, N), dtype=np.uint64)
    cts = [ctx.encrypt(ctx.encode(m, level)) for m in msgs]
    return (np.stack([np.asarray(c.data) for c in cts[:batch]]),
            np.stack([np.asarray(c.data) for c in cts[batch:]]))


@pytest.mark.parametrize('limb', [1, 2])
def test_batched_step_op_axis(world, u64, limb):
    """make_batched_step(mesh=...) over (op=4) and (op=2, limb=2, the limbs
    of inputs and outputs sharded): the gathered output equals the JAX
    package's sharded step."""
    level, op = 3, WORLD // limb
    a, b = bfv_pair(u64, level, 8, 5)
    mesh = jmesh(op, limb)
    fn = jb.make_batched_step(u64.engine, jb.bfv_mult_relin, level, mesh=mesh,
                              limb_sharded=limb > 1, n_inputs=2)
    keys = jax.tree.map(lambda k: jax.device_put(
        k, jax.sharding.NamedSharding(mesh, key_spec(limb > 1))), jb.key_tree(u64))
    want = fn(shard(mesh, a, ct_batch_spec(limb > 1)), shard(mesh, b, ct_batch_spec(limb > 1)),
              keys)
    got = world.run(ranks.batched_step, spec_of(u64, 'BFV', 64, t=T_MOD), level,
                    (op, limb, 1), limb > 1, a, b)
    assert same(got, want)


@pytest.mark.parametrize('word', [64, 32])
def test_limb_tp_mult_relin(world, u64, w32, word):
    """make_limb_tp_mult_relin over (op=2, limb=2) at both words."""
    ctx, level, batch = (u64, 3, 8) if word == 64 else (w32, 7, 4)
    a, b = bfv_pair(ctx, level, batch, 8)
    f, prep = jb.make_limb_tp_mult_relin(ctx.engine, level, jmesh(2, 2))
    want = f(a, b, prep(ctx.rlk.key_q, ctx.rlk.key_p))
    got = world.run(ranks.limb_tp, spec_of(ctx, 'BFV', word, t=T_MOD), level, (2, 2, 1),
                    'mult_relin', a, b)
    assert same(got, want)


def test_limb_tp_mult_relin_rescale(world, ckks):
    """The CKKS pipeline over (op=2, limb=2), output at level - 1."""
    level, batch = ckks.params.max_level, 8
    rng = np.random.default_rng(12)
    vals = rng.uniform(-1, 1, (2 * batch, ckks.params.slots))
    cts = [ckks.encrypt(ckks.encode(v, level)) for v in vals]
    a = np.stack([np.asarray(c.data) for c in cts[:batch]])
    b = np.stack([np.asarray(c.data) for c in cts[batch:]])
    f, prep = jb.make_limb_tp_mult_relin_rescale(ckks.engine, level, jmesh(2, 2))
    want = f(a, b, prep(ckks.rlk.key_q, ckks.rlk.key_p))
    got = world.run(ranks.limb_tp, spec_of(ckks, 'CKKS', 64, scale=ckks.params.scale), level,
                    (2, 2, 1), 'mult_relin_rescale', a, b)
    assert same(got, want)


@pytest.mark.parametrize('word', [64, 32])
def test_limb_tp_rotate(world, u64, w32, word):
    """make_limb_tp_rotate (rotate_col by 1) over (op=2, limb=2)."""
    ctx, level = (u64, 3) if word == 64 else (w32, 7)
    elt = galois_elt_col(1, N)
    a, _ = bfv_pair(ctx, level, 4, 13)
    f, prep = jb.make_limb_tp_rotate(ctx.engine, elt, level, jmesh(2, 2))
    glk = ctx.glk.keys[elt]
    want = f(a, prep(glk.key_q, glk.key_p))
    got = world.run(ranks.limb_tp, spec_of(ctx, 'BFV', word, t=T_MOD), level, (2, 2, 1),
                    'rotate', a, None, (elt,))
    assert same(got, want)


@pytest.mark.parametrize('scheme', ['BFV', 'CKKS'])
def test_limb_tp_hoisted_rotations(world, u64, ckks, scheme):
    """The hoisted bundle: one decomposition, each element's switch from
    digits over (op=2, limb=2)."""
    if scheme == 'BFV':
        ctx, level, steps, spec = u64, 3, (1, 2, 5), spec_of(u64, 'BFV', 64, t=T_MOD)
        data = np.asarray(ctx.encrypt(ctx.encode(
            np.random.default_rng(19).integers(0, T_MOD, N, dtype=np.uint64), level)).data)
    else:
        ctx, level, steps = ckks, ckks.params.max_level, (1, 3)
        spec = spec_of(ckks, 'CKKS', 64, scale=ckks.params.scale)
        data = np.asarray(ctx.encrypt(ctx.encode(
            np.random.default_rng(23).uniform(-1, 1, ctx.params.slots), level)).data)
    elts = [galois_elt_col(s, N) for s in steps]
    f, prep = jb.make_limb_tp_hoisted_rotations(ctx.engine, elts, level, jmesh(2, 2))
    want = f(data, prep(ctx.glk.keys))
    got = world.run(ranks.limb_tp, spec, level, (2, 2, 1), 'hoisted', data, None, tuple(elts))
    for e in elts:
        assert same([g[e] for g in got], want[e])


@pytest.fixture(scope='module')
def mult_relin_task(u64, tmp_path_factory):
    """Eight parallel mult_relins at level 3, compiled by the JAX frontend."""
    d = tmp_path_factory.mktemp('mesh_task')
    params = u64.params
    fct.set_fhe_param(fct.BfvParam.create_custom_param(n=N, q=list(params.q), p=list(params.p),
                                                       t=T_MOD))
    ins, outs = [], []
    for k in range(8):
        x, y = fct.BfvCiphertextNode(f'x{k}', 3), fct.BfvCiphertextNode(f'y{k}', 3)
        ins += [fct.Argument(f'x{k}', x), fct.Argument(f'y{k}', y)]
        outs.append(fct.Argument(f'z{k}', fct.mult_relin(x, y, f'z{k}')))
    fct.process_custom_task(ins, outs, output_instruction_path=str(d))
    return str(d)


@pytest.mark.parametrize('mode', ['eager', 'jit'])
@pytest.mark.parametrize('shape', [(2, 1), (2, 2)], ids=['op2', 'op2xlimb2'])
def test_task_mesh(world, u64, mult_relin_task, shape, mode):
    """FheTask(mesh=...) over (op=2) and (op=2, limb=2), eager and jit: every
    rank's whole outputs equal FheTaskTpu(mesh=...) of the same shape, and
    the op axis gathered the jit plan's fused group."""
    level = 3
    a, b = bfv_pair(u64, level, 8, 9)
    vals = {**{f'x{k}': a[k] for k in range(8)}, **{f'y{k}': b[k] for k in range(8)}}
    from lattisense_tpu.schemes.types import Ciphertext as JCt
    want, _ = FheTaskTpu(mult_relin_task, mode='jit', mesh=jmesh(*shape)).run(
        u64, {k: JCt(data=v, level=level) for k, v in vals.items()})
    got = world.run(ranks.task_run, spec_of(u64, 'BFV', 64, t=T_MOD), mult_relin_task,
                    (*shape, 1), mode, vals, level)
    for out, stats in got:
        assert all(np.array_equal(out[f'z{k}'], np.asarray(want[f'z{k}'].data).astype(np.int64))
                   for k in range(8))
        assert ('all_gather' in stats) == (mode == 'jit' or shape[1] > 1)
        assert stats['staged_bytes'] == 0


def test_task_mesh_coefficient_axis_refused(mult_relin_task):
    """A coefficient axis the ring cannot split (n not divisible by D²) is
    refused; one that can is taken (``tests/test_torch_sharded_engine.py``)."""
    with pytest.raises(ValueError, match=r'not divisible by D\^2=256'):
        FheTask(mult_relin_task, device='cpu',
                mesh=SimpleNamespace(shape={'op': 1, 'limb': 1, 'coeff': 16},
                                     device=torch.device('cpu')))


def test_world_reports_a_rank_error():
    """run_ranks returns the ranks' results in order; a rank's exception
    comes back as a RuntimeError carrying its traceback, and the world is
    stopped."""
    from lattisense_torch.parallel.launch import run_ranks
    assert run_ranks(2, ranks.rank_or_raise, -1, backend='gloo', device='cpu') == [0, 1]
    w = World(2, backend='gloo', device='cpu')
    with pytest.raises(RuntimeError, match='rank 1 refuses'):
        w.run(ranks.rank_or_raise, 1)
    with pytest.raises(RuntimeError, match='closed'):
        w.run(ranks.rank_or_raise, -1)
