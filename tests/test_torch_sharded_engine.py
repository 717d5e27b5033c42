"""The port's coefficient-sharded engine view (``parallel/sharded_engine.py``
``make_coeff_sharded_engine``) on a gloo world of 4 ranks on the CPU: the
unmodified scheme layer on this rank's coefficient shards, at D = 2 and 4 and
both words, bit for bit against the JAX package's NumPy engine on the same
inputs and keys (the cases of ``tests/test_sharded_engine.py``): CKKS
mult_relin_rescale, rotation and hoisted rotation; BFV ct × ct mult (the
unfused BEHZ route, with no fused kernel on a shard), relinearization and
rotate_col. One case a word also against the JAX package's own view under
``shard_map``. Every comparison is exact. Rank side:
``tests/torch_mesh_ranks.py``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.parallel.sharded_engine import make_coeff_sharded_engine
from lattisense_tpu.params import BfvParams, CkksParams
from lattisense_tpu.runtime import BfvContext, CkksContext
from lattisense_tpu.schemes.galois import galois_elt_col
from lattisense_tpu.schemes.types import Ciphertext

from lattisense_torch.parallel.launch import World

from . import torch_mesh_ranks as ranks
from .test_torch_mesh import same, spec_of

N, T_MOD, LEVEL, WORLD = 256, 65537, 3, 4
ELT = galois_elt_col(1, N)
SCALE = {64: float(1 << 40), 32: float(1 << 25)}


@pytest.fixture(scope='module')
def world():
    with World(WORLD, backend='gloo', device='cpu') as w:
        yield w


@pytest.fixture(scope='module')
def ckks():
    """The CKKS contexts of tests/test_sharded_engine.py (seed 11)."""
    out = {}
    for wb in (64, 32):
        if wb == 64:
            params = CkksParams.create_custom(N, gen_ntt_primes(N, 50, 5), gen_ntt_primes(N, 51, 2),
                                              scale=SCALE[64])
        else:
            params = CkksParams.create_custom(N, gen_ntt_primes(N, 31, 6), gen_ntt_primes(N, 30, 2),
                                              scale=SCALE[32], word_bits=32)
        ctx = CkksContext.create_random_context(params, seed=11)
        ctx.gen_galois_keys_for_elements([ELT])
        out[wb] = ctx
    return out


@pytest.fixture(scope='module')
def bfv():
    """The BFV context of tests/test_sharded_engine.py (seed 23) and its
    31-bit twin."""
    out = {}
    for wb, bits in ((64, 50), (32, 31)):
        q = gen_ntt_primes(N, bits, 4)
        p = gen_ntt_primes(N, bits + 1 if wb == 64 else bits, 2, exclude=tuple(q))
        ctx = BfvContext.create_random_context(BfvParams.create_custom(N, T_MOD, q, p,
                                                                       word_bits=wb), seed=23)
        ctx.gen_galois_keys_for_elements([ELT])
        out[wb] = ctx
    return out


def _shape(D):
    return (WORLD // D, 1, D)


@pytest.mark.parametrize('kind', ['mult_relin_rescale', 'rotate', 'hoisted'])
@pytest.mark.parametrize('D', [2, 4])
@pytest.mark.parametrize('wb', [64, 32])
def test_ckks_view(world, ckks, wb, D, kind):
    ctx = ckks[wb]
    eng = ctx.engine
    rng = np.random.default_rng(5)
    a = ctx.encrypt(ctx.encode(rng.uniform(-1, 1, ctx.params.slots), LEVEL))
    b = ctx.encrypt(ctx.encode(rng.uniform(-1, 1, ctx.params.slots), LEVEL))
    if kind == 'mult_relin_rescale':
        want = eng.rescale(np, eng.relinearize(np, eng.mult(np, a, b), ctx.rlk))
    elif kind == 'rotate':
        want = eng.apply_galois(np, a, ELT, ctx.glk.keys[ELT])
    else:
        want = eng.apply_galois_decomposed(np, eng.rns_sp_decomp(np, a), ELT, ctx.glk.keys[ELT])
    got = world.run(ranks.engine_view, spec_of(ctx, 'CKKS', wb, scale=SCALE[wb]), _shape(D),
                    kind, LEVEL, [np.asarray(a.data), np.asarray(b.data)], ELT, a.scale)
    assert same(got, want.data)


@pytest.mark.parametrize('kind', ['mult', 'relin', 'rotate'])
@pytest.mark.parametrize('D', [2, 4])
@pytest.mark.parametrize('wb', [64, 32])
def test_bfv_view(world, bfv, wb, D, kind):
    ctx = bfv[wb]
    eng = ctx.engine
    rng = np.random.default_rng(8)
    a, b = (ctx.encrypt(ctx.encode(rng.integers(0, T_MOD, N, dtype=np.uint64), LEVEL))
            for _ in range(2))
    ct3 = eng.mult(np, a, b)
    if kind == 'mult':
        datas, want = [a.data, b.data], ct3
    elif kind == 'relin':
        datas, want = [ct3.data], eng.relinearize(np, ct3, ctx.rlk)
    else:
        datas, want = [a.data], eng.apply_galois(np, a, ELT, ctx.glk.keys[ELT])
    got = world.run(ranks.engine_view, spec_of(ctx, 'BFV', wb, t=T_MOD), _shape(D), kind,
                    LEVEL, [np.asarray(d) for d in datas], ELT)
    assert same(got, want.data)


def _jax_view(eng, fn, datas, keys):
    """fn on the JAX package's coefficient-sharded view under shard_map over
    4 virtual devices (tests/test_sharded_engine.py ``_sharded_call``)."""
    mesh = Mesh(np.array(jax.devices()[:4]), ('coeff',))
    view = make_coeff_sharded_engine(eng, mesh)

    def spec(x):
        return P(*([None] * (np.ndim(x) - 1)), 'coeff')

    smap = jax.shard_map(lambda ds, ks: fn(view, ds, ks), mesh=mesh,
                         in_specs=(jax.tree.map(spec, tuple(datas)), jax.tree.map(spec, keys)),
                         out_specs=spec(np.zeros((1, 1, 1))), check_vma=False)
    return np.asarray(jax.jit(smap)(tuple(datas), keys))


@pytest.mark.parametrize('wb', [64, 32])
def test_ckks_view_against_the_jax_view(world, ckks, wb):
    """CKKS mult_relin_rescale through both packages' views over coeff=4."""
    ctx = ckks[wb]
    rng = np.random.default_rng(6)
    a, b = (ctx.encrypt(ctx.encode(rng.uniform(-1, 1, ctx.params.slots), LEVEL))
            for _ in range(2))

    def fn(e, ds, ks):
        ca, cb = (Ciphertext(data=d, level=LEVEL, is_ntt=True, scale=a.scale) for d in ds)
        return e.rescale(jnp, e.relinearize(jnp, e.mult(jnp, ca, cb), ks)).data

    want = _jax_view(ctx.engine, fn, (np.asarray(a.data), np.asarray(b.data)), ctx.rlk)
    got = world.run(ranks.engine_view, spec_of(ctx, 'CKKS', wb, scale=SCALE[wb]), _shape(4),
                    'mult_relin_rescale', LEVEL, [np.asarray(a.data), np.asarray(b.data)], ELT,
                    a.scale)
    assert same(got, want)


@pytest.mark.parametrize('wb', [64, 32])
def test_bfv_pipeline_and_refusals(world, bfv, wb):
    """BFV mult + relinearize + rotate_col in one sharded pipeline at D = 2,
    and a PlaintextRingt operand refused."""
    ctx = bfv[wb]
    eng = ctx.engine
    rng = np.random.default_rng(9)
    a, b = (ctx.encrypt(ctx.encode(rng.integers(0, T_MOD, N, dtype=np.uint64), LEVEL))
            for _ in range(2))
    want = eng.apply_galois(np, eng.relinearize(np, eng.mult(np, a, b), ctx.rlk), ELT,
                            ctx.glk.keys[ELT])
    got = world.run(ranks.engine_view, spec_of(ctx, 'BFV', wb, t=T_MOD), _shape(2),
                    'mult_relin_rotate', LEVEL, [np.asarray(a.data), np.asarray(b.data)], ELT)
    assert same(got, want.data)
    refused = world.run(ranks.engine_view_refusal, spec_of(ctx, 'BFV', wb, t=T_MOD), _shape(2))
    assert all('PlaintextRingt' in r for r in refused)


@pytest.fixture(scope='module')
def rotate_task(tmp_path_factory, bfv):
    """The task of tests/test_parallel.py:401 (4 × rotate_cols(mult_relin(x,
    y), 1)) on the u64 context, its inputs and the JAX package's eager run."""
    from lattisense_tpu.frontend import custom_task as fct
    from lattisense_tpu.runtime import FheTaskTpu
    ctx = bfv[64]
    path = str(tmp_path_factory.mktemp('coeff_task'))
    p = ctx.params
    fct.set_fhe_param(fct.BfvParam.create_custom_param(n=N, q=list(p.q), p=list(p.p), t=T_MOD))
    ins, outs = [], []
    for k in range(4):
        xk = fct.BfvCiphertextNode(f'x{k}', LEVEL)
        yk = fct.BfvCiphertextNode(f'y{k}', LEVEL)
        ins += [fct.Argument(f'x{k}', xk), fct.Argument(f'y{k}', yk)]
        zk = fct.mult_relin(xk, yk, f'z{k}')
        outs.append(fct.Argument(f'r{k}', fct.rotate_cols(zk, [1], f'r{k}')[0]))
    fct.process_custom_task(ins, outs, output_instruction_path=path)
    rng = np.random.default_rng(17)
    vals = {f'{v}{k}': ctx.encrypt(ctx.encode(rng.integers(0, T_MOD, N, dtype=np.uint64), LEVEL))
            for k in range(4) for v in 'xy'}
    want, _ = FheTaskTpu(path, mode='eager').run(ctx, vals)
    return path, vals, want


@pytest.mark.parametrize('shape', [(1, 1, 4), (1, 2, 2), (2, 1, 2)],
                         ids=['coeff4', 'limb2xcoeff2', 'op2xcoeff2'])
def test_task_coeff_axis(world, bfv, rotate_task, shape):
    """FheTask(mesh=...) with a coefficient axis, its fused groups over op,
    their switches' digits over limb and every polynomial over coeff, equal
    to the JAX package's eager run on every rank."""
    path, vals, want = rotate_task
    ctx = bfv[64]
    got = world.run(ranks.task_run, spec_of(ctx, 'BFV', 64, t=T_MOD), path, shape, 'jit',
                    {k: np.asarray(v.data) for k, v in vals.items()}, LEVEL)
    for k in range(4):
        assert same([g[0][f'r{k}'] for g in got], want[f'r{k}'].data)
    stats = got[0][1]
    assert stats['all_to_all']['calls'] > 0 and stats['all_gather']['calls'] > 0
