"""The port's sharded CKKS bootstraps on a gloo world of 4 ranks on the CPU,
segment by segment, bit for bit against the JAX package's host (NumPy) walk
of the same context (one seed, so the same keys) at every segment boundary:
``CoeffShardedBootstrap`` over coeff = 4 (the fixture of
``tests/test_sharded_engine.py``, seed 73), ``LimbShardedBootstrap`` over
limb = 4 (``tests/test_parallel.py``'s limb run, seed 71) and over limb = 2 ×
coeff = 2 (its limb × coeff run, seed 72), on the 64-bit chain; the 32-bit
composite chain with the arcsine (``tests/test_bootstrap.py``, seed 7) over
limb = 2 × coeff = 2; and the task runtime's bootstrap node on meshes of
each kind. Every comparison is exact (data, level
and scale). Rank side: ``tests/torch_mesh_ranks.py`` ``btp_walk``.

The JAX walks are made one after another in a thread of the test process
while the ranks run the earlier cases (``host_walks``), and each rank makes
a context once (``btp_context``), so that the file stays within a minute."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.params import CkksParams
from lattisense_tpu.runtime import CkksBtpContext
from lattisense_tpu.schemes.bootstrap import BootstrapConfig
from lattisense_tpu.schemes.types import Ciphertext

from lattisense_torch.parallel.launch import World

from . import torch_mesh_ranks as ranks

N, WORLD = 256, 4
CFG = dict(cts_depth=3, stc_depth=3, k=16, sine_deg=30, double_angle=3)


def u64_args(seed):
    q0 = gen_ntt_primes(N, 61, 1)
    qs = gen_ntt_primes(N, 60, 22)
    p = gen_ntt_primes(N, 61, 3, exclude=tuple(q0))
    return (N, [int(v) for v in q0 + qs], [int(v) for v in p[1:]], float(1 << 45), 64, seed,
            32, CFG)


def w32_args():
    qs = gen_ntt_primes(N, 31, 46)
    p = gen_ntt_primes(N, 31, 3, exclude=tuple(qs))
    return (N, [int(v) for v in qs], [int(v) for v in p], float(1 << 30), 32, 7, 32,
            dict(CFG, message_ratio=8.0, arcsine=True))


@pytest.fixture(scope='module')
def world():
    with World(WORLD, backend='gloo', device='cpu') as w:
        yield w


def host_walk(args, msg_seed):
    """The JAX context of ``args`` and its host walk of one ciphertext at
    the base level: (input, [(name, boundary)])."""
    n, q, p, scale, word, seed, h, cfg = args
    ctx = CkksBtpContext.create_random_context(
        CkksParams.create_custom(n, q, p, scale=scale, word_bits=word), seed=seed, h=h,
        btp_config=BootstrapConfig(**cfg))
    bs = ctx.engine.bootstrapper
    msg = np.random.default_rng(msg_seed).uniform(-1, 1, ctx.params.slots)
    ct = ctx.encrypt(ctx.encode(msg, bs.step - 1))
    ct = Ciphertext(data=np.asarray(ct.data), level=ct.level, is_ntt=True, scale=ct.scale)
    cts, out = (ct,), []
    for name, fn in bs.segments(ct.scale, ctx.swk.get('swk_dts'), ctx.swk.get('swk_std')):
        cts = fn(np, cts, ctx.rlk, ctx.glk.keys)
        out.append((name, cts))
    return ct, out


def assert_walks_equal(got, want, call):
    for segs, whole in got:
        assert [s[0] for s in segs] == [w[0] for w in want]
        for (name, outs), (_, ref) in zip(segs, want):
            assert len(outs) == len(ref), name
            for (data, level, scale), r in zip(outs, ref):
                assert np.array_equal(data, np.asarray(r.data).astype(np.int64)), name
                assert (level, scale) == (r.level, r.scale), name
        if call:
            final = want[-1][1][0]
            assert np.array_equal(whole[0], np.asarray(final.data).astype(np.int64))
            assert (whole[1], whole[2]) == (final.level, final.scale)


# (context arguments, message seed) of each case's JAX walk, in test order
WALKS = {'coeff4': (u64_args(73), 9), 'limb4': (u64_args(71), 3),
         'limb2xcoeff2': (u64_args(72), 4), 'w32': (w32_args(), 5)}


@pytest.fixture(scope='module')
def host_walks():
    """{case: future of ``host_walk``, 'node': future of ``eager_node``},
    computed in order in one thread."""
    with ThreadPoolExecutor(1) as ex:
        futures = {k: ex.submit(host_walk, *v) for k, v in WALKS.items()}
        futures['node'] = ex.submit(eager_node)
        yield futures
        for f in futures.values():
            f.cancel()


@pytest.mark.parametrize('case', [
    ('coeff4', 'coeff', (1, 1, 4), True),
    ('limb4', 'limb', (1, 4, 1), False),
    ('limb2xcoeff2', 'limb', (1, 2, 2), False),
], ids=['coeff4', 'limb4', 'limb2xcoeff2'])
def test_u64_bootstrap_segments(world, host_walks, case):
    """Over coeff = 4 also ``ShardedBootstrap.__call__`` (the same for both
    views) against the walk's end."""
    key, kind, shape, call = case
    ct, want = host_walks[key].result()
    got = world.run(ranks.btp_walk, WALKS[key][0], shape, kind, np.asarray(ct.data), ct.level,
                    ct.scale, call)
    assert_walks_equal(got, want, call)


def test_w32_bootstrap_segments(world, host_walks):
    """The 32-bit composite chain (two limbs a level) over limb = 2 ×
    coeff = 2."""
    ct, want = host_walks['w32'].result()
    got = world.run(ranks.btp_walk, WALKS['w32'][0], (1, 2, 2), 'limb', np.asarray(ct.data),
                    ct.level, ct.scale)
    assert_walks_equal(got, want, False)


def eager_node():
    """The committed n = 256 bootstrap task's input and its single-device
    eager run on the port (itself the JAX package's bit for bit,
    ``tests/test_torch_task.py``)."""
    import torch

    from lattisense_torch.runtime import FheTask, tasks
    b = tasks.bootstrap_n256(64)
    ctx = ranks.btp_context((b['n'], b['q'], b['p'], b['scale'], 64, b['seed'], b['h'],
                             b['cfg']))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        x = ctx.encrypt(ctx.encode(np.random.default_rng(9).uniform(-1, 1, ctx.params.slots),
                                   b['level']))
        want = FheTask(tasks.task_dir(tasks.BOOTSTRAP_N256[64]), mode='eager',
                       device='cpu').run(ctx, {'x': x})[0]['z']
    finally:
        torch.set_num_threads(threads)
    return x, want


@pytest.fixture(scope='module')
def node_eager(host_walks):
    return host_walks['node'].result()


@pytest.mark.parametrize('shape,mode', [((1, 1, 4), 'partitioned'), ((1, 4, 1), 'eager'),
                                        ((1, 2, 2), 'partitioned'), ((4, 1, 1), 'eager')],
                         ids=['coeff4', 'limb4', 'limb2xcoeff2', 'op4'])
def test_bootstrap_node_on_a_mesh(world, node_eager, shape, mode):
    """The committed n = 256 bootstrap task with ``mesh=...``: its node on the
    coefficient view, the limb view, the limb × coefficient view, or over op
    alone (each rank the whole bootstrap), equal to the single-device eager
    run on every rank."""
    x, want = node_eager
    got = world.run(ranks.btp_task_run, 64, shape, (mode,), x.data.numpy(), x.scale)
    for per_rank in got:
        data, level, scale = per_rank[mode]
        assert np.array_equal(data, want.data.numpy())
        assert (level, scale) == (want.level, want.scale)
