"""The port's limb-sharded key switch (``parallel/keyswitch_sharded.py``) on a
gloo world of 4 ranks on the CPU, bit for bit against the JAX package's
``ShardedKeySwitcher`` on the virtual mesh of the same shape, at both words,
limb 2 and 4, directly and from digits. Rank side: ``tests/torch_mesh_ranks.py``."""

import numpy as np
import pytest

import jax

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.parallel.keyswitch_sharded import ShardedKeySwitcher
from lattisense_tpu.parallel.mesh import make_mesh
from lattisense_tpu.params import BfvParams
from lattisense_tpu.runtime import BfvContext

from lattisense_torch.parallel.launch import World

from . import torch_mesh_ranks as ranks
from .test_torch_mesh import same, spec_of

N, LEVEL, WORLD = 64, 7, 4


@pytest.fixture(scope='module')
def world():
    with World(WORLD, backend='gloo', device='cpu') as w:
        yield w


@pytest.fixture(scope='module')
def contexts():
    """Eight q and two p primes, both words, as the JAX package's tests."""
    out = {}
    for word, bits in ((64, 50), (32, 31)):
        q = gen_ntt_primes(N, bits, 8)
        p = gen_ntt_primes(N, bits + (1 if word == 64 else 0), 2, exclude=tuple(q))
        ctx = BfvContext.create_random_context(
            BfvParams.create_custom(N, 257, q, p, word_bits=word), seed=19)
        rng = np.random.default_rng(word)
        x = np.stack([rng.integers(0, qi, N, dtype=np.uint64) for qi in q[:LEVEL + 1]])
        out[word] = (ctx, x.astype(np.uint32 if word == 32 else np.uint64))
    return out


@pytest.mark.parametrize('limb', [2, 4])
@pytest.mark.parametrize('word', [64, 32])
def test_sharded_keyswitch(world, contexts, word, limb):
    """ShardedKeySwitcher over (op=4/limb, limb): limb=4 folds a 4·q sum,
    which passes 2^63 at the 64-bit word."""
    ctx, x = contexts[word]
    mesh = make_mesh(op=WORLD // limb, limb=limb, devices=jax.devices()[:WORLD])
    want = ShardedKeySwitcher(ctx.engine.switcher, LEVEL, mesh)(x, ctx.rlk.key_q, ctx.rlk.key_p)
    got = world.run(ranks.sharded_switch, spec_of(ctx, 'BFV', word, t=257), LEVEL,
                    (WORLD // limb, limb, 1), x, False)
    assert same([g[0] for g in got], want[0]) and same([g[1] for g in got], want[1])


@pytest.mark.parametrize('word', [64, 32])
def test_sharded_switch_from_digits(world, contexts, word):
    """The hoisted entry: KeySwitcher.decompose_modup_ntt's digits through
    the sharded tail over (limb=4)."""
    ctx, x = contexts[word]
    sw = ctx.engine.switcher
    digits = sw.decompose_modup_ntt(np, x, LEVEL)
    mesh = make_mesh(op=1, limb=WORLD, devices=jax.devices()[:WORLD])
    want = ShardedKeySwitcher(sw, LEVEL, mesh).switch_from_digits(digits, ctx.rlk.key_q,
                                                                  ctx.rlk.key_p)
    got = world.run(ranks.sharded_switch, spec_of(ctx, 'BFV', word, t=257), LEVEL,
                    (1, WORLD, 1), x, True)
    assert same([g[0] for g in got], want[0]) and same([g[1] for g in got], want[1])
