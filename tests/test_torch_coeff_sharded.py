"""The port's coefficient-sharded primitives (``parallel/coeff_sharded.py``)
on a gloo world of 4 ranks on the CPU, bit for bit against the JAX package's
on the virtual mesh of the same shape: the distributed NTT at D = 2 and 4 and
both words, the coefficient-sharded and limb×coefficient key switches, the
relinearization and the rotation. Rank side: ``tests/torch_mesh_ranks.py``."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.parallel import coeff_sharded as jcs
from lattisense_tpu.params import BfvParams
from lattisense_tpu.runtime import BfvContext
from lattisense_tpu.schemes.galois import galois_elt_col

from lattisense_torch.parallel.launch import World

from . import oracles
from . import torch_mesh_ranks as ranks
from .test_torch_mesh import same, spec_of

N, T_MOD, LEVEL, WORLD = 1024, 65537, 3, 4


def coeff_mesh(d):
    return Mesh(np.array(jax.devices()[:d]), ('coeff',))


@pytest.fixture(scope='module')
def world():
    with World(WORLD, backend='gloo', device='cpu') as w:
        yield w


@pytest.fixture(scope='module')
def contexts():
    out = {}
    for word, bits in ((64, 50), (32, 31)):
        q = gen_ntt_primes(N, bits, 4)
        p = gen_ntt_primes(N, bits, 2, exclude=tuple(q))
        ctx = BfvContext.create_random_context(
            BfvParams.create_custom(N, T_MOD, q, p, word_bits=word), seed=32)
        ctx.gen_rotation_keys_for_rotations([1])
        out[word] = ctx
    return out


def residues(moduli, word, seed, lead=()):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, (*lead, N), dtype=np.uint64) for q in moduli], axis=-2)
    return x.astype(np.uint32 if word == 32 else np.uint64)


@pytest.mark.parametrize('word', [64, 32])
@pytest.mark.parametrize('D', [2, 4])
def test_dist_ntt(world, word, D):
    """DistNtt forward, inverse of it, and inverse of the same input, on a
    (2, L, n) stack (leading batch dimensions pass through)."""
    moduli = tuple(gen_ntt_primes(N, 50 if word == 64 else 31, 3))
    x = residues(moduli, word, D, lead=(2,))
    dn = jcs.DistNtt(moduli, N, coeff_mesh(D), word_bits=word)
    want = np.asarray(dn.ntt(x))
    got = world.run(ranks.dist_ntt, moduli, N, word, (WORLD // D, 1, D), x)
    assert same([g[0] for g in got], want)
    assert same([g[1] for g in got], x)
    assert same([g[2] for g in got], np.asarray(dn.intt(x)))


@pytest.mark.parametrize('kind', ['coeff', 'limb_coeff'])
@pytest.mark.parametrize('word', [64, 32])
def test_coeff_keyswitch(world, contexts, word, kind):
    """CoeffShardedKeySwitcher over coeff=4 and LimbCoeffKeySwitcher over
    (limb=2, coeff=2)."""
    ctx = contexts[word]
    sw = ctx.engine.switcher
    x = residues(sw.q_moduli[:LEVEL + 1], word, 3)
    if kind == 'coeff':
        ks, shape = jcs.CoeffShardedKeySwitcher(sw, LEVEL, coeff_mesh(4)), (1, 1, 4)
    else:
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ('limb', 'coeff'))
        ks, shape = jcs.LimbCoeffKeySwitcher(sw, LEVEL, mesh), (1, 2, 2)
    want = ks(x, ctx.rlk.key_q, ctx.rlk.key_p)
    got = world.run(ranks.coeff_switch, spec_of(ctx, 'BFV', word, t=T_MOD), LEVEL, shape,
                    kind, x)
    assert same([g[0] for g in got], want[0]) and same([g[1] for g in got], want[1])


@pytest.mark.parametrize('word', [64, 32])
def test_coeff_relin_and_rotate(world, contexts, word):
    """CoeffShardedRelin and CoeffShardedRotator over coeff=4 on a real
    product: equal to the JAX package's, and decrypting to a·b and to it
    rolled by one."""
    ctx = contexts[word]
    rng = np.random.default_rng(4)
    m1, m2 = (rng.integers(0, T_MOD, N, dtype=np.uint64) for _ in range(2))
    ct3 = np.asarray(ctx.mult(ctx.encrypt(ctx.encode(m1, LEVEL)),
                              ctx.encrypt(ctx.encode(m2, LEVEL))).data)
    sw = ctx.engine.switcher
    want = jcs.CoeffShardedRelin(sw, LEVEL, coeff_mesh(4))(ct3, ctx.rlk)
    spec = spec_of(ctx, 'BFV', word, t=T_MOD)
    got = world.run(ranks.coeff_switch, spec, LEVEL, (1, 1, 4), 'relin', ct3)
    assert same(got, want)
    from lattisense_tpu.schemes.types import Ciphertext
    assert np.array_equal(ctx.decrypt_decode(Ciphertext(data=want, level=LEVEL)),
                          oracles.vec_mod_mul(m1, m2, T_MOD))
    elt = galois_elt_col(1, N)
    want_rot = jcs.CoeffShardedRotator(sw, LEVEL, coeff_mesh(4), elt)(want, ctx.glk.keys[elt])
    got_rot = world.run(ranks.coeff_switch, spec, LEVEL, (1, 1, 4), 'rotate', want, elt)
    assert same(got_rot, want_rot)
    assert np.array_equal(ctx.decrypt_decode(Ciphertext(data=want_rot, level=LEVEL)),
                          oracles.vec_rotate_col(oracles.vec_mod_mul(m1, m2, T_MOD), 1))
