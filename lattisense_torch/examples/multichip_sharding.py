"""Example: the three sharding axes on a mesh of four ranks (port of
``examples/multichip_sharding/multichip_sharding.py``).

One ``run_ranks`` world of 4 ranks over gloo (``parallel/launch.py``), one
process a rank, runs four sections, each asserted bit for bit against the
single-device path on every rank:

1. **op axis** — a batch of independent mult_relin ops split over the ranks
   (graph-level data parallelism: the reference thread pool's role,
   SURVEY §2.8);
2. **op×limb** — ONE ciphertext's RNS limbs split: the integrated pipeline
   (``make_limb_tp_mult_relin``: the limb-sharded key switch);
3. **coefficient axis** — ONE ciphertext's ring coefficients split: the
   distributed four-step NTT, with relinearization (``CoeffShardedRelin``)
   and a rotation (``CoeffShardedRotator``), all_to_all between the
   butterfly phases;
4. **the sharded engine** — the engine's own ops on coefficient shards
   (``make_coeff_sharded_engine``).

The ranks compute on the CPU with ``--cpu`` and share the card otherwise
(NCCL refuses two ranks on one card). The JAX example's virtual device mesh
(``XLA_FLAGS``) has no counterpart: the ranks are processes.

Run: ``python -m lattisense_torch.examples.multichip_sharding [--toy] [--cpu]``
(n=256 with ``--toy``, else 4096).
"""

import numpy as np
import torch

from ._common import example_args

WORLD, T_MOD, LEVEL, SEED, BATCH = 4, 65537, 3, 42, 8


def params_for(n: int):
    from ..core.modring import gen_ntt_primes
    from ..params import BfvParams
    q = gen_ntt_primes(n, 50, 4)
    p = gen_ntt_primes(n, 51, 2, exclude=tuple(q))
    return BfvParams.create_custom(n, T_MOD, q, p)


def rank_sections(n: int, device) -> dict:
    """The four sections on this rank; → {section: bit-exact on this rank},
    and on rank 0 the rotated product's decryption against its oracle."""
    import torch.distributed as dist

    from ..parallel.batch import (bfv_mult_relin, key_tree, make_batched_step,
                                  make_limb_tp_mult_relin)
    from ..parallel.coeff_sharded import CoeffShardedRelin, CoeffShardedRotator
    from ..parallel.mesh import ct_batch_spec, make_mesh, shard, unshard
    from ..parallel.sharded_engine import make_coeff_sharded_engine
    from ..runtime import BfvContext
    from ..schemes.galois import galois_elt_col
    from ..schemes.types import Ciphertext

    mesh = make_mesh(op=WORLD, limb=1, device=device)
    dev = mesh.device
    ctx = BfvContext.create_random_context(params_for(n), seed=SEED, device=dev)
    eng = ctx.engine
    gal = galois_elt_col(1, n)
    ctx.gen_galois_keys_for_elements([gal])
    rng = np.random.default_rng(0)
    m1 = rng.integers(0, T_MOD, n, dtype=np.uint64)
    m2 = rng.integers(0, T_MOD, n, dtype=np.uint64)
    a = ctx.encrypt(ctx.encode(m1, LEVEL))
    b = ctx.encrypt(ctx.encode(m2, LEVEL))
    golden = eng.relinearize(eng.mult(a, b), ctx.rlk).data
    out = {}

    # ---- 1. op axis: a batch of ops split over the 4 ranks ---------------
    fn = make_batched_step(eng, bfv_mult_relin, LEVEL, mesh=mesh, n_inputs=2)
    spec = ct_batch_spec()
    whole_a = a.data.unsqueeze(0).repeat(BATCH, 1, 1, 1)
    whole_b = b.data.unsqueeze(0).repeat(BATCH, 1, 1, 1)
    got = unshard(mesh, fn(shard(mesh, whole_a, spec), shard(mesh, whole_b, spec),
                           key_tree(ctx)), spec)
    out['op_axis'] = all(torch.equal(got[i], golden) for i in range(BATCH))

    # ---- 2. op×limb: the limb-sharded key switch -------------------------
    mesh2 = make_mesh(op=2, limb=2, device=device)
    f2, prep = make_limb_tp_mult_relin(eng, LEVEL, mesh2)
    kd = prep(ctx.rlk.key_q, ctx.rlk.key_p)
    got2 = unshard(mesh2, f2(shard(mesh2, whole_a[:4], spec), shard(mesh2, whole_b[:4], spec),
                             kd), spec)
    out['op_limb'] = all(torch.equal(got2[i], golden) for i in range(4))

    # ---- 3. coeff axis: ONE ciphertext spanning the 4 ranks --------------
    cmesh = make_mesh(op=1, limb=1, coeff=WORLD, device=device)
    ct3 = eng.mult(a, b)
    got3 = CoeffShardedRelin(eng.switcher, LEVEL, cmesh)(ct3.data, ctx.rlk)
    rot = CoeffShardedRotator(eng.switcher, LEVEL, cmesh, gal)(got3, ctx.glk.keys[gal])
    ref_rot = eng.apply_galois(Ciphertext(data=got3, level=LEVEL), gal, ctx.glk.keys[gal])
    out['coeff_relin'] = torch.equal(got3, golden)
    out['coeff_rotate'] = torch.equal(rot, ref_rot.data)

    # ---- 4. the sharded engine: the engine's ops on coefficient shards ----
    eng_sh = make_coeff_sharded_engine(eng, cmesh)
    c = eng_sh.relinearize(eng_sh.mult(eng_sh.shard_ct(a), eng_sh.shard_ct(b)), ctx.rlk)
    c = eng_sh.apply_galois(c, gal, ctx.glk.keys[gal])
    out['sharded_engine'] = torch.equal(eng_sh.gather_ct(c).data, rot)

    if dist.get_rank() == 0:
        dec = ctx.decrypt_decode(Ciphertext(data=rot, level=LEVEL))
        prod = (m1 * m2) % T_MOD
        half = n // 2
        expect = np.concatenate([np.roll(prod[:half], -1), np.roll(prod[half:], -1)])
        out['decrypts'] = bool(np.array_equal(dec, expect))
    return out


def main(argv=None) -> dict:
    args = example_args('multi-rank sharding (op / limb / coeff axes)', argv)
    from ..parallel.launch import run_ranks

    n = 256 if args.toy else 4096
    device = 'cpu' if args.cpu else None
    ranks = run_ranks(WORLD, rank_sections, n, device, backend='gloo', device=args.device)
    ok = {k: all(r.get(k, True) for r in ranks) for k in ranks[0]}
    assert all(ok.values()), f'sections differ from the single-device path: {ok}'
    print(f'op axis: {BATCH} ops split over {WORLD} ranks — bit-exact')
    print('op×limb: RNS limbs of each key switch sharded — bit-exact')
    print(f'coeff axis: one ciphertext over {WORLD} ranks (distributed NTT), '
          'relin + rotation — bit-exact, decrypts to the oracle')
    print('sharded engine: BEHZ mult + relinearize + rotation on coefficient '
          'shards — bit-exact')
    print('OK')
    return {'n': n, 'world': WORLD, 'sections': ok}


if __name__ == '__main__':
    main()
