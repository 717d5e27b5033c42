"""Throughput of the batched ops (port of ``examples/benchmark/benchmark.py``;
measurement parity with the reference's
examples/benchmark_cpu/benchmark_cpu.cpp: BFV mult_relin, BFV rotate, CKKS
mult_relin — N_OP independent ops, ops/s).

Where the reference extracts parallelism from a 32-thread pool over 1024
graph nodes, the port batches the independent ops on the device
(``parallel/batch.py`` ``make_batched_step``, B=32, level 3). On the card a
step is timed with CUDA events after a warm-up; on the CPU with the host
clock. Element 0 of each batched output must equal the op on that
ciphertext alone and decrypt right. An example, not the benchmark.

Run: ``python -m lattisense_torch.examples.benchmark [--toy] [--n N] [--cpu]``.
"""

import time

import numpy as np
import torch

from ._common import bfv_params, ckks_params, example_args

LEVEL, BATCH, ITERS = 3, 32, 8


def step_ms(fn, device, iters: int = ITERS) -> float:
    """ms a call of ``fn`` after two warm-up calls."""
    for _ in range(2):
        fn()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None) -> dict:
    args = example_args('throughput benchmarks', argv)
    from ..parallel.batch import (bfv_mult_relin, ckks_mult_relin_rescale, key_tree,
                                  make_batched_step, make_rotate_step)
    from ..runtime import BfvContext, CkksContext
    from ..schemes.galois import galois_elt_col
    from ..schemes.types import Ciphertext

    dev = args.device
    rng = np.random.default_rng(0)
    out = {}

    # --- BFV mult_relin + rotate ---
    _, bp = bfv_params(args.n, args.toy)
    bctx = BfvContext.create_random_context(bp, seed=7, device=dev)
    elt = galois_elt_col(1, bp.n)
    bctx.gen_galois_keys_for_elements([elt])
    msgs = rng.integers(0, bp.t, (2 * BATCH, bp.n), dtype=np.uint64)
    cts = [bctx.encrypt(bctx.encode(m, LEVEL)) for m in msgs]
    a = torch.stack([c.data for c in cts[:BATCH]])
    b = torch.stack([c.data for c in cts[BATCH:]])
    keys = key_tree(bctx, galois_elts=[elt])

    fn = make_batched_step(bctx.engine, bfv_mult_relin, LEVEL, n_inputs=2)
    per = step_ms(lambda: fn(a, b, keys), dev)
    got = fn(a, b, keys)
    single = bctx.mult_relin(cts[0], cts[BATCH])
    exact = torch.equal(got[0], single.data)
    right = np.array_equal(bctx.decrypt_decode(Ciphertext(data=got[0], level=LEVEL)),
                           (msgs[0] * msgs[BATCH]) % bp.t)
    out['bfv_mult_relin'] = {'ops_per_s': BATCH * 1e3 / per, 'equal_to_single': exact,
                             'correct': right}
    print(f'BFV  mult_relin n={bp.n} level={LEVEL}: {BATCH * 1e3 / per:10.1f} ops/s')

    fr = make_batched_step(bctx.engine, make_rotate_step(elt), LEVEL, n_inputs=1)
    per = step_ms(lambda: fr(a, keys), dev)
    got = fr(a, keys)
    half = bp.n // 2
    rolled = np.concatenate([np.roll(msgs[0][:half], -1), np.roll(msgs[0][half:], -1)])
    exact = torch.equal(got[0], bctx.rotate_cols(cts[0], 1).data)
    right = np.array_equal(bctx.decrypt_decode(Ciphertext(data=got[0], level=LEVEL)), rolled)
    out['bfv_rotate_col'] = {'ops_per_s': BATCH * 1e3 / per, 'equal_to_single': exact,
                             'correct': right}
    print(f'BFV  rotate_col n={bp.n} level={LEVEL}: {BATCH * 1e3 / per:10.1f} ops/s')

    # --- CKKS mult_relin_rescale ---
    _, cp = ckks_params(args.n, args.toy)
    cctx = CkksContext.create_random_context(cp, seed=9, device=dev)
    vals = rng.uniform(-1, 1, (2 * BATCH, cp.slots))
    ccts = [cctx.encrypt(cctx.encode(v, LEVEL)) for v in vals]
    ca = torch.stack([c.data for c in ccts[:BATCH]])
    cb = torch.stack([c.data for c in ccts[BATCH:]])
    fc = make_batched_step(cctx.engine, ckks_mult_relin_rescale, LEVEL, n_inputs=2,
                           is_ntt=True)
    ckeys = key_tree(cctx)
    per = step_ms(lambda: fc(ca, cb, ckeys), dev)
    got = fc(ca, cb, ckeys)
    single = cctx.rescale(cctx.mult_relin(ccts[0], ccts[BATCH]))
    exact = torch.equal(got[0], single.data)
    err = float(np.abs(cctx.decrypt_decode(single).real - vals[0] * vals[BATCH]).max())
    out['ckks_mult_relin_rescale'] = {'ops_per_s': BATCH * 1e3 / per, 'equal_to_single': exact,
                                      'correct': err < 1e-2, 'max_err': err}
    print(f'CKKS mult_relin_rescale n={cp.n} level={LEVEL}: {BATCH * 1e3 / per:10.1f} ops/s')
    bad = [k for k, v in out.items() if not (v['equal_to_single'] and v['correct'])]
    assert not bad, f'batched steps wrong: {bad}'
    print('OK')
    return out


if __name__ == '__main__':
    main()
