"""Time the compiled-task runtime of one checkout on one CUDA card.

    python lattisense_torch/tools/task_bench.py [--root DIR] [--iters 20]

Imports ``lattisense_torch`` from the checkout at ``--root`` (by default the
one holding this script), so one call can time two checkouts of the
repository on the same card, in turns (A, B, B, A). Runs the committed
32-``mult_relin`` task (``runtime/tasks/bfv_mult_relin_x32_w32_n16384_l7``,
``chip_smoke.py``'s ``task_path``) on a context of seed 7 on
``BfvParams.create_tpu_param(16384)``, eager and replayed as one CUDA graph,
and prints one JSON line ``{"task_bench": {...}}`` with the mean of the
runtime's ``duration_ns`` over ``--iters`` runs of each (after a warm-up
run and the graph's capture), the wall ms of a whole ``run`` call (the
checks and the output wrapping included), the root and the card's name and
power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('task_bench: needs a CUDA card', file=sys.stderr)
        return 2
    import lattisense_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(lattisense_torch.__file__))) != root:
        print(f'task_bench: lattisense_torch was not imported from {root}', file=sys.stderr)
        return 2
    from lattisense_torch.params import BfvParams
    from lattisense_torch.runtime import BfvContext, FheTask, tasks

    dev = torch.device('cuda', torch.cuda.current_device())
    params = BfvParams.create_tpu_param(16384)
    ctx = BfvContext.create_random_context(params, seed=7, device=dev)
    msgs = np.random.default_rng(7).integers(0, params.t, (64, params.n))
    cts = [ctx.encrypt(ctx.encode(m, 7)) for m in msgs]
    online = tasks.mult_relin_arguments(cts[:32], cts[32:])
    out = {'root': root}
    for mode in ('eager', 'jit'):
        task = FheTask(tasks.task_dir(tasks.MULT_RELIN), mode=mode, device=dev)
        task.run(ctx, online)                        # warm-up; the graph's capture
        ns, wall = [], []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            ns.append(task.run(ctx, online)[1])
            wall.append(time.perf_counter() - t0)
        out[f'{mode}_ms'] = sum(ns) / len(ns) / 1e6
        out[f'{mode}_wall_ms'] = sum(wall) / len(wall) * 1e3
    out['gpu'] = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                                 '--format=csv,noheader'], capture_output=True, text=True,
                                timeout=60).stdout.strip()
    print(json.dumps({'task_bench': out}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
