"""Where the time of one batched BFV mult_relin step goes, on one CUDA card.

    python -m lattisense_torch.tools.profile_step [--batch 32] [--level 7]

Builds the headline context (``BfvParams.create_tpu_param(16384)``, seed 7),
encrypts 2·batch random messages and prints two JSON lines:

- ``phases``: CUDA-event time of each stage of the step, called in the
  order ``BfvEngine.mult`` and ``BfvEngine.relinearize`` call them (kernel
  B2, tensor product, from-Montgomery + kernel B1 inverse, scale_and_back,
  digit decomposition + mod-up, B1 forward, gadget inner product, B1
  inverse, RoundDivP, final add), beside the whole step's time;
- ``profile``: a ``torch.profiler`` trace of a few steps: device busy time
  per step (sum of kernel times), wall time per step, the device's idle
  share, and the kernels that take the most device time.
"""

import argparse
import json
import subprocess

import numpy as np
import torch

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..ops.behz_cuda import behz_prep32
from ..params import BfvParams
from ..parallel.batch import bfv_mult_relin, key_tree, make_batched_step
from ..runtime import BfvContext
from ..schemes.bfv import tensor_product


def _timer():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def phases(engine, a, b, rlk, level):
    """CUDA-event milliseconds of each stage of one mult + relinearize."""
    ring = engine.ring(level)
    bz = engine.behz(level)
    ra = bz.ring_aux
    sw = engine.switcher
    ring_qp, round_div = sw._level_pre(level)[0], sw._level_pre(level)[5]
    L = level + 1
    marks = [('start', _timer())]
    polys = torch.cat([a[..., :2, :, :], b[..., :2, :, :]], dim=-3)
    fq, fa = behz_prep32(polys, bz)
    marks.append(('behz_prep32 (B2)', _timer()))
    dq, da = tensor_product(fq, ring), tensor_product(fa, ra)
    marks.append(('tensor product', _timer()))
    dq, da = _u.from_mont(dq, ring.q, ring.pinv), _u.from_mont(da, ra.q, ra.pinv)
    marks.append(('from_mont', _timer()))
    dq, da = ntt_mod.intt(dq, ring), ntt_mod.intt(da, ra)
    marks.append(('intt q+aux (B1)', _timer()))
    ct3 = bz.scale_and_back(dq, da)
    marks.append(('scale_and_back', _timer()))
    digits = sw.decompose_modup_ntt(ct3[..., 2, :, :], level)
    marks.append(('decompose+modup+ntt (B1)', _timer()))
    acc = sw.inner_product(digits, rlk, level)
    marks.append(('inner product', _timer()))
    c = ntt_mod.intt(acc, ring_qp)
    marks.append(('intt qp (B1)', _timer()))
    e = round_div(c[..., :L, :], c[..., L:, :])
    marks.append(('RoundDivP', _timer()))
    out = torch.stack([_u.addmod(ct3[..., 0, :, :], e[..., 0, :, :], ring.q),
                       _u.addmod(ct3[..., 1, :, :], e[..., 1, :, :], ring.q)], dim=-3)
    marks.append(('final add', _timer()))
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev) for i, (name, ev) in enumerate(marks) if i}, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--level', type=int, default=7)
    ap.add_argument('--steps', type=int, default=5)
    args = ap.parse_args()
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    params = BfvParams.create_tpu_param(16384)
    ctx = BfvContext.create_random_context(params, seed=7)
    rng = np.random.default_rng(7)
    cts = [ctx.encrypt(ctx.encode(m, args.level))
           for m in rng.integers(0, params.t, (2 * args.batch, params.n))]
    a = torch.stack([c.data for c in cts[:args.batch]])
    b = torch.stack([c.data for c in cts[args.batch:]])
    keys = key_tree(ctx)
    step = make_batched_step(ctx.engine, bfv_mult_relin, args.level)
    want = step(a, b, keys)
    for _ in range(2):
        ph, out = phases(ctx.engine, a, b, keys['rlk'], args.level)
    if not torch.equal(out, want):
        raise AssertionError('the phase-by-phase step differs from make_batched_step')
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        step(a, b, keys)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / args.steps
    print(json.dumps({'phases': {'gpu': gpu, 'batch': args.batch, 'level': args.level,
                                 'step_ms': step_ms, 'sum_of_phases_ms': sum(ph.values()),
                                 'ms': ph}}), flush=True)

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        start.record()
        for _ in range(args.steps):
            step(a, b, keys)
        stop.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(stop) / args.steps
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({'profile': {
        'gpu': gpu, 'steps': args.steps, 'wall_ms_per_step': wall_ms,
        'device_busy_ms_per_step': busy_ms if kernels else None,
        'idle_share': 1 - busy_ms / wall_ms if kernels else None,
        'kernel_launches_per_step': sum(e.count for e in kernels) / args.steps,
        'top': [[e.key[:80], e.self_device_time_total / 1e3 / args.steps, e.count // args.steps]
                for e in top]}}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
