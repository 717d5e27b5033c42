"""Where the time of one batched BFV or CKKS step goes, on one CUDA card.

    python -m lattisense_torch.tools.profile_step [--scheme bfv|ckks]
        [--chain w32|u64] [--op mult_relin|mult_relin_rescale|rotate] [--n 16384]
        [--batch 32] [--level L] [--steps 5]
    python -m lattisense_torch.tools.profile_step --scheme ckks --op bootstrap
        [--profile toy|full|w32] [--steps 5]

Builds a context (seed 7) on the chosen chain at ring degree n — ``w32``,
the 31-bit profile ``BfvParams.create_tpu_param(n)`` (default level 7 at
n=16384, the headline), or ``u64``, the conformance chain
``BfvParams.create(n)`` (default level 3 at n=16384); at any other n the
default level is the chain's top (11 and 21 at n=32768, where B5 runs
split) — encrypts 2·batch random messages and prints two JSON lines for the
chosen operation:

- ``phases``: the program's own spans (``utils/observability.py``) in a
  ``torch.profiler`` window of ``--steps`` calls of the real entry
  (``parallel/batch.py`` ``make_batched_step``), beside the untraced step's
  time: under ``ms`` each span's device ms a step between its CUDA events,
  under ``spans`` also its calls, host and host-self ms and kernel launches a
  step. BFV ``mult_relin``: ``bfv.mult`` with ``bfv.behz_prep`` (B2),
  ``bfv.tensor_product`` and ``bfv.behz_finish`` (B4) on the w32 chain, or
  ``bfv.tensor_product`` and ``bfv.scale_and_back`` on the u64 chain; then
  ``bfv.relinearize`` and its ``ksw.switch`` (B3 in one call on the w32
  chain; on the u64 chain its stages ``ksw.modup`` (B6), ``ksw.ntt`` (B5),
  ``ksw.inner`` (B7), ``ksw.intt`` (B5), ``ksw.moddown`` (``RoundDivP``,
  B6)); ``rotate``: ``bfv.apply_galois`` with ``galois.automorphism`` and
  ``ksw.switch``. With ``--scheme ckks`` the chains are
  ``CkksParams.create(n)`` (u64, default level 3) and, at the 32-bit word,
  the primes of ``CkksParams.create_tpu_param(n)`` at scale 2^60 (default
  level 10, two rescales a multiplication); ``mult_relin_rescale``:
  ``ckks.mult``, ``ckks.relinearize`` and its ``ksw.switch`` (with
  ``ksw.output_ntt`` on the u64 chain), and each ``ckks.rescale`` with its
  ``ckks.divround``; ``rotate``: the ``ksw.switch`` of
  ``CkksEngine.apply_galois``;
- ``profile``: the same window's device busy time per step (sum of kernel
  times), wall time per step, the device's idle share, and the kernels that
  take the most device time.

``--op bootstrap`` builds the ``CkksBtpContext`` of one of the JAX package's
bootstrap runs (``schemes/bootstrap_params.py`` ``reference_run``: the toy
profile at n=8192, the full one at n=2^16, or the 31-bit
``create_tpu_btp_param()``), bootstraps its message once (the host encoding
of the transforms' diagonals happens there), and prints ``phases`` (the
CUDA-event ms of each segment of ``CkksBootstrapper.segments`` beside a
whole bootstrap's, the key set's bytes, keygen seconds, the output level and
decoded error) and ``profile`` (busy and wall ms a bootstrap, idle share and
the top kernels by device time).
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..params import BfvParams, CkksParams
from ..parallel.batch import (bfv_mult_relin, ckks_composite_params, ckks_mult_relin_rescale,
                              ckks_mult_relin_rescale2, key_tree, make_batched_step,
                              make_rotate_step)
from ..runtime import BfvContext, CkksBtpContext, CkksContext
from ..schemes.bootstrap_params import reference_run
from ..schemes.galois import galois_elt_col
from ..utils import observability


def _timer():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


# ---------------------------------------------------------------------------
# CKKS bootstrapping (--op bootstrap)
# ---------------------------------------------------------------------------

def bootstrap_context(name: str, device=None):
    """A ``CkksBtpContext`` of the JAX package's bootstrap run ``name``
    (``schemes/bootstrap_params.py`` ``reference_run``: toy, full or w32) on
    ``device``; → (context, the run's fields, keygen seconds)."""
    run = reference_run(name)
    t0 = time.perf_counter()
    ctx = CkksBtpContext.create_random_context(run['params'], seed=run['seed'], h=run['h'],
                                               btp_config=run['config'], device=device)
    return ctx, run, time.perf_counter() - t0


def bootstrap_input(ctx, run):
    """The run's message (uniform(-1, 1) slots from its message seed) and its
    encryption at the run's input level and scale."""
    msg = np.random.default_rng(run['msg_seed']).uniform(-1, 1, ctx.params.slots)
    return msg, ctx.encrypt(ctx.engine.encode(msg, run['level'], run['scale']))


def key_bytes(ctx) -> int:
    """Bytes of the context's public, relinearization, Galois and switching
    keys on its device."""
    keys = [ctx.rlk] + list(ctx.glk.keys.values()) + list(ctx.swk.values())
    return (ctx.pk.data.numel() * 8
            + sum((k.key_q.numel() + k.key_p.numel()) * 8 for k in keys))


def bootstrap_segments(ctx, ct, keep=()):
    """``ctx.bootstrap(ct)`` segment by segment (``CkksBootstrapper.segments``),
    each between two CUDA events on the card; → ({segment: ms}, the output,
    {segment: (its input, its output)} for the names in ``keep``)."""
    btp = ctx.engine.bootstrapper
    cts, marks, kept = (btp.prepare(ct),), [], {}
    timed = ctx.engine.device.type == 'cuda'
    for name, fn in btp.segments(ct.scale, ctx.swk.get('swk_dts'), ctx.swk.get('swk_std')):
        start = _timer() if timed else None
        out = fn(cts, ctx.rlk, ctx.glk.keys)
        marks.append((name, start, _timer() if timed else None))
        if name in keep:
            kept[name] = (cts, out)
        cts = out
    if timed:
        torch.cuda.synchronize()
    ms = {name: a.elapsed_time(b) if timed else None for name, a, b in marks}
    return ms, cts[0], kept


def profile_bootstrap(name: str, steps: int, gpu: str):
    """The ``phases`` (CUDA-event ms of each segment beside the whole
    bootstrap's) and ``profile`` (device time by kernel) lines of one
    bootstrap run."""
    ctx, run, keygen_s = bootstrap_context(name)
    msg, ct = bootstrap_input(ctx, run)
    want = ctx.bootstrap(ct)                          # warm-up: encodings, tables
    ms, out, _ = bootstrap_segments(ctx, ct)
    if not torch.equal(out.data, want.data):
        raise AssertionError('the segment walk differs from ctx.bootstrap')
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        ctx.bootstrap(ct)
    stop.record()
    torch.cuda.synchronize()
    btp_ms = start.elapsed_time(stop) / steps
    err = float(np.abs(ctx.decrypt_decode(out).real - msg).max())
    print(json.dumps({'phases': {
        'gpu': gpu, 'op': 'bootstrap', 'profile': name, 'n': ctx.params.n,
        'word_bits': ctx.params.word_bits, 'bootstrap_ms': btp_ms,
        'sum_of_segments_ms': sum(ms.values()), 'segments_ms': ms, 'out_level': out.level,
        'max_abs_err': err, 'keygen_s': keygen_s, 'key_bytes': key_bytes(ctx)}}), flush=True)
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        start.record()
        for _ in range(steps):
            ctx.bootstrap(ct)
        stop.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(stop) / steps
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]
    print(json.dumps({'profile': {
        'gpu': gpu, 'op': 'bootstrap', 'profile': name, 'steps': steps,
        'wall_ms_per_bootstrap': wall_ms,
        'device_busy_ms_per_bootstrap': busy if kernels else None,
        'idle_share': 1 - busy / wall_ms if kernels else None,
        'kernel_launches_per_bootstrap': sum(e.count for e in kernels) / steps,
        'top': [[e.key[:80], e.self_device_time_total / 1e3 / steps, e.count // steps]
                for e in top]}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--scheme', choices=('bfv', 'ckks'), default='bfv')
    ap.add_argument('--chain', choices=('w32', 'u64'), default='w32')
    ap.add_argument('--op', choices=('mult_relin', 'mult_relin_rescale', 'rotate', 'bootstrap'),
                    default=None, help='default mult_relin (BFV), mult_relin_rescale (CKKS)')
    ap.add_argument('--profile', choices=('toy', 'full', 'w32'), default='toy',
                    help='--op bootstrap: the reference run (schemes/bootstrap_params.py)')
    ap.add_argument('--n', type=int, default=16384, help='ring degree: 16384 or 32768')
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--level', type=int, default=None,
                    help='default at n=16384 7 on the w32 chain, 3 on the u64 chain (CKKS: '
                         '10 and 3); else the chain\'s top level')
    ap.add_argument('--steps', type=int, default=5)
    args = ap.parse_args()
    u64 = args.chain == 'u64'
    ckks = args.scheme == 'ckks'
    if args.op is None:
        args.op = 'mult_relin_rescale' if ckks else 'mult_relin'
    if (args.op == 'mult_relin_rescale') != ckks and args.op not in ('rotate', 'bootstrap'):
        ap.error(f'--op {args.op} is not a {args.scheme} operation')
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.op == 'bootstrap':
        if not ckks:
            ap.error('--op bootstrap is a ckks operation')
        profile_bootstrap(args.profile, args.steps, gpu)
        return 0
    if ckks:
        params = CkksParams.create(args.n) if u64 else ckks_composite_params(args.n)
        top = (3 if u64 else 10) if args.n == 16384 else params.max_level
        ctx = CkksContext.create_random_context(params, seed=7)
    else:
        params = BfvParams.create(args.n) if u64 else BfvParams.create_tpu_param(args.n)
        top = (3 if u64 else 7) if args.n == 16384 else params.max_level
        ctx = BfvContext.create_random_context(params, seed=7)
    if args.level is None:
        args.level = top
    rng = np.random.default_rng(7)
    msgs = (rng.uniform(-1, 1, (2 * args.batch, params.slots)) if ckks
            else rng.integers(0, params.t, (2 * args.batch, params.n)))
    cts = [ctx.encrypt(ctx.encode(m, args.level)) for m in msgs]
    a = torch.stack([c.data for c in cts[:args.batch]])
    b = torch.stack([c.data for c in cts[args.batch:]])
    if args.op == 'rotate':
        elt = galois_elt_col(1, params.n)
        ctx.gen_galois_keys_for_elements([elt])
        inputs = (a, key_tree(ctx, galois_elts=[elt]))
        step = make_batched_step(ctx.engine, make_rotate_step(elt), args.level, n_inputs=1,
                                 is_ntt=ckks)
    elif ckks:
        inputs = (a, b, key_tree(ctx))
        step = make_batched_step(ctx.engine,
                                 ckks_mult_relin_rescale if u64 else ckks_mult_relin_rescale2,
                                 args.level, is_ntt=True)
    else:
        inputs = (a, b, key_tree(ctx))
        step = make_batched_step(ctx.engine, bfv_mult_relin, args.level)
    for _ in range(2):                                # warm-up: tables, kernels
        step(*inputs)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        step(*inputs)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / args.steps

    observability.reset()
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        start.record()
        for _ in range(args.steps):
            step(*inputs)
        stop.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(stop) / args.steps
    spans = {name: {k: (v / args.steps if v is not None else None) for k, v in t.items()
                    if k in ('calls', 'host_ms', 'host_self_ms', 'device_ms', 'launches')}
             for name, t in observability.totals().items()}
    print(json.dumps({'phases': {'gpu': gpu, 'scheme': args.scheme, 'chain': args.chain,
                                 'op': args.op, 'n': args.n, 'batch': args.batch,
                                 'level': args.level, 'step_ms': step_ms,
                                 'traced_step_ms': wall_ms,
                                 'ms': {k: v['device_ms'] for k, v in spans.items()},
                                 'spans': spans}}), flush=True)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({'profile': {
        'gpu': gpu, 'scheme': args.scheme, 'chain': args.chain, 'op': args.op, 'n': args.n,
        'steps': args.steps,
        'wall_ms_per_step': wall_ms,
        'device_busy_ms_per_step': busy_ms if kernels else None,
        'idle_share': 1 - busy_ms / wall_ms if kernels else None,
        'kernel_launches_per_step': sum(e.count for e in kernels) / args.steps,
        'top': [[e.key[:80], e.self_device_time_total / 1e3 / args.steps, e.count // args.steps]
                for e in top]}}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
