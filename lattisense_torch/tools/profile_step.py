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

- ``phases``: CUDA-event time of each stage of the step, called in the
  order the engine calls them, beside the whole step's time. On the w32
  chain, ``mult_relin``: kernel B2, tensor product, kernel B4 (the finish),
  kernel B3 (the relinearization key switch), final add; ``rotate``
  (rotate_col by 1): the automorphism of both components, kernel B3, the
  final add. On the u64 chain, ``mult_relin``: the BEHZ extension (B6),
  the forward NTTs (B5), the tensor product, the inverse NTTs (B5),
  ``scale_and_back`` (B6), then the key switch in its stages — digit
  decomposition and mod-up (B6), forward NTT (B5), inner product (B7),
  inverse NTT (B5), ``RoundDivP``'s conversion and modular arithmetic (B6)
  and its float64 overflow estimate — and the final add; ``rotate``: the
  automorphism, the same key-switch stages, the final add.
  With ``--scheme ckks`` the chains are ``CkksParams.create(n)`` (u64,
  default level 3) and, at the 32-bit word, the primes of
  ``CkksParams.create_tpu_param(n)`` at scale 2^60 (default level 10, two
  rescales a multiplication); ``mult_relin_rescale``: the NTT-domain tensor
  product, the INTT of c2 (B1 / B5), the key switch with NTT output (B3,
  or the u64 stages above and the output NTT), the final add, and each
  rescale's INTT, divide-and-round and NTT; ``rotate``: the NTT-domain
  automorphism, the INTT of c1, the key switch, the final add;
- ``profile``: a ``torch.profiler`` trace of a few steps: device busy time
  per step (sum of kernel times), wall time per step, the device's idle
  share, and the kernels that take the most device time.

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

from ..core import u64 as _u
from ..ops.bconv_cuda import bconv64_raw
from ..ops.behz_cuda import behz_finish32, behz_prep32
from ..ops.ksw64_cuda import ksw_inner64
from ..ops.ksw_cuda import ksw_switch32
from ..ops.ntt64_cuda import ntt64_fwd, ntt64_inv
from ..core import ntt as ntt_mod
from ..params import BfvParams, CkksParams
from ..parallel.batch import (bfv_mult_relin, ckks_composite_params, ckks_mult_relin_rescale,
                              ckks_mult_relin_rescale2, key_tree, make_batched_step,
                              make_rotate_step)
from ..runtime import BfvContext, CkksBtpContext, CkksContext
from ..schemes.bfv import tensor_product
from ..schemes.bootstrap_params import reference_run
from ..schemes.galois import apply_automorphism_coeff, apply_automorphism_ntt, galois_elt_col


def _timer():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed(marks):
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev) for i, (name, ev) in enumerate(marks) if i}


def phases_mult_relin(engine, a, b, keys, level):
    """CUDA-event milliseconds of each stage of one mult + relinearize."""
    ring = engine.ring(level)
    bz = engine.behz(level)
    marks = [('start', _timer())]
    polys = torch.cat([a[..., :2, :, :], b[..., :2, :, :]], dim=-3)
    fq, fa = behz_prep32(polys, bz)
    marks.append(('behz_prep32 (B2)', _timer()))
    dq, da = tensor_product(fq, ring), tensor_product(fa, bz.ring_aux)
    marks.append(('tensor product', _timer()))
    ct3 = behz_finish32(dq, da, bz)
    marks.append(('behz_finish32 (B4)', _timer()))
    e0, e1 = ksw_switch32(ct3[..., 2, :, :], keys['rlk'], engine.switcher, level)
    marks.append(('ksw_switch32 (B3)', _timer()))
    out = torch.stack([_u.addmod(ct3[..., 0, :, :], e0, ring.q),
                       _u.addmod(ct3[..., 1, :, :], e1, ring.q)], dim=-3)
    marks.append(('final add', _timer()))
    return _elapsed(marks), out


def phases_rotate(engine, a, keys, level, elt):
    """CUDA-event milliseconds of each stage of one apply_galois."""
    ring = engine.ring(level)
    marks = [('start', _timer())]
    c0 = apply_automorphism_coeff(a[..., 0, :, :], ring.q, engine.n, elt)
    c1 = apply_automorphism_coeff(a[..., 1, :, :], ring.q, engine.n, elt)
    marks.append(('automorphism', _timer()))
    e0, e1 = ksw_switch32(c1, keys['glk'][elt], engine.switcher, level)
    marks.append(('ksw_switch32 (B3)', _timer()))
    out = torch.stack([_u.addmod(c0, e0, ring.q), e1], dim=-3)
    marks.append(('final add', _timer()))
    return _elapsed(marks), out


def _switch64_marks(engine, x, ksk, level, marks):
    """The 64-bit key switch of ``KeySwitcher.switch`` in its stages,
    appending a CUDA event after each; returns (e0, e1)."""
    sw = engine.switcher
    ring_qp, qhat_inv, qhat_inv_shoup, src_q, qhat_conv, rd = sw._level_pre(level)
    L = level + 1
    alpha, beta = sw.alpha, sw.beta(level)
    pad = beta * alpha - L
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    y = sw.word.shoup_mul(x.reshape(*x.shape[:-2], beta, alpha, sw.n), qhat_inv, qhat_inv_shoup,
                          src_q)
    xd = bconv64_raw(y, qhat_conv, ring_qp.q, ring_qp.pinv)
    marks.append(('ksw: decompose + mod-up (B6 raw)', _timer()))
    digits = ntt64_fwd(xd, ring_qp)
    marks.append(('ksw: forward NTT (B5)', _timer()))
    acc = ksw_inner64(digits, ksk, level, ring_qp)
    marks.append(('ksw: inner product (B7)', _timer()))
    c = ntt64_inv(acc, ring_qp)
    marks.append(('ksw: inverse NTT (B5)', _timer()))
    xq, xp = c[..., :L, :], c[..., L:, :]
    yd = rd.conv.decompose(_u.addmod(xp, rd.half_p, rd.p_q))
    num = _u.submod(_u.addmod(xq, rd.half_q, rd.dst_q), rd.conv.convert(yd), rd.dst_q)
    out = rd.word.mont_mul(num, rd.pinv_mont, rd.dst_q, rd.dst_pinv)
    marks.append(('ksw: RoundDivP conversion + modular arithmetic (B6)', _timer()))
    e = _u.addmod(out, rd.overflow(yd)[..., None, :], rd.dst_q)
    marks.append(('ksw: RoundDivP float64 overflow estimate', _timer()))
    return e[..., 0, :, :], e[..., 1, :, :]


def phases_mult_relin64(engine, a, b, keys, level):
    """CUDA-event milliseconds of each stage of one mult + relinearize on
    the 64-bit word."""
    ring = engine.ring(level)
    bz = engine.behz(level)
    ra = bz.ring_aux
    marks = [('start', _timer())]
    polys = torch.cat([a[..., :2, :, :], b[..., :2, :, :]], dim=-3)
    ext = bz.extend(polys)
    marks.append(('BEHZ extension (B6)', _timer()))
    fq, fa = ntt64_fwd(polys, ring, to_mont=True), ntt64_fwd(ext, ra, to_mont=True)
    marks.append(('forward NTTs (B5)', _timer()))
    dq, da = tensor_product(fq, ring), tensor_product(fa, ra)
    marks.append(('tensor product', _timer()))
    dq, da = ntt64_inv(dq, ring, from_mont=True), ntt64_inv(da, ra, from_mont=True)
    marks.append(('inverse NTTs (B5)', _timer()))
    ct3 = bz.scale_and_back(dq, da)
    marks.append(('scale_and_back (B6)', _timer()))
    e0, e1 = _switch64_marks(engine, ct3[..., 2, :, :], keys['rlk'], level, marks)
    out = torch.stack([_u.addmod(ct3[..., 0, :, :], e0, ring.q),
                       _u.addmod(ct3[..., 1, :, :], e1, ring.q)], dim=-3)
    marks.append(('final add', _timer()))
    return _elapsed(marks), out


def phases_rotate64(engine, a, keys, level, elt):
    """CUDA-event milliseconds of each stage of one apply_galois on the
    64-bit word."""
    ring = engine.ring(level)
    marks = [('start', _timer())]
    c0 = apply_automorphism_coeff(a[..., 0, :, :], ring.q, engine.n, elt)
    c1 = apply_automorphism_coeff(a[..., 1, :, :], ring.q, engine.n, elt)
    marks.append(('automorphism', _timer()))
    e0, e1 = _switch64_marks(engine, c1, keys['glk'][elt], level, marks)
    out = torch.stack([_u.addmod(c0, e0, ring.q), e1], dim=-3)
    marks.append(('final add', _timer()))
    return _elapsed(marks), out


def _ckks_switch_marks(engine, c1_ntt, ksk, level, marks, what):
    """The INTT of an NTT-domain component and its key switch with NTT
    output, in stages; returns (e0, e1) in the NTT domain."""
    ring = engine.ring(level)
    x = ntt_mod.intt(c1_ntt.contiguous(), ring)
    marks.append((f'{what}: INTT ({"B5" if engine.word_bits == 64 else "B1"})', _timer()))
    if engine.word_bits == 32:
        e0, e1 = ksw_switch32(x, ksk, engine.switcher, level, output_ntt=True)
        marks.append((f'{what}: ksw_switch32 with output NTT (B3, B1)', _timer()))
        return e0, e1
    e0, e1 = _switch64_marks(engine, x, ksk, level, marks)
    e = ntt64_fwd(torch.stack([e0, e1], dim=-3), ring)
    marks.append((f'{what}: output NTT (B5)', _timer()))
    return e[..., 0, :, :], e[..., 1, :, :]


def phases_ckks_mult(engine, a, b, keys, level, rescales):
    """CUDA-event milliseconds of each stage of one CKKS mult + relinearize
    and ``rescales`` rescales."""
    ring = engine.ring(level)
    w = ring.word
    marks = [('start', _timer())]
    f = torch.cat([w.to_mont(a[..., :2, :, :], ring.q, ring.pinv, ring.r2), b[..., :2, :, :]],
                  dim=-3)
    ct3 = tensor_product(f, ring)
    marks.append(('tensor product', _timer()))
    e0, e1 = _ckks_switch_marks(engine, ct3[..., 2, :, :], keys['rlk'], level, marks, 'relin')
    out = torch.stack([_u.addmod(ct3[..., 0, :, :], e0, ring.q),
                       _u.addmod(ct3[..., 1, :, :], e1, ring.q)], dim=-3)
    marks.append(('final add', _timer()))
    word = 'B5' if engine.word_bits == 64 else 'B1'
    for k in range(rescales):
        lv = level - k
        coeff = ntt_mod.intt(out, engine.ring(lv))
        marks.append((f'rescale {k + 1}: INTT ({word})', _timer()))
        dropped = engine.rescaler(lv)(coeff)
        marks.append((f'rescale {k + 1}: divide and round', _timer()))
        out = ntt_mod.ntt(dropped, engine.ring(lv - 1))
        marks.append((f'rescale {k + 1}: NTT ({word})', _timer()))
    return _elapsed(marks), out


def phases_ckks_rotate(engine, a, keys, level, elt):
    """CUDA-event milliseconds of each stage of one CKKS apply_galois."""
    ring = engine.ring(level)
    marks = [('start', _timer())]
    c0 = apply_automorphism_ntt(a[..., 0, :, :], engine.n, elt)
    c1 = apply_automorphism_ntt(a[..., 1, :, :], engine.n, elt)
    marks.append(('automorphism (NTT domain)', _timer()))
    e0, e1 = _ckks_switch_marks(engine, c1, keys['glk'][elt], level, marks, 'switch')
    out = torch.stack([_u.addmod(c0, e0, ring.q), e1], dim=-3)
    marks.append(('final add', _timer()))
    return _elapsed(marks), out


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
    if ckks:
        rescales = 1 if u64 else 2
        elt = galois_elt_col(1, params.n)
        if args.op == 'rotate':
            ctx.gen_galois_keys_for_elements([elt])
            keys = key_tree(ctx, galois_elts=[elt])
            inputs = (a, keys)
            step = make_batched_step(ctx.engine, make_rotate_step(elt), args.level, n_inputs=1,
                                     is_ntt=True)

            def staged():
                return phases_ckks_rotate(ctx.engine, a, keys, args.level, elt)
        else:
            keys = key_tree(ctx)
            inputs = (a, b, keys)
            step = make_batched_step(
                ctx.engine, ckks_mult_relin_rescale if u64 else ckks_mult_relin_rescale2,
                args.level, is_ntt=True)

            def staged():
                return phases_ckks_mult(ctx.engine, a, b, keys, args.level, rescales)
    elif args.op == 'rotate':
        elt = galois_elt_col(1, params.n)
        ctx.gen_galois_keys_for_elements([elt])
        keys = key_tree(ctx, galois_elts=[elt])
        inputs = (a, keys)
        step = make_batched_step(ctx.engine, make_rotate_step(elt), args.level, n_inputs=1)

        def staged():
            if u64:
                return phases_rotate64(ctx.engine, a, keys, args.level, elt)
            return phases_rotate(ctx.engine, a, keys, args.level, elt)
    else:
        keys = key_tree(ctx)
        inputs = (a, b, keys)
        step = make_batched_step(ctx.engine, bfv_mult_relin, args.level)

        def staged():
            if u64:
                return phases_mult_relin64(ctx.engine, a, b, keys, args.level)
            return phases_mult_relin(ctx.engine, a, b, keys, args.level)
    want = step(*inputs)
    for _ in range(2):
        ph, out = staged()
    if not torch.equal(out, want):
        raise AssertionError('the stage-by-stage step differs from make_batched_step')
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        step(*inputs)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / args.steps
    print(json.dumps({'phases': {'gpu': gpu, 'scheme': args.scheme, 'chain': args.chain,
                                 'op': args.op,
                                 'n': args.n, 'batch': args.batch,
                                 'level': args.level,
                                 'step_ms': step_ms, 'sum_of_phases_ms': sum(ph.values()),
                                 'ms': ph}}), flush=True)

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        start.record()
        for _ in range(args.steps):
            step(*inputs)
        stop.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(stop) / args.steps
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
