#!/usr/bin/env python3
"""Smoke test of lattisense_torch on one CUDA card (written for an H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Set-up: builds the CUDA kernels from ``lattisense_torch/csrc`` (one nvcc
   per source, all started together) and prints the toolchain, the card and
   each kernel's ptxas report.
2. Kernels: calls each kernel wrapper (``ntt32_fwd``, ``ntt32_inv``,
   ``behz_prep32``, ``ksw_switch32``, ``behz_finish32``) on the card at the
   shapes the main path gives it, holds the result bit for bit against the
   plain PyTorch twin run on a CPU copy, and times kernel and twin on the
   card with CUDA events.
3. Main path: the batched BFV mult_relin at the headline configuration
   (``BfvParams.create_tpu_param(16384)``, level 7, batch 32): every output
   must decrypt to a·b mod t slot-wise, element 0 must equal the port's plain
   path on the CPU bit for bit, and each kernel's launch count, reset just
   before the run, must have risen.
4. Rotate path: the batched BFV rotate_col by 1 on the same context, level
   and batch (``make_rotate_step``): every output must decrypt to each half
   of the slot vector rolled by -1, element 0 must equal the port's CPU path
   bit for bit, and the key switch's count, reset just before the run, must
   have risen.

Prints a ``{"kernels": [...]}`` line, a ``{"main_path": {...}}`` line, a
``{"rotate_path": {...}}`` line, the card's name and power limit as
nvidia-smi reports them, and as its last line ``{"ok": true, "device":
{...}}``. Any failure raises and exits non-zero; without a CUDA card, or
without the package beside it, it exits 2 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N = 16384
LEVEL = 7
BATCH = 32
WARMUP = 3
ITERS = 20
MAIN_ITERS = 10
SEED = 7

# Published H100 SXM peaks (NVIDIA data sheet) for the bound: HBM bytes/s,
# and the float32 rate outside the tensor cores, the table's only 32-bit
# CUDA-core rate — an upper limit on the card's 32-bit integer rate, so the
# operations bound below is a lower bound.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# 32-bit integer operations per step, counted from csrc/: a Shoup product is
# 6 (umulhi, two mul, sub, compare, select), a modular add or sub 3, a
# Montgomery product 8 (wide mul as two, mul, umulhi, two adds, compare,
# select).
OPS_SHOUP, OPS_ADDSUB, OPS_MONT = 6, 3, 8
OPS_BUTTERFLY = OPS_SHOUP + 2 * OPS_ADDSUB


def fail(msg: str) -> int:
    print(f'chip_smoke: {msg}', file=sys.stderr)
    return 2


def nvidia_smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def ntt_work(rows: int, limbs: int, n: int) -> tuple[float, float]:
    """Bytes and operations of one B1 call: int64 rows in and out, the
    limbs' twiddle tables (value + companion, uint32) read once; log2(n)
    stages of n/2 butterflies plus the per-element epilogue."""
    logn = n.bit_length() - 1
    nbytes = 16.0 * rows * n + 8.0 * limbs * n
    ops = rows * (n // 2 * logn * OPS_BUTTERFLY + n * OPS_SHOUP)
    return nbytes, float(ops)


def behz_work(polys: int, L: int, T: int, n: int) -> tuple[float, float]:
    """Bytes and operations of one B2 call: x read once, fq and fa written
    once, both rings' tables read once; per coefficient 2L Shoup products
    and the m~ channel (3L), then per aux row L Shoup-accumulates and the
    SmMRq tail; then the forward NTT with epilogue over L+T rows."""
    nbytes = 8.0 * polys * (2 * L + T) * n + 8.0 * (L + T) * n
    per_coef = L * (2 * OPS_SHOUP + 3) + T * (L * (OPS_SHOUP + OPS_ADDSUB)
                                              + 3 * OPS_SHOUP + OPS_ADDSUB + 3)
    ops = polys * n * per_coef + ntt_work(polys * (L + T), L + T, n)[1]
    return nbytes, float(ops)


def ksw_work(G: int, L: int, alpha: int, beta: int, n: int,
             output_ntt: bool = False) -> tuple[float, float]:
    """Bytes and operations of one B3 call on G polynomials: x read once,
    the key's β digits over T = L+α rows read once, e0 and e1 written once,
    the Q_ℓ∪P twiddle tables of both directions read once; per coefficient
    the decomposition and mod-up, the β·T-row forward NTT, the inner
    product, the 2T-row inverse NTT and the mod-down."""
    T = L + alpha
    nbytes = 8.0 * G * L * n + 8.0 * beta * 2 * T * n + 16.0 * G * L * n + 16.0 * T * n
    per_coef = (L * OPS_SHOUP + beta * T * alpha * (OPS_SHOUP + OPS_ADDSUB)
                + 2 * T * beta * (OPS_MONT + OPS_ADDSUB)
                + 2 * (alpha * (OPS_ADDSUB + OPS_SHOUP + 3)
                       + L * (alpha * (OPS_SHOUP + OPS_ADDSUB) + 3 * OPS_ADDSUB + OPS_SHOUP)))
    ops = (G * n * per_coef + ntt_work(G * beta * T, T, n)[1]
           + ntt_work(G * 2 * T, T, n)[1])
    if output_ntt:
        nbytes += 8.0 * L * n
        ops += ntt_work(G * 2 * L, L, n)[1]
    return nbytes, float(ops)


def finish_work(polys: int, L: int, T: int, n: int) -> tuple[float, float]:
    """Bytes and operations of one B4 call: dq and da read once, the output
    written once, both rings' inverse twiddle tables read once; the inverse
    NTT with its epilogue over L+T rows, then per coefficient [tX]_Q, the
    conversion to the aux basis, the Q^-1 scale and Shenoy–Kumaresan back
    to Q."""
    Tb = T - 1
    nbytes = 8.0 * polys * (2 * L + T) * n + 8.0 * (L + T) * n
    per_coef = (2 * L * OPS_SHOUP + T * (L * (OPS_SHOUP + OPS_ADDSUB) + 2 * OPS_SHOUP
                                         + OPS_ADDSUB)
                + Tb * OPS_SHOUP + Tb * (OPS_SHOUP + OPS_ADDSUB) + OPS_ADDSUB + OPS_SHOUP
                + L * (Tb * (OPS_SHOUP + OPS_ADDSUB) + 3 + OPS_SHOUP + OPS_ADDSUB))
    ops = polys * n * per_coef + ntt_work(polys * (L + T), L + T, n)[1]
    return nbytes, float(ops)


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail('torch.cuda.is_available() is false; this script needs a CUDA card')
    sys.path.insert(0, HERE)
    try:
        import lattisense_torch
    except ImportError as exc:
        return fail(f'lattisense_torch not found beside this script ({exc})')
    if os.path.dirname(os.path.dirname(os.path.abspath(lattisense_torch.__file__))) != HERE:
        return fail('lattisense_torch was imported from outside this checkout')

    from lattisense_torch.core.modring import get_rns_ring
    from lattisense_torch.ops import behz_cuda, cuda_build, ksw_cuda, ntt_cuda
    from lattisense_torch.params import BfvParams
    from lattisense_torch.parallel.batch import (bfv_mult_relin, key_tree, make_batched_step,
                                                 make_rotate_step)
    from lattisense_torch.runtime import BfvContext
    from lattisense_torch.schemes.bfv import BfvEngine
    from lattisense_torch.schemes.galois import galois_elt_col
    from lattisense_torch.schemes.types import Ciphertext, KeySwitchKey

    counts = (ntt_cuda.launches, behz_cuda.launches, ksw_cuda.launches)

    def reset_counts():
        for c in counts:
            for k in c:
                c[k] = 0

    def read_counts():
        return {k: v for c in counts for k, v in c.items()}

    # ---- 1. set-up --------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    gpu = nvidia_smi()
    dev = torch.device('cuda', torch.cuda.current_device())
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if 'registers' in ln or 'spill' in ln or 'Compiling' in ln]
             for name, log in reports.items()}
    print(json.dumps({'setup': {'torch': torch.__version__, 'cuda': torch.version.cuda,
                                'nvcc': cuda_build.nvcc_path(), 'gpu': gpu,
                                'build_s': round(build_s, 3), 'ptxas': ptxas}}), flush=True)

    params = BfvParams.create_tpu_param(N)
    t1 = time.perf_counter()
    ctx = BfvContext.create_random_context(params, seed=SEED, device=dev)
    keygen_s = time.perf_counter() - t1
    eng_g, eng_c = ctx.engine, BfvEngine(params, 'cpu')
    bz_g, bz_c = eng_g.behz(LEVEL), eng_c.behz(LEVEL)
    sw_g, sw_c = eng_g.switcher, eng_c.switcher
    L, T = LEVEL + 1, len(bz_g.ring_aux.moduli)
    alpha, beta = sw_g.alpha, sw_g.beta(LEVEL)
    qp = tuple(params.q[:L]) + tuple(params.p)
    rings = {  # name -> (gpu ring, cpu ring)
        'q': (bz_g.ring_q, bz_c.ring_q),
        'aux': (bz_g.ring_aux, bz_c.ring_aux),
        'qp': (get_rns_ring(qp, N, dev), get_rns_ring(qp, N, 'cpu')),
    }
    rng = np.random.default_rng(SEED)

    def residues(moduli, lead):
        cols = [rng.integers(0, q, (*lead, N), dtype=np.int64) for q in moduli]
        return torch.from_numpy(np.stack(cols, axis=-2))

    def cpu_key(k):
        return KeySwitchKey(key_q=k.key_q.cpu(), key_p=k.key_p.cpu())

    def max_err(pairs):
        return max(int((g.cpu() - w).abs().max()) for g, w in pairs)

    # ---- 2. kernels against their plain twins -----------------------------
    # B1 at the row stacks one batched mult_relin gives it: forward inside B2
    # (4 polynomials over q and aux) and B3 (β digits over q∪p); inverse
    # inside B4 (3 products over q and aux) and B3 (2 components over q∪p)
    fwd_calls = [('q', (BATCH, 4)), ('aux', (BATCH, 4)), ('qp', (BATCH, beta))]
    inv_calls = [('q', (BATCH, 3)), ('aux', (BATCH, 3)), ('qp', (BATCH, 2))]

    def check_ntt(name, calls, kernel, plain):
        inputs, pairs = [], []
        for ring_name, lead in calls:
            rg, rc = rings[ring_name]
            x = residues(rc.moduli, lead)
            got = kernel(x.to(dev), rg)
            torch.cuda.synchronize()
            want = plain(x, rc)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f'{name} differs from its plain twin on {ring_name} {lead}')
            pairs.append((got, want))
            inputs.append((x.to(dev), rg))
        ms = time_ms(torch, lambda: [kernel(x, r) for x, r in inputs], ITERS)
        plain_ms = time_ms(torch, lambda: [plain(x, r) for x, r in inputs], ITERS)
        work = [ntt_work(x.numel() // N, len(r.moduli), N) for x, r in inputs]
        bound_ms, bound_by = bound(sum(w[0] for w in work), sum(w[1] for w in work))
        return {'shapes': [[list(x.shape), len(r.moduli)] for x, r in inputs],
                'equal': True, 'max_abs_err': max_err(pairs), 'ms': ms, 'plain_ms': plain_ms,
                'bound_ms': bound_ms, 'bound_by': bound_by}

    kernels = {
        'ntt32_fwd': dict(route='cuda', source='lattisense_torch/csrc/ntt32.cu',
                          replaces='lattisense_tpu/ops/ntt_pallas32.py:101',
                          replaces_function='ntt_fused32 (_fwd_kernel)',
                          **check_ntt('ntt32_fwd', fwd_calls, ntt_cuda.ntt32_fwd,
                                      ntt_cuda.ntt_plain)),
        'ntt32_inv': dict(route='cuda', source='lattisense_torch/csrc/ntt32.cu',
                          replaces='lattisense_tpu/ops/ntt_pallas32.py:173',
                          replaces_function='intt_fused32 (_inv_kernel)',
                          **check_ntt('ntt32_inv', inv_calls, ntt_cuda.ntt32_inv,
                                      ntt_cuda.intt_plain)),
    }

    # B2 on the 4 input polynomials of each operation
    x = residues(rings['q'][1].moduli, (BATCH, 4))
    xg = x.to(dev)
    fq, fa = behz_cuda.behz_prep32(xg, bz_g)
    torch.cuda.synchronize()
    want_fq, want_fa = behz_cuda.behz_prep_plain(x, bz_c)
    if not (torch.equal(fq.cpu(), want_fq) and torch.equal(fa.cpu(), want_fa)):
        raise AssertionError('behz_prep32 differs from its plain twin')
    bound_ms, bound_by = bound(*behz_work(BATCH * 4, L, T, N))
    kernels['behz_prep32'] = dict(
        route='cuda', source='lattisense_torch/csrc/behz32.cu',
        replaces='lattisense_tpu/ops/behz_pallas32.py:55',
        replaces_function='behz_prep32 (_k1_kernel)',
        shapes=[[list(x.shape), L, T]], equal=True,
        max_abs_err=max_err([(fq, want_fq), (fa, want_fa)]),
        ms=time_ms(torch, lambda: behz_cuda.behz_prep32(xg, bz_g), ITERS),
        plain_ms=time_ms(torch, lambda: behz_cuda.behz_prep_plain(xg, bz_g), ITERS),
        bound_ms=bound_ms, bound_by=bound_by)
    del x, xg, fq, fa, want_fq, want_fa

    # B3 with the relinearization key on the (B, L, n) third component; the
    # output-NTT variant and a level with a ragged last digit are checked
    rlk_c = cpu_key(ctx.rlk)
    x = residues(params.q[:L], (BATCH,))
    xg = x.to(dev)
    e = ksw_cuda.ksw_switch32(xg, ctx.rlk, sw_g, LEVEL)
    e_ntt = ksw_cuda.ksw_switch32(xg, ctx.rlk, sw_g, LEVEL, output_ntt=True)
    torch.cuda.synchronize()
    want = sw_c.switch_plain(x, rlk_c, LEVEL)
    want_ntt = tuple(ntt_cuda.ntt_plain(w, rings['q'][1]) for w in want)
    pairs = list(zip(e, want)) + list(zip(e_ntt, want_ntt))
    low = 5                                        # L = 6: the second digit is ragged
    x_low = residues(params.q[:low + 1], (4,))
    e_low = ksw_cuda.ksw_switch32(x_low.to(dev), ctx.rlk, sw_g, low)
    torch.cuda.synchronize()
    pairs += list(zip(e_low, sw_c.switch_plain(x_low, rlk_c, low)))
    if not all(torch.equal(g.cpu(), w) for g, w in pairs):
        raise AssertionError('ksw_switch32 differs from its plain twin')
    bound_ms, bound_by = bound(*ksw_work(BATCH, L, alpha, beta, N))
    kernels['ksw_switch32'] = dict(
        route='cuda', source='lattisense_torch/csrc/ksw32.cu',
        replaces='lattisense_tpu/ops/ksw_pallas32.py:207',
        replaces_function='ksw_switch32 (_ksw_kernel)',
        shapes=[{'x': list(x.shape), 'level': LEVEL, 'alpha': alpha, 'beta': beta,
                 'T': L + alpha, 'output_ntt': [False, True]},
                {'x': list(x_low.shape), 'level': low, 'beta': sw_g.beta(low)}],
        equal=True, max_abs_err=max_err(pairs),
        ms=time_ms(torch, lambda: ksw_cuda.ksw_switch32(xg, ctx.rlk, sw_g, LEVEL), ITERS),
        plain_ms=time_ms(torch, lambda: sw_g.switch_plain(xg, ctx.rlk, LEVEL), ITERS),
        bound_ms=bound_ms, bound_by=bound_by)
    del x, xg, e, e_ntt, want, want_ntt, pairs, x_low, e_low

    # B4 on the (B, 3, L, n) and (B, 3, T, n) tensor products
    dq, da = residues(rings['q'][1].moduli, (BATCH, 3)), residues(rings['aux'][1].moduli,
                                                                  (BATCH, 3))
    dqg, dag = dq.to(dev), da.to(dev)
    got = behz_cuda.behz_finish32(dqg, dag, bz_g)
    torch.cuda.synchronize()
    want = behz_cuda.behz_finish_plain(dq, da, bz_c)
    if not torch.equal(got.cpu(), want):
        raise AssertionError('behz_finish32 differs from its plain twin')
    bound_ms, bound_by = bound(*finish_work(BATCH * 3, L, T, N))
    kernels['behz_finish32'] = dict(
        route='cuda', source='lattisense_torch/csrc/behz32.cu',
        replaces='lattisense_tpu/ops/behz_pallas32.py:368',
        replaces_function='behz_finish32 (_k3_kernel)',
        shapes=[[list(dq.shape), list(da.shape)]], equal=True,
        max_abs_err=max_err([(got, want)]),
        ms=time_ms(torch, lambda: behz_cuda.behz_finish32(dqg, dag, bz_g), ITERS),
        plain_ms=time_ms(torch, lambda: behz_cuda.behz_finish_plain(dqg, dag, bz_g), ITERS),
        bound_ms=bound_ms, bound_by=bound_by)
    del dq, da, dqg, dag, got, want
    torch.cuda.empty_cache()

    # ---- 3. the main path -------------------------------------------------
    msgs = rng.integers(0, params.t, (2 * BATCH, N))
    t1 = time.perf_counter()
    cts = [ctx.encrypt(ctx.encode(m, LEVEL)) for m in msgs]
    encrypt_s = time.perf_counter() - t1
    a = torch.stack([c.data for c in cts[:BATCH]])
    b = torch.stack([c.data for c in cts[BATCH:]])
    keys = key_tree(ctx)
    step = make_batched_step(ctx.engine, bfv_mult_relin, LEVEL)
    step(a, b, keys)                                    # warm-up: tables, caches
    torch.cuda.synchronize()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = step(a, b, keys)
    torch.cuda.synchronize()
    launches = read_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f'the main path launched no {missing}')

    step_ms = time_ms(torch, lambda: step(a, b, keys), MAIN_ITERS)
    if out.shape != (BATCH, 2, L, N):
        raise AssertionError(f'main path output shape {tuple(out.shape)}')
    want = (msgs[:BATCH] * msgs[BATCH:]) % params.t
    correct = all(np.array_equal(ctx.decrypt_decode(Ciphertext(data=out[i], level=LEVEL)),
                                 want[i]) for i in range(BATCH))
    out_cpu = make_batched_step(eng_c, bfv_mult_relin, LEVEL)(a[:1].cpu(), b[:1].cpu(),
                                                              {'rlk': rlk_c})
    bit_exact = torch.equal(out_cpu[0], out[0].cpu())

    for name, entry in kernels.items():
        entry['launches'] = launches[name]
        entry['library_ms'] = None
    print(json.dumps({'kernels': [{'name': k, **v} for k, v in kernels.items()]}), flush=True)
    name, power = (s.strip() for s in gpu.split(',', 1))
    print(json.dumps({'main_path': {
        'n': N, 'level': LEVEL, 'batch': BATCH, 'limbs': L, 'aux_limbs': T,
        'correct': correct, 'bit_exact_vs_plain': bit_exact,
        'ms_per_step': step_ms, 'ops_per_s': BATCH * 1e3 / step_ms,
        'launches_per_step': launches, 'peak_mem_bytes': peak_mem,
        'keygen_s': keygen_s, 'encrypt_64_s': encrypt_s,
        'gpu': name, 'power_limit': power}}), flush=True)
    if not (correct and bit_exact):
        raise AssertionError(f'main path correct={correct} bit_exact_vs_plain={bit_exact}')
    del out, b

    # ---- 4. the rotate path -----------------------------------------------
    elt = galois_elt_col(1, N)
    t1 = time.perf_counter()
    ctx.gen_galois_keys_for_elements([elt])
    galois_keygen_s = time.perf_counter() - t1
    rkeys = key_tree(ctx, galois_elts=[elt])
    rot = make_batched_step(ctx.engine, make_rotate_step(elt), LEVEL, n_inputs=1)
    rot(a, rkeys)                                       # warm-up
    torch.cuda.synchronize()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rout = rot(a, rkeys)
    torch.cuda.synchronize()
    rlaunches = read_counts()
    rpeak = torch.cuda.max_memory_allocated()
    if rlaunches['ksw_switch32'] == 0:
        raise AssertionError('the rotate path launched no ksw_switch32')

    rot_ms = time_ms(torch, lambda: rot(a, rkeys), MAIN_ITERS)
    if rout.shape != (BATCH, 2, L, N):
        raise AssertionError(f'rotate path output shape {tuple(rout.shape)}')
    half = N // 2
    rcorrect = all(np.array_equal(
        ctx.decrypt_decode(Ciphertext(data=rout[i], level=LEVEL)),
        np.concatenate([np.roll(msgs[i][:half], -1), np.roll(msgs[i][half:], -1)]))
        for i in range(BATCH))
    rout_cpu = make_batched_step(eng_c, make_rotate_step(elt), LEVEL, n_inputs=1)(
        a[:1].cpu(), {'glk': {elt: cpu_key(rkeys['glk'][elt])}})
    rbit_exact = torch.equal(rout_cpu[0], rout[0].cpu())
    print(json.dumps({'rotate_path': {
        'op': 'rotate_col', 'step': 1, 'galois_elt': elt, 'n': N, 'level': LEVEL,
        'batch': BATCH, 'correct': rcorrect, 'bit_exact_vs_plain': rbit_exact,
        'ms_per_step': rot_ms, 'ops_per_s': BATCH * 1e3 / rot_ms,
        'launches_per_step': rlaunches, 'peak_mem_bytes': rpeak,
        'galois_keygen_s': galois_keygen_s, 'gpu': name, 'power_limit': power}}), flush=True)
    if not (rcorrect and rbit_exact):
        raise AssertionError(f'rotate path correct={rcorrect} bit_exact_vs_plain={rbit_exact}')

    print(gpu, flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
