#!/usr/bin/env python3
"""Smoke test of lattisense_torch on one CUDA card (written for an H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Set-up: builds the CUDA kernels from ``lattisense_torch/csrc`` (one nvcc
   per source, all started together) and prints the toolchain and the card.
2. Kernels: calls each kernel wrapper (``ntt32_fwd``, ``ntt32_inv``,
   ``behz_prep32``) on the card at the shapes the main path gives it, holds
   the result bit for bit against the plain PyTorch twin run on a CPU copy,
   and times kernel and twin on the card with CUDA events.
3. Main path: the batched BFV mult_relin at the headline configuration
   (``BfvParams.create_tpu_param(16384)``, level 7, batch 32): every output
   must decrypt to a·b mod t slot-wise, element 0 must equal the port's plain
   path on the CPU bit for bit, and each kernel's launch count, reset just
   before the run, must have risen.

Prints a ``{"kernels": [...]}`` line, a ``{"main_path": {...}}`` line, the
card's name and power limit as nvidia-smi reports them, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA card, or without the package beside it, it exits 2 and prints
no result.
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
# 6 (umulhi, two mul, sub, compare, select), a modular add or sub 3.
OPS_SHOUP, OPS_ADDSUB = 6, 3
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
    from lattisense_torch.ops import behz_cuda, cuda_build, ntt_cuda
    from lattisense_torch.params import BfvParams
    from lattisense_torch.parallel.batch import bfv_mult_relin, key_tree, make_batched_step
    from lattisense_torch.runtime import BfvContext
    from lattisense_torch.schemes.bfv import BfvEngine
    from lattisense_torch.schemes.types import Ciphertext, KeySwitchKey

    # ---- 1. set-up --------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    gpu = nvidia_smi()
    dev = torch.device('cuda', torch.cuda.current_device())
    ptxas = {name: [ln.strip() for ln in log.splitlines() if 'registers' in ln or 'spill' in ln]
             for name, log in reports.items()}
    print(json.dumps({'setup': {'torch': torch.__version__, 'cuda': torch.version.cuda,
                                'nvcc': cuda_build.nvcc_path(), 'gpu': gpu,
                                'build_s': round(build_s, 3), 'ptxas': ptxas}}), flush=True)

    params = BfvParams.create_tpu_param(N)
    eng_g, eng_c = BfvEngine(params, dev), BfvEngine(params, 'cpu')
    bz_g, bz_c = eng_g.behz(LEVEL), eng_c.behz(LEVEL)
    L, T = LEVEL + 1, len(bz_g.ring_aux.moduli)
    qp = tuple(params.q[:L]) + tuple(params.p)
    rings = {  # name -> (gpu ring, cpu ring)
        'q': (bz_g.ring_q, bz_c.ring_q),
        'aux': (bz_g.ring_aux, bz_c.ring_aux),
        'qp': (get_rns_ring(qp, N, dev), get_rns_ring(qp, N, 'cpu')),
    }
    rng = np.random.default_rng(SEED)

    def residues(ring, lead):
        cols = [rng.integers(0, q, (*lead, N), dtype=np.int64) for q in ring.moduli]
        return torch.from_numpy(np.stack(cols, axis=-2))

    # ---- 2. kernels against their plain twins -----------------------------
    # the calls one batched mult_relin makes: B2 on the 4 input polynomials,
    # the key switch's forward NTT of its (B, β, |Q∪P|) digits, and three
    # inverse NTTs (the tensor product over q and aux, the switch over q∪p)
    beta = eng_g.switcher.beta(LEVEL)
    fwd_calls = [('qp', (BATCH, beta))]
    inv_calls = [('q', (BATCH, 3)), ('aux', (BATCH, 3)), ('qp', (BATCH, 2))]

    def check_ntt(name, calls, kernel, plain):
        inputs, err = [], 0
        for ring_name, lead in calls:
            rg, rc = rings[ring_name]
            x = residues(rc, lead)
            got = kernel(x.to(dev), rg)
            torch.cuda.synchronize()
            want = plain(x, rc)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f'{name} differs from its plain twin on {ring_name} {lead}')
            err = max(err, int((got.cpu() - want).abs().max()))
            inputs.append((x.to(dev), rg))
        ms = time_ms(torch, lambda: [kernel(x, r) for x, r in inputs], ITERS)
        plain_ms = time_ms(torch, lambda: [plain(x, r) for x, r in inputs], ITERS)
        work = [ntt_work(x.numel() // N, len(r.moduli), N) for x, r in inputs]
        bound_ms, bound_by = bound(sum(w[0] for w in work), sum(w[1] for w in work))
        return {'shapes': [[list(x.shape), len(r.moduli)] for x, r in inputs],
                'equal': True, 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
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
    x = residues(rings['q'][1], (BATCH, 4))
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
        max_abs_err=max(int((fq.cpu() - want_fq).abs().max()),
                        int((fa.cpu() - want_fa).abs().max())),
        ms=time_ms(torch, lambda: behz_cuda.behz_prep32(xg, bz_g), ITERS),
        plain_ms=time_ms(torch, lambda: behz_cuda.behz_prep_plain(xg, bz_g), ITERS),
        bound_ms=bound_ms, bound_by=bound_by)
    del x, xg, fq, fa, want_fq, want_fa

    # ---- 3. the main path -------------------------------------------------
    t1 = time.perf_counter()
    ctx = BfvContext.create_random_context(params, seed=SEED)
    keygen_s = time.perf_counter() - t1
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

    for counts in (ntt_cuda.launches, behz_cuda.launches):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    out = step(a, b, keys)
    torch.cuda.synchronize()
    launches = {**ntt_cuda.launches, **behz_cuda.launches}
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
    cpu_keys = {'rlk': KeySwitchKey(key_q=keys['rlk'].key_q.cpu(),
                                    key_p=keys['rlk'].key_p.cpu())}
    out_cpu = make_batched_step(eng_c, bfv_mult_relin, LEVEL)(a[:1].cpu(), b[:1].cpu(), cpu_keys)
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
    print(gpu, flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
