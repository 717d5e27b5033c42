"""Time kernels B1 and B5 (the NTTs) of one checkout on one CUDA card.

    python lattisense_torch/tools/ntt_bench.py [--root DIR] [--iters 20] [--batch 32]

Imports ``lattisense_torch`` from the checkout at ``--root`` (by default the
one holding this script), so one call can time two checkouts of the
repository on the same card, in turns (A, B, B, A). Times ``ntt32_fwd``,
``ntt32_inv``, ``ntt64_fwd`` and ``ntt64_inv`` with CUDA events over
``--iters`` rounds at the row stacks one batched step of ``chip_smoke.py``
gives them: at the w32 main path (``create_tpu_param(16384)``, level 7) the
forward on the 4 polynomials over q and over the aux basis and on the β
digits over q∪p, the inverse on the 3 products over q and aux and the 2 key
components over q∪p; the same at the u64 path (``create(16384)``, level 3)
and at the u64 n=32768 path (``create(32768)``, level 11: B5 above its row
kernel's cap, ``ntt64_32k_*``), with each CUDA kernel's device time there
from ``torch.profiler`` (``ntt64_32k_*_kernels_ms``). Every call of a word
and direction is timed together, as ``chip_smoke.py``'s ``kernels`` line
does, and each output is held against the plain twin on the card. Then B5's
row kernel at n = 2^13 and 2^14 on stacks of the same residues (the n=32768
forward's 5 248 rows as 20 992 or 10 496 rows), with the time a butterfly
(``b5_rows``): the rate of the row body at either sub-row size. Then B1
above 2^14 (``ntt32_wide``): the w32 n=32768 path's (B, 22, n) stack
(``create_tpu_param(32768)``, level 21), a (37, 12, n) stack at n = 2^16 and
the w32 bootstrap's key-switch stacks at n = 2^16 (``create_tpu_btp_param()``
top level: the forward on (2, 12, 52, n), the inverse on (2, 2, 52, n)),
each through the wrapper (whatever route the checkout takes there), with
each CUDA kernel's device time. Prints one JSON line
``{"ntt_bench": {...}}`` with the times in ms, the equality flags, the root
and the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N = 16384
N32K = 32768


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--batch', type=int, default=32)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print('ntt_bench: needs a CUDA card', file=sys.stderr)
        return 2
    import lattisense_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(lattisense_torch.__file__))) != root:
        print(f'ntt_bench: lattisense_torch was not imported from {root}', file=sys.stderr)
        return 2
    from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
    from lattisense_torch.ops import ntt64_cuda, ntt_cuda
    from lattisense_torch.params import BfvParams
    from lattisense_torch.schemes.bfv import BfvEngine

    dev = torch.device('cuda', torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(7)
    B = args.batch

    def stack(ring, lead):
        x = torch.randint(0, 1 << 62, (*lead, len(ring.moduli), ring.n), generator=gen,
                          device=dev)
        return x % ring.q

    def kernel_ms(fn, calls):
        """Device ms per round of each CUDA kernel the calls launch."""
        fn_all = lambda: [fn(x, r) for x, r in calls]
        fn_all()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.iters):
                fn_all()
            torch.cuda.synchronize()
        ms = {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                key = ev.key.split('(')[0].replace('void ', '')[:80]
                ms[key] = ms.get(key, 0.0) + ev.device_time_total / 1e3 / args.iters
        return ms

    def timed(fn, calls):
        for _ in range(3):
            [fn(x, r) for x, r in calls]
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            [fn(x, r) for x, r in calls]
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.iters

    out = {}
    words = (('ntt32', BfvParams.create_tpu_param(N), 7, ntt_cuda.ntt32_fwd, ntt_cuda.ntt32_inv,
              ntt_cuda.ntt_plain, ntt_cuda.intt_plain),
             ('ntt64', BfvParams.create(N), 3, ntt64_cuda.ntt64_fwd, ntt64_cuda.ntt64_inv,
              ntt64_cuda.ntt64_plain, ntt64_cuda.intt64_plain))
    for word, params, level, fwd, inv, fwd_plain, inv_plain in words:
        eng = BfvEngine(params, dev)
        bz, sw = eng.behz(level), eng.switcher
        if word == 'ntt32':
            qp = get_rns_ring(tuple(params.q[:level + 1]) + tuple(params.p), N, dev)
        else:
            qp = sw.ring_qp(level)
        fcalls = [(stack(r, lead), r) for r, lead in ((bz.ring_q, (B, 4)), (bz.ring_aux, (B, 4)),
                                                      (qp, (B, sw.beta(level))))]
        icalls = [(stack(r, lead), r) for r, lead in ((bz.ring_q, (B, 3)), (bz.ring_aux, (B, 3)),
                                                      (qp, (B, 2)))]
        out[f'{word}_equal'] = (all(torch.equal(fwd(x, r), fwd_plain(x, r)) for x, r in fcalls)
                                and all(torch.equal(inv(x, r), inv_plain(x, r))
                                        for x, r in icalls))
        out[f'{word}_fwd_ms'] = timed(fwd, fcalls)
        out[f'{word}_inv_ms'] = timed(inv, icalls)
        out[f'{word}_rows'] = [sum(x.numel() // N for x, _ in c) for c in (fcalls, icalls)]
        del fcalls, icalls

    # B5 at the u64 n=32768 path's stacks
    eng = BfvEngine(BfvParams.create(N32K), dev)
    bz, sw = eng.behz(11), eng.switcher
    qp = sw.ring_qp(11)
    fcalls = [(stack(r, lead), r) for r, lead in ((bz.ring_q, (B, 4)), (bz.ring_aux, (B, 4)),
                                                  (qp, (B, sw.beta(11))))]
    icalls = [(stack(r, lead), r) for r, lead in ((bz.ring_q, (B, 3)), (bz.ring_aux, (B, 3)),
                                                  (qp, (B, 2)))]
    f64, i64 = ntt64_cuda.ntt64_fwd, ntt64_cuda.ntt64_inv
    out['ntt64_32k_equal'] = (
        all(torch.equal(f64(x, r), ntt64_cuda.ntt64_plain(x, r)) for x, r in fcalls)
        and all(torch.equal(i64(x, r), ntt64_cuda.intt64_plain(x, r)) for x, r in icalls))
    out['ntt64_32k_fwd_ms'] = timed(f64, fcalls)
    out['ntt64_32k_inv_ms'] = timed(i64, icalls)
    out['ntt64_32k_fwd_kernels_ms'] = kernel_ms(f64, fcalls)
    out['ntt64_32k_inv_kernels_ms'] = kernel_ms(i64, icalls)
    rows32k = sum(x.numel() // N32K for x, _ in fcalls)
    out['ntt64_32k_rows'] = [rows32k, sum(x.numel() // N32K for x, _ in icalls)]
    del fcalls, icalls

    # B5's row kernel at 2^13 and 2^14 on the same residues
    out['b5_rows'] = {}
    for logn in (13, 14):
        n = 1 << logn
        chain = tuple(p for bits in (60, 59) for p in gen_ntt_primes(n, bits, 6))
        ring = get_rns_ring(chain, n, dev, 64)
        x = stack(ring, ((rows32k * N32K // n) // len(chain),))
        rows = x.numel() // n
        butterflies = rows * n // 2 * logn
        entry = {'rows': rows, 'equal': (torch.equal(f64(x, ring), ntt64_cuda.ntt64_plain(x, ring))
                                         and torch.equal(i64(x, ring),
                                                         ntt64_cuda.intt64_plain(x, ring)))}
        for d, fn in (('fwd', f64), ('inv', i64)):
            entry[f'{d}_ms'] = timed(fn, [(x, ring)])
            entry[f'{d}_ps_per_butterfly'] = entry[f'{d}_ms'] * 1e9 / butterflies
        out['b5_rows'][f'n{n}'] = entry
        del x
    # B1 above 2^14
    from lattisense_torch.params import CkksParams
    p32 = BfvParams.create_tpu_param(N32K)
    btp = CkksParams.create_tpu_btp_param(1 << 16)
    rqp = get_rns_ring(tuple(btp.q) + tuple(btp.p), 1 << 16, dev)
    beta = -(-len(btp.q) // len(btp.p))
    out['ntt32_wide'] = {}
    both = ('fwd', 'inv')
    for tag, ring, lead, dirs in (
            ('n32768_q22', get_rns_ring(tuple(p32.q), N32K, dev), (B,), both),
            ('n65536_37x12', get_rns_ring(gen_ntt_primes(1 << 16, 31, 12), 1 << 16, dev), (37,),
             both),
            ('n65536_btp_fwd', rqp, (2, beta), ('fwd',)), ('n65536_btp_inv', rqp, (2, 2), ('inv',))):
        x = stack(ring, lead)
        entry = {'shape': list(x.shape)}
        for d in dirs:
            fn, plain = ((ntt_cuda.ntt32_fwd, ntt_cuda.ntt_plain) if d == 'fwd'
                         else (ntt_cuda.ntt32_inv, ntt_cuda.intt_plain))
            entry[f'{d}_equal'] = torch.equal(fn(x, ring), plain(x, ring))
            entry[f'{d}_ms'] = timed(fn, [(x, ring)])
            entry[f'{d}_kernels_ms'] = kernel_ms(fn, [(x, ring)])
        out['ntt32_wide'][tag] = entry
        del x
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({'ntt_bench': {'root': os.path.relpath(root), 'device': str(dev),
                                    'gpu': gpu, 'batch': B, 'iters': args.iters, **out}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
