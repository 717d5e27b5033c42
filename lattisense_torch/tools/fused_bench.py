"""Time kernels B2, B3, B4 and B6 of one checkout on one CUDA card, whole and by stage.

    python lattisense_torch/tools/fused_bench.py [--root DIR] [--iters 20] [--batch 32]

Imports ``lattisense_torch`` from the checkout at ``--root`` (by default the
one holding this script), so one call can time two checkouts on the same
card, in turns (A, B, B, A), as ``ntt_bench.py`` does for B1 and B5. At the
w32 main path's shapes (``create_tpu_param(16384)``, level 7, batch B) it
times:

- the wrappers ``behz_prep32`` (4 polynomials a ciphertext pair),
  ``ksw_switch32`` (the (B, L, n) third component, a random key) and
  ``behz_finish32`` (3 tensor products), each held against its plain twin
  on the card, with CUDA events over ``--iters`` rounds;
- the device time of each CUDA kernel one wrapper call launches, from
  ``torch.profiler`` over ``--iters`` calls (``*_kernels_ms``: kernel
  name → ms per call), which splits each wrapper into its stages whatever
  its design;
- B3 above the fused route's cap, whole and by kernel: at the w32 n=32768
  path's shapes (``create_tpu_param(32768)``, level 21, batch B:
  ``ksw_switch32_32k_*``) and at the w32 bootstrap's key-switch shapes
  (``create_tpu_btp_param()``, levels 47 and 9 at batch 2, both outputs at
  47: ``ksw_switch32_n65536_*``), through the wrapper (whatever route the
  checkout takes there);
- at the u64 path's shapes (``create(16384)``, level 3, batch B), B6's four
  conversions of a mult_relin (``bconv64_convert``: the BEHZ extension,
  scale_and_back's Q → aux, Shenoy's B → Q ∪ m_sk, RoundDivP's P → Q) each
  alone and together, and the key switch's mod-up of all β digits
  (``bconv64_raw``), held against the plain twin, with each CUDA kernel's
  device time;
- B7's gadget inner product (``ksw_inner64``) at the u64 path's digits
  (B, 2, 6, n) and at the u64 n=32768 path's (``create(32768)``, level 11:
  (B, 4, 15, n)), with random keys, held against the plain twin, with its
  device time.

Prints one JSON line ``{"fused_bench": {...}}`` with the times in ms, the
equality flags, the routes the wrappers took, the root and the card's name
and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N = 16384
LEVEL = 7
LEVEL64 = 3


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
        print('fused_bench: needs a CUDA card', file=sys.stderr)
        return 2
    import lattisense_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(lattisense_torch.__file__))) != root:
        print(f'fused_bench: lattisense_torch was not imported from {root}', file=sys.stderr)
        return 2
    from lattisense_torch.core.modring import get_rns_ring
    from lattisense_torch.ops import behz_cuda, ksw_cuda
    from lattisense_torch.params import BfvParams
    from lattisense_torch.schemes.bfv import BfvEngine
    from lattisense_torch.schemes.types import KeySwitchKey

    dev = torch.device('cuda', torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(7)
    B = args.batch

    def stack(ring, lead):
        x = torch.randint(0, 1 << 62, (*lead, len(ring.moduli), N), generator=gen, device=dev)
        return x % ring.q

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.iters

    def kernel_ms(fn):
        """Device ms per call of each CUDA kernel `fn` launches."""
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            key = ev.key.replace('(anonymous namespace)::', '').replace('void ', '')
            cut = key.find('>(')
            name = (key[:cut + 1] if cut >= 0 else key.split('(')[0]).replace('ntt::', '')
            dev_us = getattr(ev, 'device_time_total', None)
            if dev_us is None:
                dev_us = ev.cuda_time_total
            out[name[:120]] = out.get(name[:120], 0.0) + dev_us / 1e3 / args.iters
        return out

    params = BfvParams.create_tpu_param(N)
    eng = BfvEngine(params, dev)
    bz, sw = eng.behz(LEVEL), eng.switcher
    rq, ra = bz.ring_q, bz.ring_aux
    L = len(rq.moduli)
    out = {}

    # B2 on the 4 input polynomials of each operation
    x = stack(rq, (B, 4))
    fq, fa = behz_cuda.behz_prep32(x, bz)
    want = behz_cuda.behz_prep_plain(x, bz)
    out['behz_prep32_equal'] = torch.equal(fq, want[0]) and torch.equal(fa, want[1])
    out['behz_prep32_ms'] = timed(lambda: behz_cuda.behz_prep32(x, bz))
    out['behz_prep32_kernels_ms'] = kernel_ms(lambda: behz_cuda.behz_prep32(x, bz))
    del x, fq, fa, want

    # B3: the relinearization-shaped switch of (B, L, n) with a random key
    beta = sw.beta(LEVEL)
    kq = stack(get_rns_ring(tuple(params.q), N, dev), (beta + 1, 2))
    kp = stack(get_rns_ring(tuple(params.p), N, dev), (beta + 1, 2))
    key = KeySwitchKey(key_q=kq, key_p=kp)
    x = stack(rq, (B,))
    e = ksw_cuda.ksw_switch32(x, key, sw, LEVEL)
    want = sw.switch_plain(x, key, LEVEL)
    out['ksw_switch32_equal'] = torch.equal(e[0], want[0]) and torch.equal(e[1], want[1])
    out['ksw_switch32_route'] = ksw_cuda.switch_route(N)
    out['ksw_switch32_ms'] = timed(lambda: ksw_cuda.ksw_switch32(x, key, sw, LEVEL))
    out['ksw_switch32_kernels_ms'] = kernel_ms(lambda: ksw_cuda.ksw_switch32(x, key, sw, LEVEL))
    del x, e, want, key, kq, kp

    # B3 above the fused route's cap: the w32 n=32768 path and the w32
    # bootstrap's key-switch shapes
    from lattisense_torch.params import CkksParams
    from lattisense_torch.schemes.keyswitch import KeySwitcher

    def n_residues(moduli, lead, n):
        x = torch.randint(0, 1 << 62, (*lead, len(moduli), n), generator=gen, device=dev)
        return x % torch.tensor(moduli, device=dev).reshape(-1, 1)

    p32k = BfvParams.create_tpu_param(2 * N)
    p64k = CkksParams.create_tpu_btp_param(4 * N)
    for tag, prm, calls in (('32k', p32k, [(len(p32k.q) - 1, (B,), False)]),
                            ('n65536', p64k, [(len(p64k.q) - 1, (2,), False),
                                              (len(p64k.q) - 1, (2,), True), (9, (2,), False),
                                              (9, (2,), True)])):
        n = prm.n
        swn = KeySwitcher(tuple(prm.q), tuple(prm.p), n, dev, 32)
        betan = swn.beta(len(prm.q) - 1)
        keyn = KeySwitchKey(key_q=n_residues(prm.q, (betan, 2), n),
                            key_p=n_residues(prm.p, (betan, 2), n))
        ins = [(n_residues(prm.q[:lv + 1], lead, n), lv, ont) for lv, lead, ont in calls]
        out[f'ksw_switch32_{tag}_calls'] = [[list(x.shape), lv, ont] for x, lv, ont in ins]
        out[f'ksw_switch32_{tag}_route'] = ksw_cuda.switch_route(n)
        wants = [swn.switch_plain(x, keyn, lv, ont) for x, lv, ont in ins]

        def run_all(fn):
            return [fn(x, keyn, swn, lv, ont) for x, lv, ont in ins]

        def equal(got):
            return all(torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
                       for g, w in zip(got, wants))
        out[f'ksw_switch32_{tag}_equal'] = equal(run_all(ksw_cuda.ksw_switch32))
        out[f'ksw_switch32_{tag}_ms'] = timed(lambda: run_all(ksw_cuda.ksw_switch32))
        out[f'ksw_switch32_{tag}_kernels_ms'] = kernel_ms(lambda: run_all(ksw_cuda.ksw_switch32))
        del ins, wants, keyn
        torch.cuda.empty_cache()

    # B4: the (B, 3, L, n) and (B, 3, T, n) tensor products
    dq, da = stack(rq, (B, 3)), stack(ra, (B, 3))
    got = behz_cuda.behz_finish32(dq, da, bz)
    out['behz_finish32_equal'] = torch.equal(got, behz_cuda.behz_finish_plain(dq, da, bz))
    out['behz_finish32_ms'] = timed(lambda: behz_cuda.behz_finish32(dq, da, bz))
    out['behz_finish32_kernels_ms'] = kernel_ms(lambda: behz_cuda.behz_finish32(dq, da, bz))
    del dq, da, got

    # B6 at the u64 path's shapes
    from lattisense_torch.ops import bconv_cuda
    p64 = BfvParams.create(N)
    eng64 = BfvEngine(p64, dev)
    bz64, sw64 = eng64.behz(LEVEL64), eng64.switcher

    def src_residues(moduli, lead):
        x = torch.randint(0, 1 << 62, (*lead, len(moduli), N), generator=gen, device=dev)
        return x % torch.tensor(moduli, device=dev).reshape(-1, 1)

    convs = [('extend', bz64.extend.conv, (B, 4)), ('scale_and_back', bz64.conv_q_to_aux, (B, 3)),
             ('shenoy', bz64.shenoy.conv, (B, 3)),
             ('round_div_p', sw64._level_pre(LEVEL64)[5].conv, (B, 2))]
    ins = []
    for cname, conv, lead in convs:
        y = conv.decompose(src_residues(conv.src, lead))
        got = bconv_cuda.bconv64_convert(y, conv)
        out[f'bconv64_{cname}_equal'] = torch.equal(got, bconv_cuda.bconv64_plain(
            y, conv.qhat_dst_mont, conv.dst_q, conv.dst_pinv))
        out[f'bconv64_{cname}_ms'] = timed(lambda y=y, conv=conv: bconv_cuda.bconv64_convert(y, conv))
        ins.append((y, conv))
    out['bconv64_convert_ms'] = timed(lambda: [bconv_cuda.bconv64_convert(y, c) for y, c in ins])
    out['bconv64_convert_kernels_ms'] = kernel_ms(
        lambda: [bconv_cuda.bconv64_convert(y, c) for y, c in ins])
    del ins
    pre, rqp = sw64._level_pre(LEVEL64), sw64.ring_qp(LEVEL64)
    alpha, beta = sw64.alpha, sw64.beta(LEVEL64)
    y = src_residues(p64.q[:LEVEL64 + 1], (B,)).reshape(B, beta, alpha, N)
    got = bconv_cuda.bconv64_raw(y, pre[4], rqp.q, rqp.pinv)
    out['bconv64_raw_equal'] = torch.equal(got, bconv_cuda.bconv64_plain(y, pre[4], rqp.q,
                                                                         rqp.pinv))
    out['bconv64_raw_ms'] = timed(lambda: bconv_cuda.bconv64_raw(y, pre[4], rqp.q, rqp.pinv))
    out['bconv64_raw_kernels_ms'] = kernel_ms(
        lambda: bconv_cuda.bconv64_raw(y, pre[4], rqp.q, rqp.pinv))
    del y, got

    # B7 at both u64 paths' digits
    from lattisense_torch.ops import ksw64_cuda
    for n, level, tag in ((N, LEVEL64, 'ksw_inner64'), (2 * N, 11, 'ksw_inner64_32k')):
        pn = BfvParams.create(n)
        swn = BfvEngine(pn, dev).switcher
        rqp, beta = swn.ring_qp(level), swn.beta(level)

        def n_residues(moduli, lead, n=n):
            x = torch.randint(0, 1 << 62, (*lead, len(moduli), n), generator=gen, device=dev)
            return x % torch.tensor(moduli, device=dev).reshape(-1, 1)

        key = KeySwitchKey(key_q=n_residues(pn.q, (beta, 2)), key_p=n_residues(pn.p, (beta, 2)))
        d = n_residues(rqp.moduli, (B, beta))
        got = ksw64_cuda.ksw_inner64(d, key, level, rqp)
        out[f'{tag}_equal'] = torch.equal(got, ksw64_cuda.ksw_inner64_plain(d, key, level, rqp))
        out[f'{tag}_shape'] = list(d.shape)
        out[f'{tag}_ms'] = timed(lambda: ksw64_cuda.ksw_inner64(d, key, level, rqp))
        out[f'{tag}_kernels_ms'] = kernel_ms(lambda: ksw64_cuda.ksw_inner64(d, key, level, rqp))
        del d, got, key
    out['batch'], out['level'], out['limbs'], out['level64'] = B, LEVEL, L, LEVEL64
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({'fused_bench': {'root': os.path.relpath(root), 'device': str(dev),
                                      'gpu': gpu, 'iters': args.iters, **out}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
