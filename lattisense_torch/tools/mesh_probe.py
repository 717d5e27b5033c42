"""Probe what the card offers the MXU route and the mesh, one JSON line each.

Run on the card: ``python -m lattisense_torch.tools.mesh_probe``.

1. The four matrix products the MXU NTT could use, at the shape of one limb
   of ``u64_path``'s forward stack (16384×1152 by 1152×2176, balanced 7-bit
   digits): bf16 with float32 sums (``torch.mm`` / ``torch.bmm`` with
   ``out_dtype``), int8 with int32 sums (``torch._int_mm``) and float32;
   for each whether the sums are exact (against float64) and its ms and
   multiply-adds a second (CUDA events over 10 calls after 3).
2. Worlds of ranks (``parallel/launch.py``'s processes, a ``FileStore``)
   running the four collectives of ``parallel/mesh.py`` on int64 tensors
   near 2^62: 2 ranks over gloo with host and with CUDA tensors, 1 rank over
   NCCL, and 2 ranks over NCCL on one card, which NCCL refuses ("Duplicate
   GPU detected"): the reason ranks that share a card use gloo.
"""

import json
import os
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

M, K, N = 16384, 1152, 2176


def _matmuls():
    dev = torch.device('cuda')
    g = torch.Generator().manual_seed(1)
    a = torch.randint(-64, 64, (M, K), generator=g, dtype=torch.int64)
    b = torch.randint(-64, 64, (K, N), generator=g, dtype=torch.int64)
    ref = (a.to(dev).double() @ b.to(dev).double()).long()
    a16, b16 = a.to(dev, torch.bfloat16), b.to(dev, torch.bfloat16)
    a8, b8 = a.to(dev, torch.int8), b.to(dev, torch.int8)
    a32, b32 = a.to(dev, torch.float32), b.to(dev, torch.float32)
    calls = {
        'mm_bf16_f32': lambda: torch.mm(a16, b16, out_dtype=torch.float32),
        'bmm_bf16_f32': lambda: torch.bmm(a16[None], b16[None], out_dtype=torch.float32)[0],
        'int_mm': lambda: torch._int_mm(a8, b8),
        'mm_f32': lambda: torch.mm(a32, b32)}
    out = {}
    for name, fn in calls.items():
        try:
            exact = bool(torch.equal(fn().long(), ref))
            for _ in range(3):
                fn()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop) / 10
            out[name] = {'exact': exact, 'ms': ms, 'tmac_s': M * K * N / ms / 1e9}
        except RuntimeError as exc:
            out[name] = f'{type(exc).__name__}: {str(exc)[:300]}'
    return out


def _rank(rank, world, backend, store, on_cuda, results):
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        dev = 'cuda' if on_cuda else 'cpu'
        x = torch.arange(8, dtype=torch.int64, device=dev) + (1 << 62) * (rank + 1)
        res = {'rank': rank}
        for name, fn in (
                ('all_reduce', lambda: dist.all_reduce(x.clone())),
                ('reduce_scatter', lambda: dist.reduce_scatter_tensor(
                    torch.empty(8 // world, dtype=torch.int64, device=dev), x)),
                ('all_gather', lambda: dist.all_gather_into_tensor(
                    torch.empty(8 * world, dtype=torch.int64, device=dev), x)),
                ('all_to_all', lambda: dist.all_to_all_single(torch.empty_like(x), x))):
            try:
                fn()
                torch.cuda.synchronize()
                res[name] = 'ok'
            except RuntimeError as exc:
                res[name] = f'{type(exc).__name__}: {str(exc)[:300]}'
        y = x.clone()
        dist.all_reduce(y)
        res['sum_of_(rank+1)*2^62'] = int(y[0])
        dist.destroy_process_group()
        results.put(res)
    except Exception:
        results.put({'rank': rank, 'error': traceback.format_exc()[-600:]})


def _world(world, backend, on_cuda, timeout=90):
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank, args=(r, world, backend, os.path.join(d, 's'),
                                                 on_cuda, results)) for r in range(world)]
        for p in procs:
            p.start()
        out = []
        for _ in range(world):
            try:
                out.append(results.get(timeout=timeout))
            except Exception as exc:           # a rank that hangs: report and stop it
                out.append({'timeout': repr(exc)})
                break
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
    return {'world': world, 'backend': backend, 'cuda_tensors': on_cuda,
            'wall_s': time.perf_counter() - t0, 'ranks': out}


def main():
    print(json.dumps({'torch': torch.__version__, 'cuda': torch.version.cuda,
                      'gpu': torch.cuda.get_device_name(0),
                      'bf16_reduced_precision_reduction':
                          torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}),
          flush=True)
    print(json.dumps({'matmul': _matmuls()}), flush=True)
    for world, backend, on_cuda in ((2, 'gloo', False), (2, 'gloo', True), (1, 'nccl', True),
                                    (2, 'nccl', True)):
        print(json.dumps(_world(world, backend, on_cuda)), flush=True)
    os.system('nvidia-smi --query-gpu=name,power.limit --format=csv,noheader')


if __name__ == '__main__':
    main()
