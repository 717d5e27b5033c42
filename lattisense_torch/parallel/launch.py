"""Start a world of ranks for the mesh (``parallel/mesh.py``).

The JAX package is single-controller and needs no launcher. The port is SPMD:
``World(world, backend=..., device=...)`` spawns ``world`` processes (start
method ``spawn``), each of which joins one ``torch.distributed`` process
group and then waits for work; ``World.run(fn, *args)`` calls ``fn(*args)``
on every rank and returns the ranks' results in rank order. ``run_ranks``
does one call in a world of its own.

- The ranks meet through a ``FileStore`` in a temporary directory, never a
  fixed port, so that worlds started side by side cannot collide.
- The backend is explicit: NCCL when each rank owns a card of its own (rank r
  on card r), gloo when the ranks share one card (NCCL refuses two ranks on
  one device) and on the CPU. It defaults to that rule.
- On the card the parent builds the CUDA libraries before the spawn
  (``ops/cuda_build.build_all``), so the ranks only load them from
  ``build/kernels/`` and never race to build one.
- On the CPU each rank computes on one thread, so that a world does not
  oversubscribe the host's cores.
- ``fn`` and its arguments travel by pickle: ``fn`` is a module-level
  function of a module the ranks can import; results should be CPU tensors
  or NumPy arrays. A rank's exception comes back as a ``RuntimeError`` with
  its traceback, and the world is then torn down, since the other ranks may
  wait in a collective for it.
"""

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from .. import resolve_device

DEFAULT_TIMEOUT_S = 900


def default_backend(world: int, device: torch.device) -> str:
    """NCCL when every rank can own a card of its own, else gloo."""
    if device.type == 'cuda' and world <= torch.cuda.device_count():
        return 'nccl'
    return 'gloo'


def rank_device(rank: int, backend: str, device: torch.device) -> torch.device:
    """The device rank ``rank`` computes on: its own card under NCCL, the
    shared card or the CPU under gloo."""
    if device.type != 'cuda':
        return device
    if backend == 'nccl':
        return torch.device('cuda', rank)
    return device


def _rank_main(rank, world, backend, device, store_path, timeout_s, jobs, results):
    import torch.distributed as dist
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            fn, args = job
            try:
                results.put((rank, True, fn(*args)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``world`` ranks in one process group, started once and reused by
    ``run``; ``close`` (or leaving the ``with`` block) stops them."""

    def __init__(self, world: int, backend: str | None = None, device=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        dev = resolve_device(device)
        self.world = world
        self.backend = backend or default_backend(world, dev)
        if self.backend not in ('gloo', 'nccl'):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got {self.backend!r}")
        if self.backend == 'nccl':
            if dev.type != 'cuda':
                raise ValueError('the NCCL backend needs CUDA')
            if world > torch.cuda.device_count():
                raise ValueError(f'NCCL needs a card a rank: {world} ranks, '
                                 f'{torch.cuda.device_count()} cards (use gloo to share one)')
        if dev.type == 'cuda':
            from ..ops import cuda_build
            cuda_build.build_all()
        self.timeout_s = timeout_s
        self.devices = [rank_device(r, self.backend, dev) for r in range(world)]
        self._dir = tempfile.mkdtemp(prefix='lattisense_world_')
        ctx = mp.get_context('spawn')
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, world, self.backend, self.devices[r],
                                         os.path.join(self._dir, 'store'), timeout_s,
                                         self._jobs[r], self._results))
                       for r in range(world)]
        for p in self._procs:
            p.start()
        try:
            self._collect('start')
        except Exception:
            self.close()
            raise

    def _collect(self, what: str):
        """One answer from every rank; raises on a rank's error, a rank that
        died, or no answer within the timeout."""
        out, errors = {}, []
        deadline = time.monotonic() + self.timeout_s
        while len(out) < self.world and not errors:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if p.exitcode is not None]
                if dead:
                    errors.append(f'ranks {dead} exited '
                                  f'({[self._procs[r].exitcode for r in dead]})')
                elif time.monotonic() > deadline:
                    errors.append(f'no answer within {self.timeout_s} s')
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f'rank {rank}:\n{value}')
        if errors:
            raise RuntimeError(f'{what} failed on the world of {self.world}:\n' +
                               '\n'.join(errors))
        return [out[r] for r in range(self.world)]

    def run(self, fn, *args):
        """fn(*args) on every rank → the results in rank order."""
        if self._procs is None:
            raise RuntimeError('the world is closed')
        for q in self._jobs:
            q.put((fn, args))
        try:
            return self._collect(getattr(fn, '__name__', 'run'))
        except Exception:
            self.close()
            raise

    def close(self):
        if self._procs is None:
            return
        for q in self._jobs:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=20)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        self._procs = None
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(world: int, fn, *args, backend: str | None = None, device=None,
              timeout_s: float = DEFAULT_TIMEOUT_S):
    """Start ``world`` ranks, run fn(*args) on each, stop them; → the results
    in rank order. ``device`` is the card unless the caller asks for the CPU."""
    with World(world, backend=backend, device=device, timeout_s=timeout_s) as w:
        return w.run(fn, *args)
