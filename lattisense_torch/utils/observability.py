"""Observability: task progress, host and device memory, device traces, and
the program's spans and counters.

Port of ``lattisense_tpu/utils/observability.py`` (reference parity:
TaskProgressBar / the throttled ProgressCallback(completed, total),
tools/task_progress_bar.h:31, mega_ag_runners/cpu_task_utils.h:414;
MemoryMonitor, the 100 ms sampler of mega_ag_runners/cpu_mem_monitor.h:34
writing a crash-safe CSV, with the card's memory as the reference's
gpu_mem_monitor.h reports it). ``tools/plot_mem.py`` reads the CSV.

The device column is the memory PyTorch's caching allocator holds in
tensors on the card (``torch.cuda.memory_allocated``): a host-side count
that calls nothing on the device, so sampling it is safe while another
thread captures a CUDA graph. ``device_memory_stats`` reports the card's
own view (``torch.cuda.mem_get_info``).

``span(name)`` marks a layer boundary of the program (``step`` around a
batched call, ``bfv.mult``, ``ksw.moddown``, ...). It records only while a
``torch.profiler`` session records; otherwise it hands back one shared
no-op object, at the cost of one attribute read. A recording span opens
``ls.<name>`` on the profiler's host timeline, so a trace puts each kernel
and each idle gap of the device under the program's stage, and keeps a
record in memory: its parent, the step it belongs to (a root span opens a
new step), host start and end, a CUDA event pair on the current stream (none
while that stream captures a CUDA graph), its attributes, and the kernel
launches the program counted inside it. ``spans()`` and ``totals()`` read
the records, synchronizing once to resolve their events; ``reset()`` clears
them. ``register`` gathers the program's counters (each kernel wrapper's
``launches``, the mesh's collectives, ``tables_built``, ``cuda_build``'s
libraries) under one registry that ``counters()`` reads.
"""

import itertools
import os
import sys
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


class TaskProgressBar:
    """Stderr block progress bar, throttled to ``interval_ms``."""

    def __init__(self, total: int, width: int = 40, interval_ms: int = 100):
        self.total = max(total, 1)
        self.width = width
        self.interval = interval_ms / 1e3
        self._last = 0.0

    def __call__(self, completed: int, total: int | None = None):
        total = total or self.total
        now = time.monotonic()
        if completed < total and now - self._last < self.interval:
            return
        self._last = now
        frac = completed / total
        filled = int(self.width * frac)
        bar = '█' * filled + '░' * (self.width - filled)
        end = '\n' if completed >= total else '\r'
        print(f'[{bar}] {completed}/{total} ({frac:6.1%})', file=sys.stderr,
              end=end, flush=True)


def _read_proc_status():
    vals = {}
    try:
        with open('/proc/self/status') as f:
            for line in f:
                if line.startswith(('VmRSS', 'VmHWM', 'AnonHugePages')):
                    k, v = line.split(':', 1)
                    vals[k] = int(v.strip().split()[0])  # kB
    except OSError:
        pass
    return vals


def device_memory_stats():
    """Per CUDA device {bytes_in_use, bytes_limit}: the card's used and
    total memory, all processes included (empty without a card)."""
    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            out[f'cuda:{i}'] = {'bytes_in_use': total - free, 'bytes_limit': total}
    return out


def _device_bytes_in_use() -> int:
    """Bytes in tensors of this process on every initialised card."""
    if not torch.cuda.is_initialized():
        return 0
    return sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count()))


class MemoryMonitor:
    """Background sampler → CSV, flushed a line at a time (crash-safe, as
    the reference's monitor). A sample is written at ``start`` and at
    ``stop`` too, so even a short run leaves two rows. Enabled under
    ``LATTISENSE_DEV`` by the task runtime, as in the reference."""

    def __init__(self, interval_ms: int = 100, with_device: bool = False):
        self.interval = interval_ms / 1e3
        self.with_device = with_device
        self._stop = threading.Event()
        self._thread = None
        self._file = None

    @staticmethod
    def next_csv_path(prefix: str = 'mem_usage', directory: str = '.') -> str:
        i = 0
        while True:
            path = os.path.join(directory, f'{prefix}_{i}.csv')
            if not os.path.exists(path):
                return path
            i += 1

    def start(self, csv_path: str):
        self._file = open(csv_path, 'w')
        cols = 'time_s,vmrss_kb,vmhwm_kb,anon_huge_kb'
        if self.with_device:
            cols += ',device_bytes_in_use'
        self._file.write(cols + '\n')
        self._t0 = time.monotonic()
        self._stop.clear()
        self._sample()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _sample(self):
        vals = _read_proc_status()
        row = (f'{time.monotonic() - self._t0:.3f},'
               f"{vals.get('VmRSS', 0)},{vals.get('VmHWM', 0)},"
               f"{vals.get('AnonHugePages', 0)}")
        if self.with_device:
            row += f',{_device_bytes_in_use()}'
        self._file.write(row + '\n')
        self._file.flush()

    def _loop(self):
        while not self._stop.wait(self.interval):
            self._sample()

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._sample()
        self._file.close()
        self._thread = None


def dev_mode_enabled() -> bool:
    return os.environ.get('LATTISENSE_DEV', '') not in ('', '0')


class trace:
    """Device-level tracing context: ``torch.profiler`` over the region (the
    card's kernels when a card is present), written on exit as a Chrome /
    Perfetto trace ``trace_<pid>_<ns>.json`` into ``log_dir`` — the port's
    counterpart of ``jax.profiler.trace`` in the JAX package, and of the
    reference's wall-time prints (LATTISENSE_PRINT_PROFILE).

        with observability.trace('fhe_trace'):
            task.run(ctx, args)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f'trace_{os.getpid()}_{time.time_ns()}.json')
        self._prof.export_chrome_trace(self.path)
        return False


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

#: counter name -> a dict of counts, or a function that returns one
_counters: dict = {}
#: counter name -> (counter, the keys that each count one launch) of the
#: kernel wrappers, whose sum a span records
_launch_counters: dict[str, tuple[dict, tuple]] = {}
#: cache misses of the program's constant tables, by table: a hit counts nothing
tables_built: dict[str, int] = {}
_table_probes: dict = {}


def register(name: str, counter, launches=()):
    """Put ``counter`` (a dict of counts the program keeps, or a function
    returning one) in the registry under ``name``. ``launches``: the keys of
    ``counter`` that each count one kernel launch (a key counting a launch
    already counted under another is left out), which every recording span
    sums."""
    _counters[name] = counter
    if launches:
        _launch_counters[name] = (counter, tuple(launches))


def table_built(name: str):
    """Count one build of table ``name`` (on a cache miss only)."""
    tables_built[name] = tables_built.get(name, 0) + 1


def probe_table(name: str, misses):
    """Read table ``name``'s builds from ``misses()`` (a cache's own miss
    count) whenever the counters are read."""
    _table_probes[name] = misses


def _tables_built() -> dict:
    return {**tables_built, **{k: f() for k, f in _table_probes.items()}}


register('tables_built', _tables_built)


def counters() -> dict[str, dict]:
    """A copy of every registered counter, by name."""
    out = {}
    for name, c in _counters.items():
        vals = c() if callable(c) else c
        out[name] = {k: dict(v) if isinstance(v, dict) else v for k, v in vals.items()}
    return out


def _launched() -> int:
    return sum(c[k] for c, keys in _launch_counters.values() for k in keys)


class _Off:
    """The span handed out while no profiler records: it enters and leaves
    without calling the profiler, recording an event or allocating."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


OFF = _Off()
_records: list = []
_open = threading.local()
_step_ids = itertools.count()


class Span:
    """One recording span: see ``span``."""

    __slots__ = ('name', 'attrs', 'parent', 'step', 'start_ns', 'end_ns', 'launches',
                 'device_ms', '_clock', '_events', '_rf', '_launched0')

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.end_ns = None
        self.device_ms = None

    def __enter__(self):
        stack = _open.__dict__.setdefault('stack', [])
        self.parent = stack[-1] if stack else None
        self.step = next(_step_ids) if self.parent is None else self.parent.step
        # _RecordFunctionFast opens a host-side range only; record_function's
        # user annotation would also lay a range on the device timeline,
        # which a trace reader would count as device work
        self._rf = torch._C._profiler._RecordFunctionFast('ls.' + self.name)
        self._rf.__enter__()
        self._events = None
        if not torch.cuda.is_initialized():
            self._clock = 'host'            # no card in use: the work runs on the host
        elif torch.cuda.is_current_stream_capturing():
            self._clock = 'capture'         # a CUDA graph is captured: no event, no device time
        else:
            self._clock = 'cuda'
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self._launched0 = _launched()
        stack.append(self)
        _records.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.perf_counter_ns()
        self.launches = _launched() - self._launched0
        if self._events is not None:
            self._events[1].record()
        self._rf.__exit__(None, None, None)
        self._rf = None
        _open.stack.pop()
        return None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def span(name: str, **attrs):
    """A span at a layer boundary, named ``name``: a recording ``Span`` while
    a ``torch.profiler`` session records, else the shared no-op ``OFF``
    (``with span(...) as s`` gives None then)."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return Span(name, attrs)


def _resolve(recs):
    """Each closed record's device ms, after one synchronize where a CUDA
    event pair is pending: the events' elapsed time; on the host clock (no
    card in use) the host ms; None where a CUDA graph was being captured."""
    pending = [r for r in recs if r._events is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = r._events[0].elapsed_time(r._events[1])
            r._events = None
    for r in recs:
        if r._clock == 'host' and r.device_ms is None:
            r.device_ms = r.host_ms


def spans() -> list[dict]:
    """The closed spans in the order they opened: ``id``, ``name``,
    ``parent`` (its id, or None for a root), ``step`` (the id shared by a
    root and every span under it), ``attrs``, ``start_ns`` / ``end_ns`` (host
    ``perf_counter_ns``), ``host_ms``, ``host_self_ms`` (less its children's
    host ms), ``device_ms`` and ``launches``."""
    recs = [r for r in _records if r.end_ns is not None]
    _resolve(recs)
    ids = {id(r): i for i, r in enumerate(recs)}
    child_ms = [0.0] * len(recs)
    for r in recs:
        if r.parent is not None and id(r.parent) in ids:
            child_ms[ids[id(r.parent)]] += r.host_ms
    return [{'id': i, 'name': r.name,
             'parent': ids.get(id(r.parent)) if r.parent is not None else None,
             'step': r.step, 'attrs': dict(r.attrs), 'start_ns': r.start_ns,
             'end_ns': r.end_ns, 'host_ms': r.host_ms, 'host_self_ms': r.host_ms - child_ms[i],
             'device_ms': r.device_ms, 'launches': r.launches}
            for i, r in enumerate(recs)]


def totals() -> dict[str, dict]:
    """Per span name: ``calls``, ``host_ms``, ``host_self_ms``, ``device_ms``
    (summed over the calls with a device time; None if none has one),
    ``launches``, and ``steps``: the ``step`` roots recorded, the same for
    every name, by which a reader divides to give a step's share."""
    recs = spans()
    steps = sum(1 for r in recs if r['name'] == 'step' and r['parent'] is None)
    out = {}
    for r in recs:
        t = out.setdefault(r['name'], {'calls': 0, 'host_ms': 0.0, 'host_self_ms': 0.0,
                                       'device_ms': None, 'launches': 0, 'steps': steps})
        t['calls'] += 1
        t['host_ms'] += r['host_ms']
        t['host_self_ms'] += r['host_self_ms']
        t['launches'] += r['launches']
        if r['device_ms'] is not None:
            t['device_ms'] = (t['device_ms'] or 0.0) + r['device_ms']
    return out


def reset():
    """Forget every recorded span (the counters keep counting)."""
    _records.clear()
