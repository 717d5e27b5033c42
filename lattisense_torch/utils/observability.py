"""Observability: task progress, host and device memory, device traces.

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
"""

import os
import sys
import threading
import time

import torch


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
