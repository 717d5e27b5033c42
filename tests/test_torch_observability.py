"""lattisense_torch's observability held against lattisense_tpu's.

``MemoryMonitor`` writes the JAX monitor's CSV header and rows on the CPU
(the columns ``tools/plot_mem.py`` reads); ``TaskProgressBar`` throttles and
draws as the JAX bar does; a CPU task run under ``LATTISENSE_DEV=1`` writes
``mem_usage_gpu_0.csv`` and returns the outputs of a run without it;
``trace`` writes a Chrome trace of the region.
"""

import json
import time

import numpy as np
import pytest
import torch

from lattisense_tpu.utils import observability as robs

from lattisense_torch.core.modring import gen_ntt_primes
from lattisense_torch.frontend import custom_task as ctk
from lattisense_torch.params import BfvParams
from lattisense_torch.runtime import BfvContext, FheTask
from lattisense_torch.utils import observability as obs

from .test_torch_task import build_mult_rotate, gen_task

HOST_COLS = ['time_s', 'vmrss_kb', 'vmhwm_kb', 'anon_huge_kb']


def read_csv(path):
    with open(path) as f:
        header = f.readline().strip().split(',')
        rows = [line.strip().split(',') for line in f if line.strip()]
    return header, rows


@pytest.mark.parametrize('with_device', [False, True])
def test_memory_monitor_csv_matches_reference(tmp_path, with_device):
    """The same header as the JAX monitor's, rows of numbers every interval,
    a row at start and at stop; no card here, so the device column is 0."""
    paths = {}
    for name, mod in (('port', obs), ('jax', robs)):
        mon = mod.MemoryMonitor(interval_ms=20, with_device=with_device and name == 'port')
        paths[name] = mon.next_csv_path('mem_usage', str(tmp_path))
        mon.start(paths[name])
        time.sleep(0.15)
        mon.stop()
        mon.stop()                                   # a second stop is a no-op
    header, rows = read_csv(paths['port'])
    ref_header, _ = read_csv(paths['jax'])
    assert header == HOST_COLS + (['device_bytes_in_use'] if with_device else [])
    assert ref_header == HOST_COLS
    assert len(rows) >= 4
    times = [float(r[0]) for r in rows]
    assert times == sorted(times) and times[0] < 0.05
    assert all(int(v) > 0 for r in rows for v in r[1:3])
    if with_device:
        assert all(r[-1] == '0' for r in rows)
    assert obs.MemoryMonitor.next_csv_path('mem_usage', str(tmp_path)).endswith('mem_usage_2.csv')


def test_progress_bar_matches_reference(capsys):
    """Throttled to the interval, always drawn at the end, the same text."""
    out = {}
    for name, mod in (('port', obs), ('jax', robs)):
        bar = mod.TaskProgressBar(10, width=10, interval_ms=10_000)
        for done in (1, 2, 3, 10):
            bar(done)
        out[name] = capsys.readouterr().err
    assert out['port'] == out['jax']
    assert out['port'].count('/10') == 2                # the first call, then the end
    assert out['port'].endswith('[██████████] 10/10 (100.0%)\n')


def test_dev_mode_and_device_stats(monkeypatch):
    for value, on in (('', False), ('0', False), ('1', True), ('yes', True)):
        monkeypatch.setenv('LATTISENSE_DEV', value)
        assert obs.dev_mode_enabled() == robs.dev_mode_enabled() == on
    stats = obs.device_memory_stats()
    assert len(stats) == (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    assert all(0 < s['bytes_in_use'] <= s['bytes_limit'] for s in stats.values())


def test_task_run_under_dev_mode_writes_the_csv(tmp_path, monkeypatch):
    """A CPU FheTask run under LATTISENSE_DEV=1, eager and jit, of the
    mult-rotate task's graph on a 31-bit chain at n=256, leaves the
    monitor's CSV and the outputs of a plain run."""
    n, t, level = 256, 65537, 2
    primes = gen_ntt_primes(n, 31, 6)
    q, p = primes[:4], primes[4:]
    d = gen_task(ctk.BfvParam.create_custom_param(n=n, q=q, p=p, t=t), build_mult_rotate,
                 tmp_path / 'task', level)
    ctx = BfvContext.create_random_context(BfvParams.create_custom(n, t, q, p, word_bits=32),
                                           seed=5, device='cpu')
    ctx.gen_rotation_keys_for_rotations([1])
    m = np.arange(n) % t
    args = {'x': ctx.encrypt(ctx.encode(m, level)), 'y': ctx.encrypt(ctx.encode(m, level))}
    for mode in ('eager', 'jit'):
        task = FheTask(d, mode=mode, device='cpu')
        plain, _ = task.run(ctx, args)
        run_dir = tmp_path / mode
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        monkeypatch.setenv('LATTISENSE_DEV', '1')
        monitored, _ = task.run(ctx, args)
        monkeypatch.delenv('LATTISENSE_DEV')
        assert torch.equal(monitored['w'].data, plain['w'].data)
        header, rows = read_csv(run_dir / 'mem_usage_gpu_0.csv')
        assert header == HOST_COLS and len(rows) >= 2       # a CPU task: host columns only
        assert sorted(f.name for f in run_dir.iterdir()) == ['mem_usage_gpu_0.csv']
    prod = m * m % t
    np.testing.assert_array_equal(ctx.decrypt_decode(plain['w']),
                                  np.roll(prod.reshape(2, -1), -1, axis=1).reshape(-1))


def test_trace_writes_a_chrome_trace(tmp_path):
    with obs.trace(str(tmp_path / 'trace')) as tr:
        torch.arange(1000).sum()
    with open(tr.path) as f:
        events = json.load(f)['traceEvents']
    assert events
