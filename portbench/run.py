"""One run of one benchmark cell of lattisense_torch, the PyTorch and CUDA
package, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A fresh process loads the cell by name (``portbench/workloads/<cell>.json``,
its configuration from ``BENCHMARK.json``), has its traffic driver
(``portbench/traffic/<op>.py``) build the program's context on the
benchmark's secret and encrypt the seed's inputs, warms every shape up, then
runs a closed loop for ``--seconds``: one caller, each step one batched call
ended by ``torch.cuda.synchronize()``. Once the window has closed and the
program's state is freed, the plain reference (``portbench/reference/``)
decrypts the outputs with the benchmark's secret and judges them.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``; its per-layer metrics with ``--trace 1``, each read by
``portbench/metrics/<metric>.py``), ``device`` and, traced, ``breakdown``;
last, ``compared``: each number the check compared beside its limit, which
also end standard error. Without a card, or with fewer than the cell asks
for, it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'lattisense_tpu')
PROFILE_STEPS = 3            # the profiled window: at least this many steps ...
PROFILE_SECONDS = 1.0        # ... and this long,
PROFILE_MAX_STEPS = 200      # at most this many steps
TOP = 10                     # entries of each breakdown list
NAME_CHARS = 160             # a kernel's name in the breakdown, cut to this


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: str = ROOT):
    """(BENCHMARK.json, the cell's file, its configuration's file)."""
    bench = load_json(os.path.join(root, 'BENCHMARK.json'))
    entry = next(w for w in bench['workloads'] if w['name'] == name)
    cell = load_json(os.path.join(HERE, 'workloads', name + '.json'))
    conf = next(c for c in bench['configs'] if c['name'] == entry['config'])
    return bench, cell, load_json(os.path.join(root, conf['file']))


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced (a metric without ``workloads`` is every cell's
    that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench['end_to_end'] if cell_name in m.get('workloads', [cell_name])]
    if not trace:
        return e2e
    names = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if cell_name in m.get('workloads', [cell_name] if m['moves'] in names else [])]


def reader(name: str):
    """The metric's reader: ``metrics/<name>.py``, or, for a name qualified
    by a dot (``idle_share.ckks``) that has no file of its own, the reader
    of the part before the first dot (``metrics/idle_share.py``)."""
    path = os.path.join(HERE, 'metrics', name + '.py')
    if not os.path.isfile(path):
        path = os.path.join(HERE, 'metrics', name.split('.')[0] + '.py')
    return load_module(path, 'portbench_metric_' + name)


def traffic(op: str):
    return load_module(os.path.join(HERE, 'traffic', op + '.py'), 'portbench_traffic_' + op)


def within(value, limit: dict) -> bool:
    return value <= limit['max'] if 'max' in limit else value >= limit['min']


def decide(cell: dict, items: list[dict], same: bool = True) -> tuple[dict, int, bool]:
    """The one comparison that decides ``correct``, for a run and for a
    control alike. ``items`` holds one dict of numbers for each ciphertext
    judged; each is held to the cell's limit of that name. → (each number
    compared, its worst over the items, beside its limit; the ciphertexts
    that fail; whether the run is correct). ``same``: the window's first
    and last outputs are equal bit for bit; where not, the batch fails."""
    limits = cell['limits']
    compared = {'first_equals_last': {'value': int(same), 'min': 1}}
    for k, lim in limits.items():
        compared[k] = {'value': (max if 'max' in lim else min)(it[k] for it in items), **lim}
    failed = sum(not all(within(it[k], lim) for k, lim in limits.items()) for it in items)
    failed += 0 if same else cell['batch']
    correct = failed == 0 and all(within(c['value'], c) for c in compared.values())
    return compared, failed, correct


def smi() -> dict:
    """The card's name, power limit and maximum SM clock from nvidia-smi."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,clocks.max.sm',
                          '--format=csv,noheader,nounits'], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    name, power, clock = [x.strip() for x in out.split(',')]
    return {'name': name, 'power_limit_w': float(power), 'max_sm_clock_mhz': float(clock)}


def window(fn, sync, seconds: float):
    """The closed loop: ``fn()`` then ``sync()``, again until ``seconds``
    have passed (at least once). → (host seconds of each step, host
    seconds of each step's enqueue, the window's seconds, first and last
    outputs)."""
    steps, enq = [], []
    first = last = None
    t_win = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        steps.append(t2 - t0)
        enq.append(t1 - t0)
        if first is None:
            first = out
        last = out
        if t2 - t_win >= seconds:
            return steps, enq, t2 - t_win, first, last


def merged(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(prof, steps: int, window_s: float) -> dict:
    """What the per-layer readers take from one profiled window: busy
    seconds (the union of the device's operations), the window, the steps,
    each ``pb.<part>`` label's device seconds (the kernels
    launched inside it), and the breakdown: device time by operation, and
    the idle gaps by the innermost host operation running at each gap's
    middle. The labels' own ranges on the device timeline are annotations,
    not operations, and count nowhere."""
    import bisect

    from torch.autograd import DeviceType
    dev, host, labels = [], [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith('pb.'):
                dev.append(e)
        elif e.device_type == DeviceType.CPU and not e.is_async:
            host.append(e)
            if e.name.startswith('pb.'):
                labels[e.name[3:]] = labels.get(e.name[3:], 0.0) + e.device_time_total / 1e6
    union = merged((e.time_range.start, e.time_range.end) for e in dev)
    busy = sum(b - a for a, b in union) / 1e6
    by_op = {}
    for e in dev:
        key = e.name[:NAME_CHARS]
        by_op[key] = by_op.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps = {}
    for (_, b), (a2, _) in zip(union, union[1:]):
        mid = (b + a2) / 2
        i = bisect.bisect_right(starts, mid) - 1
        what = 'no host operation'
        for j in range(i, max(i - 400, -1), -1):
            if host[j].time_range.end > mid:
                what = host[j].name
                break
        gaps[what] = gaps.get(what, 0.0) + (a2 - b) / 1e6
    return {'busy_s': busy, 'window_s': window_s, 'steps': steps,
            'span_device_s': labels,
            'breakdown': {
                'device_ops': sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
                'idle_gaps': sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]}}


def profiled(torch, fn, sync) -> dict:
    """A short window of ``fn`` under torch.profiler (host and device
    activity), after the timed one."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        k = 0
        while k < PROFILE_STEPS or (time.perf_counter() - t0 < PROFILE_SECONDS
                                    and k < PROFILE_MAX_STEPS):
            with torch.profiler.record_function('pb.step'):
                fn()
            sync()
            k += 1
        win = time.perf_counter() - t0
    return read_trace(prof, k, win)


def run(name: str, seed: int, seconds: float, trace: bool, device=None, t_start=None,
        loaded=None, patch=None) -> tuple[dict, dict]:
    """One run of cell ``name``; → (the result line, the compared numbers
    with their limits). ``device`` defaults to the card; ``loaded`` replaces
    the files read by name, ``patch(driver)`` is called after set-up (both
    for the harness's own tests). Once the window has closed and the
    program's state is freed, the reference decrypts each output handed in
    (``Driver.decrypted``), the traffic module's ``compare`` holds it to the
    reference's result, and ``decide`` judges the numbers."""
    import torch

    from portbench import fhe, work
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, cfg = loaded or load_cell(name)
    device = torch.device(device or 'cuda:0')
    cuda = device.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    mod = traffic(cell['op'])
    drv = mod.Driver(cfg, cell, seed, device)
    if patch is not None:
        patch(drv)
    spans = fhe.Spans(torch, device)
    fn = (lambda: drv.traced_step(spans)) if trace else drv.step
    for _ in range(2):                      # warm-up: every shape, every table
        fn()
        sync()
    spans.marks.clear()
    gc.collect()
    gc.freeze()                             # set-up's objects: no collection walks them again
    rec = {'cell': name, 'batch': drv.batch, 'setup_s': time.perf_counter() - t_start}
    steps, enq, win, first, last = window(fn, sync, seconds)
    rec.update(steps=len(steps), step_s=steps, host_s=enq, window_s=win)
    v = sorted(steps)
    print(json.dumps({'step_ms': {'steps': len(v), 'min': v[0] * 1e3,
                                  'median': v[len(v) // 2] * 1e3, 'max': v[-1] * 1e3,
                                  'mean': win / len(v) * 1e3}}), file=sys.stderr, flush=True)
    dev_info = {'platform': 'gpu' if cuda else 'cpu',
                'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
                'count': cell['chips'],
                'memory_peak_bytes': torch.cuda.max_memory_allocated(device) if cuda else 0}
    breakdown = None
    if trace:
        rec['spans'] = spans.ms()
        rec['work'] = drv.work()
        if cuda:
            rec['trace'] = profiled(torch, fn, sync)
            props = torch.cuda.get_device_properties(device)
            card = smi()
            rec['int_peak'] = work.int32_peak(props.multi_processor_count,
                                              card['max_sm_clock_mhz'] * 1e6)
            print(json.dumps({'peaks': {
                'bytes_per_s': work.PEAK_BYTES_S, 'int32_per_s': rec['int_peak'],
                'sm_count': props.multi_processor_count, **card}}), file=sys.stderr,
                flush=True)
            dev_info['busy_s'] = rec['trace']['busy_s']
            dev_info['window_s'] = rec['trace']['window_s']
            breakdown = {k: [[a, b] for a, b in v]
                         for k, v in rec['trace']['breakdown'].items()}
    same = torch.equal(first, last)
    outs = [last] if same else [first, last]
    del first, last
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    items = [it for out in outs for it in mod.compare(cfg, cell, seed, drv.decrypted(out))]
    del outs
    compared, failed, correct = decide(cell, items, same)
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        v = reader(m['name']).read(rec)
        if v is not None:
            metrics[m['name']] = {'value': v, 'unit': m['unit']}
    line = {'correct': bool(correct), 'attempted': drv.batch * rec['steps'],
            'failed': int(failed), 'metrics': metrics, 'device': dev_info}
    if breakdown is not None:
        line['breakdown'] = breakdown
    line['compared'] = compared
    return line, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)                # one host thread: the card does the work
    bench, cell, cfg = load_cell(args.workload)
    chips = cell['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: the cell needs {chips} CUDA card(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    line, compared = run(args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START, loaded=(bench, cell, cfg))
    found = sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f'portbench: the run loaded {found}', file=sys.stderr)
        return 3
    for k, v in compared.items():
        print(json.dumps({'compared': k, **v}), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
