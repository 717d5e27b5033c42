"""``BENCHMARK.json`` and the files the harness finds by name: allowed
characters, metrics that move reported metrics, one file a configuration,
cell, traffic driver and metric, a new cell taken without an edit, and the
isolation of the harness from the JAX package."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import run as harness

ROOT = harness.ROOT
PB = harness.HERE
BENCH = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'}
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


def test_top_level_and_entry_keys():
    assert set(BENCH) == KEYS
    assert BENCH['command'] == ['python3', 'portbench/run.py'] and BENCH['paths'] == ['portbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'} and w['chips'] == 1
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert m['source'] in ('host_clock', 'device_trace') and 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [x['name'] for x in BENCH['configs'] + BENCH['workloads'] + METRICS]
    assert len(names) == len(set(names))
    for x in names + [w['config'] for w in BENCH['workloads']] + [
            w['traffic'] for w in BENCH['workloads']] + [
            k for c in BENCH['configs'] for k in c['reduced']]:
        assert NAME.match(x), x
    for m in METRICS:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
    for x in [w['why'] for w in BENCH['workloads']] + [c['source'] for c in BENCH['configs']] + [
            m['layer'] for m in BENCH['per_layer']] + BENCH['command']:
        assert 1 <= len(x) <= 200 and '\n' not in x and '\t' not in x


def reported(cell: str) -> set:
    return {m['name'] for m in BENCH['end_to_end'] if cell in m.get('workloads', [cell])}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH['workloads']:
        e2e = reported(w['name'])
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, w['name'], True)


def test_moves_is_reported_in_each_cell_of_the_metric():
    e2e = {m['name'] for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e and m['moves'] != 'setup_s'
        for cell in m['workloads']:
            assert m['moves'] in reported(cell), (m['name'], cell)
    layers = {m['layer'] for m in BENCH['per_layer']}
    assert layers == {'entry', 'scheme', 'kernels', 'device'}


def test_shares_are_named_as_rooflines_or_mfu():
    for m in BENCH['per_layer']:
        if m['unit'] == '%' and 'idle' not in m['name']:
            assert m['name'].split('.')[0].endswith('_roofline') or 'mfu' in m['name']


def test_each_piece_is_found_by_name():
    for c in BENCH['configs']:
        cfg = json.load(open(os.path.join(ROOT, c['file'])))
        assert c['file'] == f"portbench/configs/{c['name']}.json" and cfg['name'] == c['name']
        assert cfg['source'] == c['source'] and cfg['reduced'] == c['reduced']
    for w in BENCH['workloads']:
        bench, cell, cfg = harness.load_cell(w['name'])
        assert cell['name'] == w['name'] and cell['config'] == w['config'] == cfg['name']
        assert cell['traffic'] == w['traffic'] and cell['chips'] == w['chips']
        assert cell['why'] == w['why']
        assert os.path.isfile(os.path.join(PB, 'traffic', cell['op'] + '.py'))
    for m in METRICS:
        assert callable(harness.reader(m['name']).read)


def test_configs_are_what_the_program_names():
    from lattisense_torch.params import BfvParams
    from lattisense_torch.schemes.bootstrap_params import BTP_P, BTP_Q, full_profile
    bfv = json.load(open(os.path.join(PB, 'configs', 'bfv_w32_n16k.json')))
    p = BfvParams.create_tpu_param(16384)
    assert (bfv['n'], bfv['t'], bfv['q'], bfv['p'], bfv['word_bits']) == (
        p.n, p.t, list(p.q), list(p.p), 32)
    ckks = json.load(open(os.path.join(PB, 'configs', 'ckks_btp_n64k.json')))
    prof = full_profile()
    assert (ckks['q'], ckks['p'], ckks['n'], ckks['slots'], ckks['scale']) == (
        list(BTP_Q), list(BTP_P), prof.n, prof.slots, prof.scale)
    em = prof.eval_mod_params
    assert ckks['bootstrap'] == {
        'cts_depth': prof.cts_params.depth(), 'stc_depth': prof.stc_params.depth(), 'k': em.k,
        'sine_deg': em.sine_deg, 'double_angle': em.double_angle, 'bsgs_ratio': 2.0,
        'em_scale': float(em.scaling_factor), 'message_ratio': em.message_ratio}
    assert ckks['bootstrap_output_level'] == prof.btp_output_level
    assert (ckks['secret_weight'], ckks['bootstrap_secret_weight']) == (192, 32)


def test_aux_limbs_are_the_programs_behz_rows():
    from lattisense_torch.params import BfvParams
    from lattisense_torch.schemes.bfv import BfvEngine
    _, cell, cfg = harness.load_cell('bfv_w32_mult_relin_b32')
    p = BfvParams(cfg['n'], cfg['t'], cfg['q'], cfg['p'], word_bits=32)
    bz = BfvEngine(p, 'cpu').behz(cell['level'])
    assert len(bz.ring_aux.moduli) == cell['aux_limbs']


def test_a_new_cell_is_taken_without_an_edit(tmp_path):
    """A copy of the benchmark gains a cell (its file and its entry) and a
    metric (its reader and its entry); the copied harness loads both and
    runs the cell at a toy size on the CPU."""
    shutil.copytree(PB, tmp_path / 'portbench', ignore=shutil.ignore_patterns('__pycache__'))
    bench = json.loads(json.dumps(BENCH))
    cell = json.load(open(os.path.join(PB, 'workloads', 'bfv_w32_mult_relin_b32.json')))
    cell.update(name='bfv_w32_mult_relin_b8', traffic='mult_relin.b8.l3', batch=8, level=3,
                aux_limbs=7)
    (tmp_path / 'portbench' / 'workloads' / 'bfv_w32_mult_relin_b8.json').write_text(
        json.dumps(cell))
    (tmp_path / 'portbench' / 'metrics' / 'steps.py').write_text(
        'def read(rec):\n    return rec["steps"]\n')
    bench['workloads'].append({k: cell[k] for k in ('name', 'config', 'traffic', 'chips', 'why')})
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'bfv_w32_mult_relin_b32' in m.get('workloads', []):
            m['workloads'].append(cell['name'])
    bench['per_layer'].append({'name': 'steps', 'unit': 'steps', 'better': 'higher',
                               'source': 'host_clock', 'layer': 'entry', 'moves': 'ops_per_s.bfv',
                               'workloads': [cell['name']]})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    copy = harness.load_module(str(tmp_path / 'portbench' / 'run.py'), 'portbench_copy_run')
    b, c, cfg = copy.load_cell('bfv_w32_mult_relin_b8', str(tmp_path))
    assert c['batch'] == 8 and cfg['name'] == 'bfv_w32_n16k'
    assert [m['name'] for m in copy.cell_metrics(b, c['name'], True)] == [
        m['name'] for m in harness.cell_metrics(BENCH, 'bfv_w32_mult_relin_b32', True)] + ['steps']
    c = dict(c, batch=2)
    for trace in (False, True):
        line, _ = copy.run(c['name'], 5, 0.01, trace, device='cpu',
                           loaded=(b, c, dict(cfg, n=512)))
        assert line['correct'] and line['attempted'] >= 2
    assert line['metrics']['steps']['value'] >= 1


def test_without_the_program_or_a_card_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the command
    exits non-zero and prints no result."""
    shutil.copytree(PB, tmp_path / 'portbench', ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    p = subprocess.run([sys.executable, 'portbench/run.py', '--workload', 'bfv_w32_rotate_b32',
                        '--seed', str(2 ** 33 + 1), '--seconds', '1', '--trace', '0'],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ''


def python_files():
    for d, _, files in os.walk(PB):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def imported(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split('.')[0])
    return out


def test_nothing_imports_the_jax_package():
    for path in python_files():
        assert not imported(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(PB, 'reference')
    for f in os.listdir(ref):
        if f.endswith('.py'):
            assert imported(os.path.join(ref, f)) <= {'functools', 'numpy', 'torch'}, f


def strings(path: str) -> list[str]:
    """The string constants of a module, its docstrings left out."""
    tree = ast.parse(open(path).read())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_the_harness_reads_no_file_of_the_jax_benchmarks():
    for path in python_files():
        if os.sep + 'tests' + os.sep in path:
            continue
        for text in strings(path):
            for name in ('chip_smoke', 'bench.py', 'benchmarks/', 'BENCH_r', 'BASELINE'):
                assert name not in text, (path, name)


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, 'portbench/run.py', '--workload', 'bfv_w32_rotate_b32',
                        '--seed', str(2 ** 33 + 7), '--seconds', '2', '--trace', '0'],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['device']['platform'] == 'gpu'
    assert list(line)[-1] == 'compared'
