"""The port's example runners (``lattisense_torch/examples/``) on the CPU.

Each runner's ``main(['--toy', '--cpu'])`` runs in process and its returned
values meet the oracle its JAX counterpart under ``examples/`` asserts
(``ckks_bootstrap`` both ways; ``multichip_sharding`` in one gloo world of 4
ranks at n=256). The four runners whose JAX example has a module-level
builder write the task directory that builder writes through the JAX
frontend (the JAX module imported by path, unedited), and the serialization
runner's client and server give the JAX example's bytes.
"""

import importlib
import importlib.util
import os
import random

import numpy as np
import pytest
import torch

from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.frontend import custom_task as jax_fe
from lattisense_tpu.params import CkksParams as RefCkksParams

from lattisense_torch.examples import _common
from lattisense_torch.params import CkksParams

from .test_torch_frontend import files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2718


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    """One torch intra-op thread, as ``tests/test_torch_task.py``."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def runner(name):
    return importlib.import_module(f'lattisense_torch.examples.{name}')


def close(got, want, tol):
    return np.max(np.abs(np.asarray(got, dtype=float) - np.asarray(want, dtype=float))) < tol


# runner, extra flags → a check of main's values against the JAX example's oracle
RUNS = {
    'bfv_mult': ([], lambda r: (r['z'] == 15).all()),
    'ckks_mult': ([], lambda r: close(r['zr'], [10.0, 30.0], 1e-2)),
    'project_template': ([], lambda r: np.array_equal(r['z'], r['expected'])),
    'ckks_logistic_regression': ([], lambda r: abs(r['score'] - r['expected']) < 1e-2),
    'ckks_euclidean_distance': ([], lambda r: close(r['distance'], r['expected'], 1e-2)),
    'bfv_poly_7': ([], lambda r: np.array_equal(r['y'], r['expected'])),
    'benchmark_convolution': ([], lambda r: close(r['y'], r['expected'], 1e-2)),
    'ckks_mult_serialization': ([], lambda r: close(r['z'], [10.0, 30.0], 1e-2)),
    'ckks_bootstrap': ([], lambda r: r['err'] < 5e-3 and r['err_sq'] < 5e-2
                       and r['input_level'] == 0),
    'ckks_bootstrap_w32': (['--w32'], lambda r: r['err'] < 5e-3 and r['err_sq'] < 5e-2
                           and r['input_level'] == 1 and r['word_bits'] == 32),
    'benchmark': ([], lambda r: all(v['equal_to_single'] and v['correct']
                                    and v['ops_per_s'] > 0 for v in r.values())),
    'multichip_sharding': ([], lambda r: r['n'] == 256 and r['world'] == 4
                           and all(r['sections'].values()) and len(r['sections']) == 6),
}


@pytest.mark.parametrize('name', list(RUNS))
def test_runner_meets_its_oracle(name, capsys):
    flags, check = RUNS[name]
    mod = runner(name.removesuffix('_w32'))
    got = mod.main(['--toy', '--cpu'] + flags)
    assert check(got)
    assert capsys.readouterr().out.rstrip().endswith('OK')


def test_toy_keeps_the_card_and_cpu_is_explicit():
    args = _common.example_args('x', ['--toy', '--cpu'])
    assert args.n == 64 and args.device == torch.device('cpu')
    assert _common.example_args('x', ['--cpu']).n == 16384
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            _common.example_args('x', ['--toy'])


def jax_example(name, sub=None):
    """The JAX example module, imported by path (it puts ``examples/`` on
    ``sys.path`` for its ``_common``)."""
    path = os.path.join(ROOT, 'examples', sub or name, f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'jax_example_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ckks_fe(mod, n):
    big = gen_ntt_primes(n, 60, 2)
    q, p = [big[0]] + gen_ntt_primes(n, 40, 4), [big[1]]
    return mod.CkksParam.create_custom_param(n=n, q=q, p=p, scale=float(1 << 40))


def bfv_fe(mod, n):
    q = gen_ntt_primes(n, 50, 5)
    p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    return mod.BfvParam.create_custom_param(n=n, q=q, p=p, t=65537)


def jax_logistic(ex, d):
    x, w, b, mask, y = ex.build(jax_fe, 30, 3)
    jax_fe.process_custom_task(
        [jax_fe.Argument('x', x), jax_fe.Argument('w', w), jax_fe.Argument('b', b),
         jax_fe.Argument('mask', mask)], [jax_fe.Argument('y', y)], output_instruction_path=d)


def jax_distance(ex, d):
    x, w, mask, distance = ex.build(jax_fe, 4, 512 // 8)
    jax_fe.process_custom_task(
        [jax_fe.Argument('x_input', x), jax_fe.Argument('w_input_inv', w),
         jax_fe.Argument('mask', mask)], [jax_fe.Argument('d', distance)],
        output_instruction_path=d)


def jax_poly7(ex, d):
    x, a0, a, y = ex.build(jax_fe)
    jax_fe.process_custom_task(
        [jax_fe.Argument('x', x), jax_fe.Argument('a0', a0), jax_fe.Argument('a', a)],
        [jax_fe.Argument('y', y)], output_instruction_path=d)


def jax_conv(ex, d):
    (h, w), kernel, pack = (32, 32), (3, 3), 4
    layer = ex.Conv2DPackedLayer(jax_fe, pack, (h, w), kernel, pack)
    x = jax_fe.CkksCiphertextNode('x', 2)
    weight_pt = [[jax_fe.CkksPlaintextNode(f'w_{c}_{k}', 2) for k in range(9)]
                 for c in range(pack)]
    bias_pt = jax_fe.CkksPlaintextNode('b', 1)
    y = layer.build(x, weight_pt, bias_pt)
    jax_fe.process_custom_task(
        [jax_fe.Argument('x', x), jax_fe.Argument('w', weight_pt),
         jax_fe.Argument('b', bias_pt)], [jax_fe.Argument('y', y)], output_instruction_path=d)


# runner → (the JAX main's call of its builder, the port's compile_task arguments
# after (fe, dir), the frontend parameter), at the JAX main's sizes for n=1024
# (512 slots)
BUILDERS = {
    'ckks_logistic_regression': (jax_logistic, (30,), ckks_fe),
    'ckks_euclidean_distance': (jax_distance, (4, 512 // 8), ckks_fe),
    'bfv_poly_7': (jax_poly7, (), bfv_fe),
    'benchmark_convolution': (jax_conv, ((32, 32), (3, 3), 4), ckks_fe),
}


@pytest.mark.parametrize('name', list(BUILDERS))
def test_runner_task_equals_the_jax_builder(name, tmp_path):
    write_jax, args, fe = BUILDERS[name]
    ex = jax_example(name)
    n = 1024
    random.seed(SEED)
    jax_fe.set_fhe_param(fe(jax_fe, n))
    write_jax(ex, str(tmp_path / 'jax'))
    from lattisense_torch.frontend import custom_task as port_fe
    random.seed(SEED)
    runner(name).compile_task(fe(port_fe, n), str(tmp_path / 'port'), *args)
    assert files(str(tmp_path / 'port')) == files(str(tmp_path / 'jax'))


def test_serialization_gives_the_jax_bytes():
    """At n=64: the public context, both ciphertexts (contexts of one seed
    draw the same randomness) and the server's result."""
    ex = jax_example('ckks_mult_serialization')
    port = runner('ckks_mult_serialization')
    big = gen_ntt_primes(64, 60, 2)
    q, p = [big[0]] + gen_ntt_primes(64, 40, 4), [big[1]]
    ref_params = RefCkksParams.create_custom(64, q, p, scale=float(1 << 40))
    port_params = CkksParams.create_custom(64, q, p, scale=float(1 << 40))
    _, *want = ex.client_phase_0(ref_params, 3)
    _, *got = port.client_phase_0(port_params, 3, 'cpu')
    assert got == want
    assert port.server_phase_1(*got, device='cpu') == ex.server_phase_1(*want)
