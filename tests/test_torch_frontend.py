"""The port's frontend (``lattisense_torch/frontend/``) byte for byte against
the JAX package's (``lattisense_tpu/frontend/``): for the same graph and the
same ``random.seed`` both write the same ``mega_ag.json`` and
``task_signature.json``. The graphs: every builder of
``tests/test_frontend_parity.py``, the random BFV and CKKS programs of
``tests/test_fuzz_graph.py`` (its generators run on each module in turn),
and the graphs of the committed task directories
(``tests/test_torch_task.py`` ``committed_fixtures``), whose regeneration by
the port's frontend equals the committed files after the id mapping. Every
comparison is exact."""

import os
import random

import numpy as np
import pytest

from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.frontend import custom_task as jax_fe

from lattisense_torch.frontend import custom_task as port_fe

from . import test_frontend_parity as parity
from . import test_fuzz_graph as fuzz
from . import test_torch_task as task_tests

FILES = ('mega_ag.json', 'task_signature.json')
SEED = 1234


def files(path):
    out = {}
    for name in FILES:
        with open(os.path.join(path, name), 'rb') as f:
            out[name] = f.read()
    return out


def both(tmp_path, write):
    """write(module, path) under the same random.seed for each frontend; →
    the two directories' bytes."""
    got = []
    for name, mod in (('jax', jax_fe), ('port', port_fe)):
        path = tmp_path / name
        path.mkdir()
        random.seed(SEED)
        write(mod, str(path))
        got.append(files(str(path)))
    return got


@pytest.mark.parametrize('build', parity.BUILDERS, ids=lambda b: b.__name__)
def test_parity_builders(tmp_path, build):
    def write(mod, path):
        ins, outs = build(mod)
        mod.process_custom_task(input_args=ins, output_args=outs, output_instruction_path=path,
                                fpga_acc=False)
    want, got = both(tmp_path, write)
    assert got == want


def _fuzz_params(mod, kind):
    N = fuzz.N
    if kind == 'bfv':
        q = gen_ntt_primes(N, 50, 3)
        p = gen_ntt_primes(N, 51, 1, exclude=tuple(q))
        return mod.BfvParam.create_custom_param(n=N, q=q, p=p, t=fuzz.T)
    big = gen_ntt_primes(N, 60, 2)
    mids = gen_ntt_primes(N, 40, 3)
    return mod.CkksParam.create_custom_param(n=N, q=[big[0]] + mids, p=[big[1]],
                                             slots=fuzz.C_SLOTS, scale=float(1 << 40))


@pytest.mark.parametrize('kind,seed', [('bfv', s) for s in range(6)] +
                         [('ckks', s) for s in range(4)])
def test_fuzz_programs(tmp_path, monkeypatch, kind, seed):
    def write(mod, path):
        monkeypatch.setattr(fuzz, 'ct', mod)
        mod.set_fhe_param(_fuzz_params(mod, kind))
        if kind == 'bfv':
            fuzz._random_program(np.random.default_rng(1000 + seed), path)
        else:
            fuzz._random_ckks_program(np.random.default_rng(2000 + seed), path)
    want, got = both(tmp_path, write)
    assert got == want


@pytest.mark.parametrize('name', sorted(task_tests.committed_fixtures()))
def test_committed_task_graphs(tmp_path, monkeypatch, name):
    """Each committed directory's graph through both frontends, and the
    port's equal to the committed files after the id mapping."""
    from lattisense_torch.runtime import tasks

    def write(mod, path):
        monkeypatch.setattr(task_tests, 'ct', mod)
        fe, build, args = task_tests.committed_fixtures()[name]
        task_tests.gen_task(fe, build, path, *args)
    want, got = both(tmp_path, write)
    assert got == want
    monkeypatch.setattr(task_tests, 'ct', port_fe)
    out = tmp_path / 'fixture'
    out.mkdir()
    task_tests.write_fixture(name, str(out))
    assert files(str(out)) == files(tasks.task_dir(name))

