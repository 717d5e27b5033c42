"""lattisense_torch stands alone: it imports neither JAX nor lattisense_tpu,
keeps its own copy of the parameter table, and its entry points run on the
card unless asked for the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'lattisense_torch')
_IMPORT = re.compile(r'^\s*(?:import|from)\s+(jax|lattisense_tpu)\b', re.M)


def test_import_pulls_in_no_jax():
    code = ("import lattisense_torch, lattisense_torch.runtime, lattisense_torch.parallel.batch, "
            "lattisense_torch.ops.ntt64_cuda, lattisense_torch.ops.bconv_cuda, "
            "lattisense_torch.ops.ksw64_cuda, lattisense_torch.tools.profile_step, "
            "lattisense_torch.runtime.task, lattisense_torch.runtime.check_sig, "
            "lattisense_torch.runtime.tasks, lattisense_torch.params, "
            "lattisense_torch.utils.security, lattisense_torch.schemes.ckks, "
            "lattisense_torch.utils.precision, lattisense_torch.utils.serialize, "
            "lattisense_torch.schemes.multiparty, lattisense_torch.abi, lattisense_torch.plugin, "
            "lattisense_torch.plugin.capi, lattisense_torch.plugin.fixture, "
            "lattisense_torch.utils.observability, lattisense_torch.ops.plugin_build, "
            "lattisense_torch.ops.ntt_mxu, lattisense_torch.parallel.mesh, "
            "lattisense_torch.parallel.launch, lattisense_torch.parallel.keyswitch_sharded, "
            "lattisense_torch.parallel.coeff_sharded, lattisense_torch.parallel.sharded_engine, "
            "lattisense_torch.parallel.limb_engine, lattisense_torch.frontend.custom_task, "
            "lattisense_torch.frontend.graph, lattisense_torch.models, "
            "lattisense_torch.examples._common, tests.torch_mesh_ranks, "
            "sys; mods = list(sys.modules); "
            "assert 'jax' not in mods, 'jax'; "
            "assert not any(m.startswith('lattisense_tpu') for m in mods), 'lattisense_tpu'")
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_no_jax():
    files = [os.path.join(ROOT, 'chip_smoke.py'), os.path.join(ROOT, 'tests', 'torch_mesh_ranks.py')]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, f) for f in names if f.endswith('.py')]
    assert len(files) > 15
    for new in ('ops/ntt64_cuda.py', 'ops/bconv_cuda.py', 'ops/ksw64_cuda.py', 'runtime/task.py',
                'runtime/check_sig.py', 'runtime/tasks/__init__.py', 'utils/security.py',
                'schemes/ckks.py', 'utils/precision.py', 'utils/serialize.py',
                'schemes/multiparty.py', 'abi.py', 'plugin/__init__.py', 'plugin/foreign_task.py',
                'plugin/capi.py', 'plugin/fixture.py', 'utils/observability.py',
                'ops/plugin_build.py', 'ops/ntt_mxu.py', 'parallel/mesh.py', 'parallel/launch.py',
                'parallel/keyswitch_sharded.py', 'parallel/coeff_sharded.py',
                'parallel/sharded_engine.py', 'parallel/limb_engine.py', 'frontend/__init__.py',
                'frontend/graph.py', 'frontend/custom_task.py', 'models/__init__.py',
                'models/_base.py', 'models/logistic.py', 'models/distance.py',
                'models/polynomial.py', 'models/convolution.py', 'models/matvec.py',
                'examples/__init__.py', 'examples/_common.py', 'examples/bfv_mult.py',
                'examples/ckks_mult.py', 'examples/project_template.py',
                'examples/ckks_logistic_regression.py', 'examples/ckks_euclidean_distance.py',
                'examples/bfv_poly_7.py', 'examples/benchmark_convolution.py',
                'examples/ckks_mult_serialization.py', 'examples/ckks_bootstrap.py',
                'examples/benchmark.py', 'examples/multichip_sharding.py'):
        assert os.path.join(PORT, new) in files, new
    offenders = []
    for path in files:
        with open(path, encoding='utf-8') as f:
            if _IMPORT.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert offenders == []
    # the C ABI shim's embedded interpreter imports the port's capi only
    shim_dir = os.path.join(PORT, 'csrc', 'plugin')
    for name in os.listdir(shim_dir):
        with open(os.path.join(shim_dir, name), encoding='utf-8') as f:
            text = f.read()
        assert 'lattisense_tpu' not in text and 'jax' not in text.lower(), name


def test_parameter_table_is_a_byte_identical_copy():
    with open(os.path.join(ROOT, 'lattisense_tpu', 'parameter.json'), 'rb') as f:
        ref = f.read()
    with open(os.path.join(PORT, 'parameter.json'), 'rb') as f:
        assert f.read() == ref


def test_entry_points_default_to_cuda(monkeypatch):
    from lattisense_torch import resolve_device
    from lattisense_torch.core.modring import gen_ntt_primes
    from lattisense_torch.params import BfvParams
    from lattisense_torch.runtime import BfvContext
    from lattisense_torch.schemes.bfv import BfvEngine
    if torch.cuda.is_available():
        assert resolve_device().type == 'cuda'
        return
    chain = gen_ntt_primes(64, 31, 3)
    params = BfvParams.create_custom(64, 257, chain[:2], chain[2:], word_bits=32)
    from lattisense_torch.plugin import ForeignTask, capi
    from lattisense_torch.runtime import tasks
    from lattisense_torch.schemes import multiparty as mp
    monkeypatch.delenv('LATTISENSE_PLUGIN_PLATFORM', raising=False)
    from lattisense_torch.parallel.launch import run_ranks
    from lattisense_torch.parallel.mesh import make_mesh
    for entry in (lambda: make_mesh(op=1), lambda: run_ranks(1, print),
                  lambda: BfvContext.create_random_context(params, seed=1),
                  lambda: BfvContext(params),
                  lambda: BfvEngine(params),
                  lambda: mp.DBfvParty(params, seed=1),
                  lambda: mp.CkgProtocol(params, 7),
                  lambda: mp.RkgProtocol(params, 7),
                  lambda: ForeignTask(tasks.task_dir(tasks.MULT_ROTATE)),
                  lambda: capi.create_task(tasks.task_dir(tasks.MULT_ROTATE))):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            entry()
    assert BfvEngine(params, 'cpu').device == torch.device('cpu')
