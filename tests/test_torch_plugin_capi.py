"""lattisense_torch's C ABI shim held against lattisense_tpu's.

The port's shim (``lattisense_torch/csrc/plugin/``) and the repository's
client ``csrc/plugin_client.cpp`` are built with g++ into a temporary
directory, as are the JAX package's shim and the same client; each client
runs the task of ``tests/test_plugin.py`` on the same fixture files, the
port's on the CPU (``LATTISENSE_PLUGIN_PLATFORM=cpu``), and writes the same
output ciphertext, byte for byte, after passing the signature-error checks.
The port's fixture writer writes the bytes of ``tools/plugin_fixture.py``,
its header declares the reference header's C interface, and the Python
half of the boundary (``plugin/capi.py``) runs in-process as the JAX one.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from lattisense_tpu import abi as rabi
from lattisense_tpu.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_tpu.frontend import custom_task as ctk
from lattisense_tpu.frontend.custom_task import BfvParam
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.plugin import capi as rcapi
from lattisense_tpu.runtime import BfvContext as RefBfvContext
from lattisense_tpu.schemes.types import Ciphertext as RefCiphertext

from lattisense_torch import abi
from lattisense_torch.core.modring import get_rns_ring as port_ring
from lattisense_torch.ops import plugin_build
from lattisense_torch.params import BfvParams
from lattisense_torch.plugin import capi
from lattisense_torch.plugin import fixture as pfx
from lattisense_torch.runtime import BfvContext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools import plugin_fixture as fx  # noqa: E402

N, T, LEVEL = 64, 65537, 2


def chain():
    q = gen_ntt_primes(N, 50, 4)
    return q, gen_ntt_primes(N, 51, 2, exclude=tuple(q))


def compile_task(path, rotate: bool):
    q, p = chain()
    ctk.set_fhe_param(BfvParam.create_custom_param(N, list(q), list(p), T))
    x, y = ctk.BfvCiphertextNode('x', LEVEL), ctk.BfvCiphertextNode('y', LEVEL)
    z = ctk.mult_relin(x, y, 'z')
    out = ctk.Argument('w', ctk.rotate_cols(z, 1, 'w')) if rotate else ctk.Argument('z', z)
    ctk.process_custom_task([ctk.Argument('x', x), ctk.Argument('y', y)], [out],
                            output_instruction_path=str(path))
    return str(path)


def build_reference_shim(out_dir):
    """The JAX package's shim and the client, as ``csrc/Makefile`` builds
    them, into ``out_dir`` (not ``csrc/``, which its own test builds)."""
    includes, ldflags = plugin_build.python_flags()
    os.makedirs(out_dir, exist_ok=True)
    for f in ('lattisense_plugin.h', 'plugin_client.cpp'):
        shutil.copy(os.path.join(ROOT, 'csrc', f), out_dir)
    lib = os.path.join(out_dir, 'liblattisense_plugin.so')
    client = os.path.join(out_dir, 'plugin_client')
    for cmd in (['g++', '-O2', '-fPIC', '-shared', '-std=c++17', *includes, '-o', lib,
                 os.path.join(ROOT, 'csrc', 'lattisense_plugin.cpp'), *ldflags],
                ['g++', '-O2', '-std=c++17', '-o', client,
                 os.path.join(out_dir, 'plugin_client.cpp'), f'-L{out_dir}', '-llattisense_plugin',
                 '-Wl,-rpath,$ORIGIN', *ldflags]):
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
    return client


@pytest.fixture(scope='module')
def built(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('no g++ toolchain')
    root = tmp_path_factory.mktemp('plugin_build')
    _, port_client = plugin_build.build(str(root / 'port'))
    return port_client, build_reference_shim(str(root / 'jax'))


def test_header_declares_the_reference_interface():
    def decls(path):
        with open(path) as f:
            text = re.sub(r'/\*.*?\*/', '', f.read(), flags=re.S)
        return [line.strip() for line in text.splitlines() if line.strip()]
    assert decls(plugin_build.HEADER) == decls(os.path.join(ROOT, 'csrc', 'lattisense_plugin.h'))
    with open(plugin_build.SHIM) as f:
        src = f.read()
    assert 'PyImport_ImportModule("lattisense_torch.plugin.capi")' in src
    assert 'lattisense_tpu' not in src


def test_plugin_platform_picks_the_device(monkeypatch):
    for value, want in (('cpu', 'cpu'), ('CPU', 'cpu'), ('cuda', None), ('', None)):
        monkeypatch.setenv('LATTISENSE_PLUGIN_PLATFORM', value)
        assert capi.plugin_device() == want
    monkeypatch.delenv('LATTISENSE_PLUGIN_PLATFORM')
    assert capi.plugin_device() is None
    monkeypatch.setenv('LATTISENSE_PLUGIN_PLATFORM', 'tpu')
    with pytest.raises(ValueError, match='LATTISENSE_PLUGIN_PLATFORM'):
        capi.plugin_device()


def test_fixture_files_match_reference_writer(tmp_path):
    """The port's fixture writer, fed the port's tensors, writes the bytes
    of ``tools/plugin_fixture.py`` fed the JAX package's arrays."""
    q, p = chain()
    ref = RefBfvContext.create_random_context(RefBfvParams.create_custom(N, T, q, p), seed=91)
    port = BfvContext.create_random_context(BfvParams.create_custom(N, T, q, p), seed=91,
                                            device='cpu')
    for c in (ref, port):
        c.gen_rotation_keys_for_rotations([1])
    m = np.arange(N) % T
    ct_r = ref.encrypt(ref.encode(m, LEVEL))
    ct_p = pfx.read_ct(_write(fx.write_ct, tmp_path / 'r.ct', ct_r), device='cpu')
    qp = tuple(q) + tuple(p)
    rr, pr = get_rns_ring(qp, N), port_ring(qp, N, 'cpu', 64)
    pairs = [(fx.write_ct, ct_r, pfx.write_ct, ct_p),
             (lambda f, k: fx.write_ksk(f, k, rr), ref.rlk, lambda f, k: pfx.write_ksk(f, k, pr),
              port.rlk),
             (lambda f, k: fx.write_glk(f, k, rr), ref.glk.keys,
              lambda f, k: pfx.write_glk(f, k, pr), port.glk.keys)]
    for i, (wr, vr, wp, vp) in enumerate(pairs):
        a, b = _write(wr, tmp_path / f'a{i}', vr), _write(wp, tmp_path / f'b{i}', vp)
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read()


def _write(writer, path, value):
    writer(str(path), value)
    return str(path)


def test_client_output_matches_reference_shim(built, tmp_path):
    port_client, ref_client = built
    q, p = chain()
    task_dir = compile_task(tmp_path / 'task', rotate=True)
    ctx = RefBfvContext.create_random_context(RefBfvParams.create_custom(N, T, q, p), seed=91)
    ctx.gen_rotation_keys_for_rotations([1])
    rng = np.random.default_rng(7)
    m1, m2 = (rng.integers(0, T, N, dtype=np.uint64) for _ in range(2))
    fix = tmp_path / 'fixtures'
    fix.mkdir()
    fx.write_ct(str(fix / 'x.ct'), ctx.encrypt(ctx.encode(m1, LEVEL)))
    fx.write_ct(str(fix / 'y.ct'), ctx.encrypt(ctx.encode(m2, LEVEL)))
    fx.write_ct(str(fix / 'x_badlevel.ct'), ctx.encrypt(ctx.encode(m1, LEVEL - 1)))
    ring = get_rns_ring(tuple(q) + tuple(p), N)
    fx.write_ksk(str(fix / 'rlk.key'), ctx.rlk, ring)
    fx.write_glk(str(fix / 'glk.key'), ctx.glk.keys, ring)

    outs = {}
    for name, client in (('port', port_client), ('jax', ref_client)):
        env = plugin_build.client_env('cpu')
        env['JAX_PLATFORMS'] = 'cpu'
        out = tmp_path / f'w_{name}.ct'
        r = subprocess.run([client, task_dir, str(fix), str(out)], capture_output=True,
                           text=True, env=env, timeout=600)
        assert r.returncode == 0, f'{name} client rc={r.returncode}\n{r.stdout}\n{r.stderr}'
        for line in ('negative wrong-level: OK', 'negative swapped-id: OK', 'CLIENT OK'):
            assert line in r.stdout
        with open(out, 'rb') as f:
            outs[name] = f.read()
    assert outs['port'] == outs['jax']
    got = ctx.decrypt_decode(fx.read_ct(str(tmp_path / 'w_port.ct')))
    prod = (m1 * m2) % T
    np.testing.assert_array_equal(got, np.roll(prod.reshape(2, -1), -1, axis=1).reshape(-1))


def test_capi_registry_matches_reference(tmp_path, monkeypatch):
    """The Python half in-process: create / run / release through
    pointer-level marshaling, the port on the CPU against the JAX module."""
    monkeypatch.setenv('LATTISENSE_PLUGIN_PLATFORM', 'cpu')
    q, p = chain()
    task_dir = compile_task(tmp_path / 'task', rotate=False)
    ctx = RefBfvContext.create_random_context(RefBfvParams.create_custom(N, T, q, p), seed=92)
    rng = np.random.default_rng(8)
    m1, m2 = (rng.integers(0, T, N, dtype=np.uint64) for _ in range(2))
    a = rabi.export_ciphertext(ctx.encrypt(ctx.encode(m1, LEVEL)))
    b = rabi.export_ciphertext(ctx.encrypt(ctx.encode(m2, LEVEL)))
    rlk = rabi.export_keyswitch_key(ctx.rlk, 0, get_rns_ring(tuple(q) + tuple(p), N))
    rows_in = [('x', capi.TYPE_CIPHERTEXT, [ctypes.addressof(a.struct)], LEVEL),
               ('y', capi.TYPE_CIPHERTEXT, [ctypes.addressof(b.struct)], LEVEL),
               ('rlk', capi.TYPE_RELIN_KEY, [ctypes.addressof(rlk.struct)], 0)]
    datas = []
    for mod, cls in ((capi, abi.CCiphertext), (rcapi, rabi.CCiphertext)):
        tid = mod.create_task(task_dir)
        (addr, size, level), = mod.run_task(tid, rows_in, ['z'], 0)
        assert size == 1 and level == LEVEL
        elem = ctypes.cast(addr, ctypes.POINTER(ctypes.c_void_p))[0]
        w = ctypes.cast(elem, ctypes.POINTER(cls)).contents
        datas.append(np.asarray(rabi.import_ciphertext(
            rabi.CCiphertext.from_address(ctypes.addressof(w))).data))
        assert mod.release_task(tid) == 0
    np.testing.assert_array_equal(datas[0], datas[1])
    np.testing.assert_array_equal(
        ctx.decrypt_decode(RefCiphertext(data=datas[0], level=LEVEL)), (m1 * m2) % T)
