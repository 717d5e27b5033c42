"""Build the C ABI shim of the plug-in boundary and the reference client with g++.

The shim (``csrc/plugin/lattisense_plugin.cpp``, the port's copy of the
repository's ``csrc/lattisense_plugin.cpp`` that imports
``lattisense_torch.plugin.capi``) embeds CPython: it is compiled with the
flags of ``python3-config --includes`` and ``python3-config --ldflags
--embed`` into ``liblattisense_plugin.so``. The reference client
``csrc/plugin_client.cpp`` of the repository is compiled unchanged beside
the port's copy of the header and linked against that library, so the
foreign binary sees only the header and the library. Both land in
``build/plugin/<hash>/`` at the repository root (``.gitignore`` lists
``build/``), named by a hash of the sources and flags; nothing is built at
import, and a built pair is reused.
"""

import hashlib
import os
import shutil
import site
import subprocess
import sys
import sysconfig

PLUGIN_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          'csrc', 'plugin')
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(PLUGIN_SRC)))
SHIM = os.path.join(PLUGIN_SRC, 'lattisense_plugin.cpp')
HEADER = os.path.join(PLUGIN_SRC, 'lattisense_plugin.h')
CLIENT = os.path.join(ROOT, 'csrc', 'plugin_client.cpp')
BUILD_DIR = os.path.join(ROOT, 'build', 'plugin')


def python_header() -> str:
    """The running interpreter's ``Python.h`` (it may be absent)."""
    return os.path.join(sysconfig.get_paths()['include'], 'Python.h')


def _python_config() -> str:
    """``python3-config`` of the running interpreter's installation."""
    for d in (sysconfig.get_config_var('BINDIR'), os.path.dirname(sys.executable)):
        if d and os.path.isfile(os.path.join(d, 'python3-config')):
            return os.path.join(d, 'python3-config')
    found = shutil.which('python3-config')
    if found is None:
        raise RuntimeError('python3-config not found: the plug-in shim embeds CPython')
    return found


def python_flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) to embed CPython; each ``-L`` directory is
    also a run path, so the client finds libpython where the interpreter's
    installation keeps it."""
    cfg = _python_config()

    def run(*args):
        return subprocess.run([cfg, *args], capture_output=True, text=True, check=True,
                              timeout=60).stdout.split()
    includes, ldflags = run('--includes'), run('--ldflags', '--embed')
    rpaths = [f'-Wl,-rpath,{f[2:]}' for f in ldflags if f.startswith('-L')]
    return includes, ldflags + rpaths


def _compile(cmd: list[str], out: str):
    """Run one g++ into ``out``.tmp, then move it to ``out``."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f'plug-in build failed: {" ".join(cmd)}\n{proc.stderr}')
    os.replace(out + '.tmp', out)


def build(out_dir: str = BUILD_DIR) -> tuple[str, str]:
    """(the shim library, the client binary), built unless already there."""
    if shutil.which('g++') is None:
        raise RuntimeError('g++ not found: the plug-in shim is C++')
    if not os.path.exists(python_header()):
        raise RuntimeError(f'{python_header()} not found: the plug-in shim embeds CPython')
    includes, ldflags = python_flags()
    digest = hashlib.sha256(' '.join(includes + ldflags).encode())
    for path in (SHIM, HEADER, CLIENT):
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + b'\0' + f.read())
    d = os.path.join(out_dir, digest.hexdigest()[:16])
    lib, client = os.path.join(d, 'liblattisense_plugin.so'), os.path.join(d, 'plugin_client')
    if os.path.exists(lib) and os.path.exists(client):
        return lib, client
    os.makedirs(d, exist_ok=True)
    # the client's #include "lattisense_plugin.h" resolves beside it: the
    # port's copy of the header
    for path in (HEADER, CLIENT):
        shutil.copy(path, d)
    _compile(['g++', '-O2', '-fPIC', '-shared', '-std=c++17', *includes, '-o', lib + '.tmp',
              SHIM, *ldflags], lib)
    _compile(['g++', '-O2', '-std=c++17', '-o', client + '.tmp',
              os.path.join(d, 'plugin_client.cpp'), f'-L{d}', '-llattisense_plugin',
              '-Wl,-rpath,$ORIGIN', *ldflags], client)
    return lib, client


def client_env(platform: str | None = None) -> dict:
    """The environment of a client process: this repository and the running
    interpreter's site-packages on ``PYTHONPATH`` (the embedded interpreter
    imports ``lattisense_torch``, torch and numpy), and
    ``LATTISENSE_PLUGIN_PLATFORM`` when ``platform`` is given."""
    env = dict(os.environ)
    paths = [ROOT, *site.getsitepackages()]
    if env.get('PYTHONPATH'):
        paths.append(env['PYTHONPATH'])
    env['PYTHONPATH'] = os.pathsep.join(paths)
    if platform is not None:
        env['LATTISENSE_PLUGIN_PLATFORM'] = platform
    return env
