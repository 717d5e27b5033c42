"""Build the CUDA sources in ``csrc/`` with nvcc and load them through ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
-shared -Xcompiler -fPIC``) under ``build/kernels/`` at the repository root,
which ``.gitignore`` lists. The library's file name carries a hash of its
source, of every header it includes from ``csrc/`` (``#include "..."``,
followed recursively: B1 and B5 share ``ntt_passes.cuh``) and of the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. Nothing is built at import: the first launch builds what it
needs, and ``build_all`` builds every source at once, one nvcc each, all
started together.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

from ..utils import observability

SOURCES = ('ntt32', 'behz32', 'ksw32', 'ntt64', 'bconv64', 'ksw64', 'tensor')
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), 'build', 'kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_loaded: dict[str, ctypes.CDLL] = {}
#: libraries loaded through ctypes, and of them those built with nvcc first,
#: since the process started
kernels = {'kernels_loaded': 0, 'kernels_built': 0}
observability.register('cuda_build', kernels)


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and os.path.isfile(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> list[str]:
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes, directly
    or through another header, in the order first met."""
    paths, todo = [], [os.path.join(CSRC, name + '.cu')]
    while todo:
        path = todo.pop(0)
        if path in paths:
            continue
        paths.append(path)
        with open(path, 'rb') as f:
            todo += [os.path.join(os.path.dirname(path), inc.decode())
                     for inc in _INCLUDE.findall(f.read())]
    return paths


def library_path(name: str) -> str:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sources_of(name):
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + b'\0' + f.read())
    return os.path.join(BUILD_DIR, f'lib{name}-{digest.hexdigest()[:16]}.so')


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, in parallel.

    Returns each name's ptxas report (registers, shared memory, spills);
    raises with nvcc's output if any compile fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC, name + '.cu')]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
    if failed:
        raise RuntimeError('CUDA build failed:\n' + '\n'.join(failed))
    return reports


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Load (building first if needed) library ``name`` and declare each
    function of ``signatures`` (name -> argtypes) with an int return."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build_all((name,))
            kernels['kernels_built'] += 1
        lib = ctypes.CDLL(path)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
        kernels['kernels_loaded'] += 1
    return lib
