"""The benchmark's own tests (``python -m pytest portbench/tests``): CPU
tests at toy sizes, and card tests marked ``card`` that skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA card; skips without one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    """One torch thread: the toy runs are many small ops."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def toy(name: str, n: int = 1024, batch: int = 2):
    """Cell ``name`` as the harness loads it, cut to ring degree ``n`` (the
    chains' primes stay NTT-friendly there) and ``batch`` ciphertexts."""
    from portbench import run as harness
    bench, cell, cfg = harness.load_cell(name)
    cfg = dict(cfg, n=n)
    if 'slots' in cfg:
        cfg['slots'] = n // 2
    cell = dict(cell, batch=min(batch, cell['batch']))
    return bench, cell, cfg
