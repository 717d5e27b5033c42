"""The port's model zoo (``lattisense_torch/models/``) held against the JAX
package's (``lattisense_tpu/models/``) at n=256, for each model: logistic
regression, Euclidean distance, conv2d, the BFV polynomial of degree 3 and 7,
the dense and the banded matrix–vector product, and the matrix–vector
product on the 32-bit word.

(a) ``compile()`` writes the JAX model's bytes under one ``random.seed``.
(b) ``load(ctx, mode=m)`` on the CPU, m in {eager, jit}, draws the JAX
model's Galois keys on a context of the same seed and gives output data equal
bit for bit to the JAX model's ``load(ref_ctx, mode='eager')`` run (its NumPy
interpreter), on inputs packed by the JAX context and carried across.
(c) The decoded output is within the JAX test's tolerance of the numpy
oracle (``tests/test_models.py``).
"""

import random

import numpy as np
import pytest
import torch

from lattisense_tpu import models as ref_models
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.frontend import custom_task as jax_fe
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.params import CkksParams as RefCkksParams
from lattisense_tpu.runtime import BfvContext as RefBfvContext
from lattisense_tpu.runtime import CkksContext as RefCkksContext

from lattisense_torch import models as port_models
from lattisense_torch.frontend import custom_task as port_fe
from lattisense_torch.params import BfvParams, CkksParams
from lattisense_torch.runtime import BfvContext, CkksContext, FheTask

from .test_torch_frontend import files
from .test_torch_task import same, to_port

N = 256
SEED = 4321


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    """One torch intra-op thread: parallel test workers with a thread per
    core each oversubscribe the host (``tests/test_torch_task.py``)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def chain(kind: str):
    """(q, p, scale or t, word) of the JAX tests' toy chains at n=N."""
    if kind == 'w32':
        primes = gen_ntt_primes(N, 31, 10)
        return primes[:7], primes[7:], float(1 << 30), 32
    q = gen_ntt_primes(N, 50, 5)
    p = gen_ntt_primes(N, 51, 1, exclude=tuple(q))
    return q, p, (65537 if kind == 'bfv' else float(1 << 40)), 64


def fe_param(mod, kind: str):
    q, p, x, _ = chain(kind)
    if kind == 'bfv':
        return mod.BfvParam.create_custom_param(n=N, q=q, p=p, t=x)
    return mod.CkksParam.create_custom_param(n=N, q=q, p=p, scale=x, slots=N // 2)


def contexts(kind: str, seed: int):
    """A JAX context and a port context on the CPU of one seed (the same keys)."""
    q, p, x, word = chain(kind)
    if kind == 'bfv':
        return (RefBfvContext.create_random_context(
                    RefBfvParams.create_custom(N, x, q, p), seed=seed),
                BfvContext.create_random_context(BfvParams.create_custom(N, x, q, p), seed=seed,
                                                 device='cpu'))
    return (RefCkksContext.create_random_context(
                RefCkksParams.create_custom(N, q, p, scale=x, word_bits=word), seed=seed),
            CkksContext.create_random_context(
                CkksParams.create_custom(N, q, p, scale=x, word_bits=word), seed=seed,
                device='cpu'))


def banded(s, rng):
    A = np.zeros((s, s))
    k = np.arange(s)
    for d in (0, 1, 5):                     # three diagonals only
        A[k, (k + d) % s] = rng.uniform(-1, 1, s)
    return A


# name → (chain, context seed, make(models, fe, rng) → model, pack(model, ctx, rng) →
# (inputs, oracle(inputs)), decode(model, ctx, outputs), tolerance)
def _logistic():
    def make(M, fe, rng):
        return M.LogisticRegressionScore(fe, n_features=13)

    def pack(m, ctx, rng):
        xv, wv = rng.uniform(-1, 1, 13), rng.uniform(-1, 1, 13)
        return m.pack_inputs(ctx, xv, wv, 0.5), xv @ wv + 0.5
    return 'ckks', 21, make, pack, lambda m, c, o: m.decode_output(c, o), 1e-2


def _distance():
    skip = N // 2 // 8

    def make(M, fe, rng):
        return M.PackedEuclideanDistance(fe, pack=4, skip=skip)

    def pack(m, ctx, rng):
        xv, wv = rng.uniform(-1, 1, 4 * skip), rng.uniform(-1, 1, 4 * skip)
        return m.pack_inputs(ctx, xv, wv), ((xv - wv).reshape(4, skip) ** 2).sum(axis=0)
    return 'ckks', 21, make, pack, lambda m, c, o: m.decode_output(c, o), 1e-2


def _conv():
    def make(M, fe, rng):
        return M.PackedConv2d(fe, pack=2, input_shape=(4, 4), kernel_shape=(3, 3))

    def pack(m, ctx, rng):
        img, w = rng.uniform(-1, 1, 2 * 16), rng.uniform(-1, 1, (2, 9))
        inputs, xv = m.pack_inputs(ctx, img, w, 0.3)
        return inputs, m.reference_conv(xv, w, 0.3)
    return 'ckks', 21, make, pack, lambda m, c, o: m.decode_output(c, o), 1e-2


def _poly(degree):
    def make(M, fe, rng):
        return M.PolynomialEvaluator(fe, degree=degree, top_level=4)

    def pack(m, ctx, rng):
        xv = rng.integers(0, 50, N, dtype=np.uint64)
        coeffs = [int(c) for c in rng.integers(1, 50, degree + 1)]
        x = xv.astype(object)
        exp = sum(c * x ** i for i, c in enumerate(coeffs)) % 65537
        return m.pack_inputs(ctx, xv, coeffs), exp.astype(np.uint64)

    def decode(m, c, o):
        return m.decode_output(c, o).astype(np.uint64)
    return 'bfv', 23, make, pack, decode, 0


def _matvec(kind, dense):
    def make(M, fe, rng):
        s = fe.slots
        A = rng.uniform(-1, 1, (s, s)) if dense else banded(s, rng)
        return M.EncryptedMatVec(fe, A, level=2)

    def pack(m, ctx, rng):
        xv = rng.uniform(-1, 1, m.slots)
        return m.pack_inputs(ctx, xv), m.matrix @ xv
    tol = 5e-2 if kind == 'w32' else 5e-3
    return kind, 29 if kind == 'w32' else 21, make, pack, \
        lambda m, c, o: m.decode_output(c, o), tol


CASES = {'logistic': _logistic(), 'distance': _distance(), 'conv2d': _conv(),
         'poly3': _poly(3), 'poly7': _poly(7), 'matvec_dense': _matvec('ckks', True),
         'matvec_banded': _matvec('ckks', False), 'matvec_w32': _matvec('w32', True)}


def model_pair(name):
    """The JAX model and the port's, from the same numpy arguments."""
    kind, _, make, *_ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    ref = make(ref_models, fe_param(jax_fe, kind), rng)
    rng = np.random.default_rng(sorted(CASES).index(name))
    return ref, make(port_models, fe_param(port_fe, kind), rng)


@pytest.mark.parametrize('name', list(CASES))
def test_compile_writes_the_jax_bytes(name, tmp_path):
    ref, port = model_pair(name)
    random.seed(SEED)
    ref.compile(str(tmp_path / 'jax'))
    random.seed(SEED)
    port.compile(str(tmp_path / 'port'))
    assert files(str(tmp_path / 'port')) == files(str(tmp_path / 'jax'))
    assert port.required_rotations() == ref.required_rotations()
    assert port.required_galois_elements() == ref.required_galois_elements()


@pytest.fixture(scope='module')
def reference_runs(tmp_path_factory):
    """name → the JAX model's eager run on its context and the port's pieces,
    made once a model."""
    cache = {}

    def get(name):
        if name not in cache:
            kind, seed, _, pack, _, _ = CASES[name]
            ref, port = model_pair(name)
            ref_ctx, port_ctx = contexts(kind, seed)
            d = tmp_path_factory.mktemp(name)
            random.seed(SEED)
            ref.compile(str(d / 'jax'))
            random.seed(SEED)
            port.compile(str(d / 'port'))
            ref_task = ref.load(ref_ctx, mode='eager')
            inputs, oracle = pack(ref, ref_ctx, np.random.default_rng(7))
            want, _ = ref_task.run(ref_ctx, inputs)
            cache[name] = (ref, ref_ctx, port, port_ctx, inputs, oracle, want)
        return cache[name]
    return get


@pytest.mark.parametrize('mode', ['eager', 'jit'])
@pytest.mark.parametrize('name', list(CASES))
def test_load_runs_as_the_jax_model(name, mode, reference_runs):
    ref, ref_ctx, port, port_ctx, inputs, oracle, want = reference_runs(name)
    task = port.load(port_ctx, mode=mode)
    assert isinstance(task, FheTask) and task.device == port_ctx.device
    # load drew the JAX model's Galois keys, in the same order from one seed
    assert sorted(port_ctx.glk.keys) == sorted(ref_ctx.glk.keys)
    for e, k in ref_ctx.glk.keys.items():
        got = port_ctx.glk.keys[e]
        assert np.array_equal(got.key_q.numpy(), np.asarray(k.key_q).astype(np.int64))
        assert np.array_equal(got.key_p.numpy(), np.asarray(k.key_p).astype(np.int64))
    got, _ = task.run(port_ctx, {k: to_port(v) for k, v in inputs.items()})
    assert set(got) == set(want) and all(same(got[k], want[k]) for k in want)
    _, _, _, _, decode, tol = CASES[name]
    err = np.max(np.abs(np.asarray(decode(port, port_ctx, got), dtype=float) - oracle))
    assert err <= tol, err
