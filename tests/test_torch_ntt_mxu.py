"""The port's four-step NTT as matrix products (``ops/ntt_mxu.py``), bit for
bit against the JAX package's ``ops/ntt_mxu.py`` (its ``einsum`` route) and the
NumPy ``core.ntt`` on the same inputs: the cases of ``tests/test_ntt_mxu.py``,
both routes (float32 ``bmm`` on the CPU, int8 ``_int_mm``), the gate through
``core/ntt.py``, and a u64 BFV ``mult_relin`` at n=4096 with the gate on,
against the JAX package with its gate on."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core import ntt as ref_ntt
from lattisense_tpu.core.modring import gen_ntt_primes, get_rns_ring as ref_ring
from lattisense_tpu.ops import ntt_mxu as ref_mxu
from lattisense_tpu.params import BfvParams as RefParams
from lattisense_tpu.runtime import BfvContext as RefContext
from lattisense_tpu.schemes.types import Ciphertext as RefCt, KeySwitchKey as RefKey

from lattisense_torch.core import ntt as port_ntt
from lattisense_torch.core.modring import get_rns_ring
from lattisense_torch.ops import ntt64_cuda, ntt_mxu
from lattisense_torch.params import BfvParams
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes.types import Ciphertext


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    """One torch intra-op thread: the suite's parallel workers, each with a
    thread per core, would oversubscribe the host (``tests/test_torch_task.py``)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def A(t):
    return t.numpy().astype(np.uint64)


def stack(q, n, seed, lead=()):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, qi, (*lead, n), dtype=np.uint64) for qi in q], axis=-2)


@pytest.mark.parametrize('i8dot', [False, True], ids=['bmm', 'int_mm'])
@pytest.mark.parametrize('n', [64, 128, 256, 512])
@pytest.mark.parametrize('bits', [50, 61])
def test_mxu_ntt_matches_jax(monkeypatch, n, bits, i8dot):
    """Forward and inverse on a (2, 3, n) stack equal the JAX module (its
    default bf16 route) and NumPy core.ntt; the inverse returns the input."""
    monkeypatch.setattr(ntt_mxu, 'I8DOT', i8dot)
    q = gen_ntt_primes(n, bits, 3)
    ring, jring = get_rns_ring(q, n, 'cpu', 64), ref_ring(tuple(q), n)
    x = stack(q, n, n + bits, lead=(2,))
    want = ref_ntt.ntt(np, x, jring)
    got = A(ntt_mxu.ntt(T(x), ring))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(ref_mxu.ntt(jnp, jnp.asarray(x), jring)))
    back = A(ntt_mxu.intt(T(want), ring))
    assert np.array_equal(back, x)
    assert np.array_equal(back, np.asarray(ref_mxu.intt(jnp, jnp.asarray(want), jring)))


def test_mxu_odd_logn():
    """R != C (log2 n odd), fewer limbs than the ring."""
    n = 128
    q = gen_ntt_primes(n, 55, 3)
    ring, jring = get_rns_ring(q, n, 'cpu', 64), ref_ring(tuple(q[:2]), n)
    x = stack(q[:2], n, 7)
    want = ref_ntt.ntt(np, x, jring)
    assert np.array_equal(A(ntt_mxu.ntt(T(x), ring)), want)
    assert np.array_equal(A(ntt_mxu.ntt(T(x), ring)),
                          np.asarray(ref_mxu.ntt(jnp, jnp.asarray(x), jring)))
    assert np.array_equal(A(ntt_mxu.intt(T(want), ring)), x)


def test_mxu_gate_through_core(monkeypatch):
    """core/ntt.py takes the route with the gate on, at the 64-bit word and
    n >= 4096, and only there; the Montgomery entry and exit match B5's
    epilogues' plain twins."""
    n = 4096
    q = gen_ntt_primes(n, 55, 3)
    ring = get_rns_ring(q, n, 'cpu', 64)
    x = T(stack(q, n, 4))
    monkeypatch.setattr(ntt_mxu, 'ENABLED', True)
    calls = []
    real = ntt_mxu.ntt
    monkeypatch.setattr(ntt_mxu, 'ntt', lambda *a: calls.append(1) or real(*a))
    got = port_ntt.ntt(x, ring, to_mont=True)
    assert calls
    assert torch.equal(got, ntt64_cuda.ntt64_plain(x, ring, to_mont=True))
    assert torch.equal(port_ntt.intt(got, ring, from_mont=True),
                       ntt64_cuda.intt64_plain(got, ring, from_mont=True))
    y = port_ntt.ntt(x, ring)
    assert np.array_equal(A(y), ref_ntt.ntt(np, A(x), ref_ring(tuple(q), n)))
    assert torch.equal(port_ntt.intt(y, ring), x)
    assert ntt_mxu.enabled(4096, 64) and not ntt_mxu.enabled(2048, 64)
    assert not ntt_mxu.enabled(4096, 32)
    monkeypatch.setattr(ntt_mxu, 'ENABLED', False)
    assert not ntt_mxu.enabled(4096, 64)


def _mult_relin_pair(params_ref, params, level, seed):
    ref = RefContext.create_random_context(params_ref, seed=seed)
    port = BfvContext.from_arrays(params, ref.sk.coeffs, ref.pk.data, ref.rlk.key_q,
                                  ref.rlk.key_p, device='cpu')
    rng = np.random.default_rng(5)
    m1, m2 = (rng.integers(0, params.t, params.n, dtype=np.uint64) for _ in range(2))
    a, b = ref.encrypt(ref.encode(m1, level)), ref.encrypt(ref.encode(m2, level))
    pa, pb = (Ciphertext(data=T(c.data), level=level) for c in (a, b))
    got = port.engine.relinearize(port.engine.mult(pa, pb), port.rlk)
    assert np.array_equal(port.decrypt_decode(got),
                          (m1.astype(object) * m2 % params.t).astype(np.uint64))
    return ref, a, b, A(got.data)


def test_mult_relin_u64_with_the_gate_on(monkeypatch):
    """A u64 BFV mult_relin at n=4096 with both gates on, on the 54-57-bit
    primes of create(16384), equals the JAX package's (jitted, its gate on)
    bit for bit and decrypts to a·b."""
    monkeypatch.setattr(ntt_mxu, 'ENABLED', True)
    monkeypatch.setattr(ref_mxu, '_ENABLED', True)
    big = BfvParams.create(16384)
    q, p, level = list(big.q[:3]), list(big.p), 2
    ref, a, b, got = _mult_relin_pair(RefParams.create_custom(4096, 65537, q, p),
                                      BfvParams.create_custom(4096, 65537, q, p), level, 11)

    def step(ad, bd, kq, kp):
        ct3 = ref.engine.mult(jnp, RefCt(data=ad, level=level), RefCt(data=bd, level=level))
        return ref.engine.relinearize(jnp, ct3, RefKey(key_q=kq, key_p=kp, level=ref.rlk.level,
                                                       sp_level=ref.rlk.sp_level)).data
    want = jax.jit(step)(a.data, b.data, ref.rlk.key_q, ref.rlk.key_p)
    assert np.array_equal(got, np.asarray(want))


def test_mult_relin_create4096_with_the_gate_on(monkeypatch):
    """At create(4096), whose 39- and 40-bit primes take six digit planes,
    the port's route (gate on) equals the JAX package's NumPy path bit for
    bit and decrypts to a·b. The JAX module's own route is wrong there (it
    corrects three chunk offsets where six planes make two chunks), so it is
    not the yardstick on this chain."""
    monkeypatch.setattr(ntt_mxu, 'ENABLED', True)
    ref, a, b, got = _mult_relin_pair(RefParams.create(4096), BfvParams.create(4096), 1, 11)
    want = ref.engine.relinearize(np, ref.engine.mult(np, a, b), ref.rlk)
    assert np.array_equal(got, np.asarray(want.data))
