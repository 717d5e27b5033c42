"""Kernels B1 (NTT) and B2 (BEHZ prep) of lattisense_torch.

On the CPU the wrappers run their plain PyTorch twins; those are held bit
for bit against the Pallas kernels they replace (``ntt_fused32``,
``intt_fused32``, ``behz_prep32``), run in interpret mode as the JAX
package's own tests run them. The CUDA kernels themselves are held against
these twins on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lattisense_tpu.core import ntt as ref_ntt
from lattisense_tpu.core import u64 as ref_u
from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.core.modring import get_rns_ring as ref_ring
from lattisense_tpu.ops.behz_pallas32 import behz_prep32 as ref_behz_prep32
from lattisense_tpu.ops.ntt_pallas32 import intt_fused32, ntt_fused32
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.runtime import BfvContext as RefContext

from lattisense_torch.core.modring import get_rns_ring
from lattisense_torch.ops import behz_cuda, ntt_cuda
from lattisense_torch.params import BfvParams
from lattisense_torch.schemes.bfv import BfvEngine

CPU = torch.device('cpu')


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def A(t):
    return t.cpu().numpy().astype(np.uint32)


def residues(rng, moduli, n, lead=()):
    out = np.stack([rng.integers(0, q, (*lead, n), dtype=np.uint64) for q in moduli], axis=-2)
    return out.astype(np.uint32)


# ---------------------------------------------------------------------------
# B1: plain twin vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n,lead', [(256, (3,)), (1024, (2, 2))])
def test_b1_plain_matches_pallas(n, lead):
    chain = tuple(ref_primes(n, 31, 3))
    ref, ring = ref_ring(chain, n, 32), get_rns_ring(chain, n, CPU)
    x = residues(np.random.default_rng(5), chain, n, lead)
    want_f = np.asarray(ntt_fused32(jnp.asarray(x), ref))
    got_f = ntt_cuda.ntt32_fwd(T(x), ring)
    assert np.array_equal(A(got_f), want_f)
    want_i = np.asarray(intt_fused32(jnp.asarray(want_f), ref))
    assert np.array_equal(A(ntt_cuda.ntt32_inv(got_f, ring)), want_i)
    assert np.array_equal(want_i, x)


def test_b1_to_mont_epilogue():
    n = 256
    chain = tuple(ref_primes(n, 31, 2))
    ref, ring = ref_ring(chain, n, 32), get_rns_ring(chain, n, CPU)
    x = residues(np.random.default_rng(6), chain, n, (2,))
    want = ref_u.to_mont(np, ref_ntt.ntt(np, x, ref), ref.q, ref.pinv, ref.r2)
    assert np.array_equal(A(ntt_cuda.ntt32_fwd(T(x), ring, to_mont=True)), want)


def test_b1_wrapper_rejects_bad_input():
    n = 64
    chain = tuple(ref_primes(n, 31, 2))
    ring = get_rns_ring(chain, n, CPU)
    x = torch.zeros((2, n), dtype=torch.int64)
    with pytest.raises(TypeError):
        ntt_cuda.ntt32_fwd(x.to(torch.int32), ring)
    with pytest.raises(ValueError):
        ntt_cuda.ntt32_inv(torch.zeros((3, n), dtype=torch.int64), ring)
    with pytest.raises(ValueError):
        ntt_cuda.ntt32_fwd(torch.zeros((2, n // 2), dtype=torch.int64), ring)
    before = dict(ntt_cuda.launches)
    with pytest.raises(ValueError):
        ntt_cuda.launch(x, torch.empty_like(x), ring, inverse=False)   # CPU tensors
    with pytest.raises(ValueError):
        ntt_cuda.launch(x, torch.empty_like(x), ring, inverse=True, from_mont=True)
    ntt_cuda.ntt32_fwd(x, ring)
    ntt_cuda.ntt32_inv(x, ring)
    assert ntt_cuda.launches == before     # the count is taken in launch, the twins count nothing


# ---------------------------------------------------------------------------
# B2: plain twin vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _behz_case():
    n = 256
    chain = tuple(ref_primes(n, 31, 6))
    q, p = list(chain[:3]), [chain[3]]
    ref_eng = RefContext.create_random_context(
        RefBfvParams.create_custom(n, 257, q, p, word_bits=32), seed=13).engine
    eng = BfvEngine(BfvParams.create_custom(n, 257, q, p, word_bits=32), CPU)
    return n, ref_eng.behz(2), eng.behz(2)


def test_b2_plain_matches_pallas():
    n, ref_bz, bz = _behz_case()
    assert bz.ring_aux.moduli == ref_bz.ring_aux.moduli
    polys = residues(np.random.default_rng(4), bz.ring_q.moduli, n, (4,))
    want_fq, want_fa = ref_behz_prep32(jnp.asarray(polys), ref_bz)
    got_fq, got_fa = behz_cuda.behz_prep32(T(polys), bz)
    assert np.array_equal(A(got_fq), np.asarray(want_fq))
    assert np.array_equal(A(got_fa), np.asarray(want_fa))
    # the batched layout the main path feeds it: (B, 4, L, n)
    got2 = behz_cuda.behz_prep32(T(np.stack([polys, polys])), bz)
    assert torch.equal(got2[0][1], got_fq) and torch.equal(got2[1][1], got_fa)


def test_b2_wrapper_rejects_bad_input():
    n, _, bz = _behz_case()
    with pytest.raises(ValueError):
        behz_cuda.behz_prep32(torch.zeros((4, 2, n), dtype=torch.int64), bz)
    with pytest.raises(TypeError):
        behz_cuda.behz_prep32(torch.zeros((4, 3, n), dtype=torch.float32), bz)
