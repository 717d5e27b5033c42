"""Kernels B3 (the key switch) and B4 (the BEHZ finish) of lattisense_torch.

On the CPU the wrappers run their plain PyTorch twins; those are held bit
for bit against the Pallas kernels they replace (``ksw_switch32``,
``behz_finish32``), run in interpret mode as the JAX package's own tests run
them. The CUDA kernels themselves are held against these twins on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.ops.behz_pallas32 import behz_finish32 as ref_behz_finish32
from lattisense_tpu.ops.ksw_pallas32 import ksw_switch32 as ref_ksw_switch32
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.runtime import BfvContext as RefContext

from lattisense_torch.ops import behz_cuda, ksw_cuda
from lattisense_torch.params import BfvParams
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes.types import KeySwitchKey

N = 256


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def A(t):
    return t.cpu().numpy().astype(np.uint32)


def residues(rng, moduli, n, lead=()):
    out = np.stack([rng.integers(0, q, (*lead, n), dtype=np.uint64) for q in moduli], axis=-2)
    return out.astype(np.uint32)


@pytest.fixture(scope='module')
def ksw_pair():
    """α = 2 special primes over 5 q primes: the last digit is ragged at
    levels 4 and 2. The port holds the reference's relinearization key."""
    chain = tuple(ref_primes(N, 31, 8))
    q, p = list(chain[:5]), list(chain[5:7])
    ref = RefContext.create_random_context(
        RefBfvParams.create_custom(N, 257, q, p, word_bits=32), seed=15)
    port = BfvContext.from_arrays(BfvParams.create_custom(N, 257, q, p, word_bits=32), ref.sk.coeffs,
                                  ref.pk.data, ref.rlk.key_q, ref.rlk.key_p, device='cpu')
    return ref, port


# ---------------------------------------------------------------------------
# B3: plain twin vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('level', [4, 3, 2])
@pytest.mark.parametrize('output_ntt', [False, True])
def test_b3_plain_matches_pallas(ksw_pair, level, output_ntt):
    ref, port = ksw_pair
    sw = port.engine.switcher
    x = residues(np.random.default_rng(8 + level), sw.q_moduli[:level + 1], N)
    want = ref_ksw_switch32(jnp.asarray(x), ref.rlk, ref.engine.switcher, level,
                            output_ntt=output_ntt)
    got = ksw_cuda.ksw_switch32(T(x), port.rlk, sw, level, output_ntt)
    assert np.array_equal(A(got[0]), np.asarray(want[0]))
    assert np.array_equal(A(got[1]), np.asarray(want[1]))
    # KeySwitcher.switch goes through the wrapper, switch_plain is the twin
    direct = sw.switch(T(x), port.rlk, level, output_ntt)
    assert torch.equal(direct[0], got[0]) and torch.equal(direct[1], got[1])


def test_b3_plain_batched_matches_pallas(ksw_pair):
    """The batched layout the main path feeds it: (B, L, n), and the strided
    third component of a (B, 3, L, n) stack as relinearize passes it."""
    ref, port = ksw_pair
    sw = port.engine.switcher
    level = 4
    x3 = residues(np.random.default_rng(21), sw.q_moduli[:level + 1], N, (2, 3))
    x = x3[:, 2]
    want = ref_ksw_switch32(jnp.asarray(x), ref.rlk, ref.engine.switcher, level)
    got = ksw_cuda.ksw_switch32(T(x3)[:, 2], port.rlk, sw, level)
    assert got[0].shape == (2, level + 1, N)
    assert np.array_equal(A(got[0]), np.asarray(want[0]))
    assert np.array_equal(A(got[1]), np.asarray(want[1]))


def test_b3_wrapper_rejects_bad_input(ksw_pair):
    _, port = ksw_pair
    sw = port.engine.switcher
    x = torch.zeros((4, N), dtype=torch.int64)
    before = dict(ksw_cuda.launches)
    with pytest.raises(ValueError):
        ksw_cuda.ksw_switch32(x, port.rlk, sw, 2)                     # L = 4 is level 3
    with pytest.raises(ValueError):
        ksw_cuda.ksw_switch32(x, port.rlk, sw, 7)                     # beyond the chain
    with pytest.raises(TypeError):
        ksw_cuda.ksw_switch32(x.to(torch.int32), port.rlk, sw, 3)
    with pytest.raises(ValueError):
        short = KeySwitchKey(key_q=port.rlk.key_q[:, :, :3], key_p=port.rlk.key_p)
        ksw_cuda.ksw_switch32(x, short, sw, 3)
    ksw_cuda.ksw_switch32(x, port.rlk, sw, 3)
    assert ksw_cuda.launches == before            # the plain twin counts nothing


# ---------------------------------------------------------------------------
# B4: plain twin vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def finish_pair():
    chain = tuple(ref_primes(N, 31, 6))
    q, p = list(chain[:3]), [chain[3]]
    ref = RefContext.create_random_context(
        RefBfvParams.create_custom(N, 257, q, p, word_bits=32), seed=14)
    port = BfvContext.from_arrays(BfvParams.create_custom(N, 257, q, p, word_bits=32), ref.sk.coeffs,
                                  ref.pk.data, ref.rlk.key_q, ref.rlk.key_p, device='cpu')
    return ref.engine.behz(2), port.engine.behz(2)


@pytest.mark.parametrize('lead', [(3,), (2, 3)])
def test_b4_plain_matches_pallas(finish_pair, lead):
    ref_bz, bz = finish_pair
    assert bz.ring_aux.moduli == ref_bz.ring_aux.moduli
    rng = np.random.default_rng(6)
    dq = residues(rng, bz.ring_q.moduli, N, lead)
    da = residues(rng, bz.ring_aux.moduli, N, lead)
    want = np.asarray(ref_behz_finish32(jnp.asarray(dq), jnp.asarray(da), ref_bz))
    got = behz_cuda.behz_finish32(T(dq), T(da), bz)
    assert got.shape == dq.shape
    assert np.array_equal(A(got), want)


def test_b4_wrapper_rejects_bad_input(finish_pair):
    _, bz = finish_pair
    L, Ta = len(bz.ring_q.moduli), len(bz.ring_aux.moduli)
    dq = torch.zeros((3, L, N), dtype=torch.int64)
    da = torch.zeros((3, Ta, N), dtype=torch.int64)
    before = dict(behz_cuda.launches)
    with pytest.raises(ValueError):
        behz_cuda.behz_finish32(dq[:2], da, bz)                       # leading dims differ
    with pytest.raises(ValueError):
        behz_cuda.behz_finish32(da, dq, bz)                           # bases swapped
    with pytest.raises(TypeError):
        behz_cuda.behz_finish32(dq.to(torch.int32), da, bz)
    behz_cuda.behz_finish32(dq, da, bz)
    assert behz_cuda.launches == before

