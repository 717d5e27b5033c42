"""The port's BFV at n=32768 against lattisense_tpu: the u64 chain
``BfvParams.create(32768)`` (12 q primes of 59-60 bits, 3 special primes of
60 bits) at level 11, its full width, where the card's NTT (kernel B5) runs
its cluster kernel (``csrc/ntt_cluster.cuh``). Here on the CPU the port's plain path runs:
the batched mult_relin and rotate_col by one slot, batch 1, with the
reference's keys handed over through ``BfvContext.from_arrays``, bit for bit
against the reference's NumPy path.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.runtime import BfvContext as RefContext

from lattisense_torch.params import BfvParams
from lattisense_torch.parallel.batch import (bfv_mult_relin, key_tree, make_batched_step,
                                             make_rotate_step)
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes.galois import galois_elt_col
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
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.uint64)).view(np.int64))


def same(port, ref):
    return np.array_equal(port.cpu().numpy().view(np.uint64), np.asarray(ref).astype(np.uint64))


def test_u64_32k_mult_relin_and_rotate_match_reference():
    """Level 11 (12 limbs, 14 aux limbs, alpha 3, beta 4): mult_relin and
    rotate_col by one slot, each decrypting right and equal to the
    reference's output."""
    level = 11
    params_ref = RefBfvParams.create(32768)
    ref = RefContext.create_random_context(params_ref, seed=7)
    elt = galois_elt_col(1, params_ref.n)
    ref.gen_galois_keys_for_elements([elt])
    params = BfvParams.create(32768)
    assert (params.q, params.p, params.max_level) == (params_ref.q, params_ref.p, level)
    port = BfvContext.from_arrays(params, ref.sk.coeffs, ref.pk.data, ref.rlk.key_q,
                                  ref.rlk.key_p, device='cpu')
    port.add_galois_key_arrays(elt, ref.glk.keys[elt].key_q, ref.glk.keys[elt].key_p)
    sw = port.engine.switcher
    assert (len(port.engine.behz(level).ring_aux.moduli), sw.alpha, sw.beta(level)) == (14, 3, 4)
    rng = np.random.default_rng(7)
    ma, mb = rng.integers(0, params.t, (2, params.n))
    ca, cb = (ref.encrypt(ref.encode(m, level)) for m in (ma, mb))
    keys = key_tree(port, galois_elts=[elt])
    out = make_batched_step(port.engine, bfv_mult_relin, level)(T(ca.data[None]),
                                                                T(cb.data[None]), keys)
    rot = make_batched_step(port.engine, make_rotate_step(elt), level, n_inputs=1)(
        T(ca.data[None]), keys)
    assert out.shape == rot.shape == (1, 2, level + 1, params.n)
    eng = ref.engine
    assert same(out[0], eng.relinearize(np, eng.mult(np, ca, cb), ref.rlk).data)
    assert same(rot[0], eng.apply_galois(np, ca, elt, ref.glk.keys[elt]).data)
    assert np.array_equal(port.decrypt_decode(Ciphertext(data=out[0], level=level)),
                          (ma * mb) % params.t)
    half = params.n // 2
    assert np.array_equal(port.decrypt_decode(Ciphertext(data=rot[0], level=level)),
                          np.concatenate([np.roll(ma[:half], -1), np.roll(ma[half:], -1)]))
