"""Host work of the port moved into machine words, on the CPU.

- BFV decryption's CRT and rounding (``lattisense_torch/schemes/bfv.py``
  ``round_t_over_q``): the (L, n) residues of the decryption phase to
  round(t·X / Q) mod t without big integers (Garner's mixed-radix digits,
  then floor(2t·X / Q) digit by digit). Held bit for bit against the
  big-integer formula of the JAX package's ``BfvEngine.decrypt``
  (((2tX + Q) // 2Q) mod t) on both words, on the chains of
  ``create_tpu_param`` and ``create``, with residues 0, 1, q - 1 and q / 2 in
  every limb and plaintext moduli from 2 to 2^31 - 1; and the port's
  ``decrypt`` against the JAX package's on one ciphertext of each word.
- The lift of signed coefficients to RNS residues on the device
  (``schemes/keys.py`` ``lift_to``) against the host's ``lift_signed``,
  which ``tests/test_torch_multiparty.py`` holds against the JAX package.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.runtime import BfvContext as RefContext

from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_torch.params import BfvParams
from lattisense_torch.runtime import BfvContext
from lattisense_torch.schemes.bfv import round_t_over_q
from lattisense_torch.schemes.keys import lift_signed, lift_to
from lattisense_torch.schemes.types import Ciphertext


def big_round(acc, moduli, t):
    """((2tX + Q) // 2Q) mod t with X the CRT of acc, in Python integers."""
    Q = 1
    for q in moduli:
        Q *= q
    X = np.zeros(acc.shape[1], dtype=object)
    for i, q in enumerate(moduli):
        Qi = Q // q
        X = X + acc[i].astype(object) * (Qi * pow(Qi, -1, q))
    return np.array([((2 * t * int(x) + Q) // (2 * Q)) % t for x in X % Q], dtype=np.int64)


def chain(word_bits, limbs):
    full = (BfvParams.create_tpu_param(32768) if word_bits == 32 else BfvParams.create(32768))
    return tuple(full.q[:limbs])


@pytest.mark.parametrize('word_bits,limbs', [(32, 1), (32, 8), (32, 22), (64, 1), (64, 4),
                                             (64, 12)])
@pytest.mark.parametrize('t', [2, 3, 257, 65537, (1 << 31) - 1])
def test_round_t_over_q_matches_big_integers(word_bits, limbs, t):
    moduli = chain(word_bits, limbs)
    n = 512
    ring = get_rns_ring(moduli, n, 'cpu', word_bits)
    rng = np.random.default_rng(limbs * 1000 + t % 997)
    acc = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in moduli]).astype(np.int64)
    acc[:, 0], acc[:, 1], acc[:, 2] = 0, 1, [q - 1 for q in moduli]
    acc[:, 3] = [q // 2 for q in moduli]
    got = round_t_over_q(torch.from_numpy(acc), ring, t)
    assert np.array_equal(got.numpy(), big_round(acc, moduli, t))


def test_round_t_over_q_refuses_wide_t():
    ring = get_rns_ring(chain(32, 2), 64, 'cpu', 32)
    with pytest.raises(ValueError):
        round_t_over_q(torch.zeros((2, 64), dtype=torch.int64), ring, 1 << 31)


@pytest.mark.parametrize('word_bits', [32, 64])
def test_decrypt_matches_reference(word_bits):
    """The port's decrypt on the JAX package's keys and ciphertext, n = 256,
    equals the JAX package's decrypt."""
    n, t, level = 256, 65537, 3
    primes = gen_ntt_primes(n, 31 if word_bits == 32 else 60, 6)
    q, p = primes[:5], primes[5:]
    ref = RefContext.create_random_context(
        RefBfvParams.create_custom(n, t, q, p, word_bits=word_bits), seed=11)
    port = BfvContext.from_arrays(BfvParams.create_custom(n, t, q, p, word_bits=word_bits),
                                  ref.sk.coeffs, ref.pk.data, ref.rlk.key_q, ref.rlk.key_p,
                                  device='cpu')
    msg = np.random.default_rng(3).integers(0, t, n)
    ct = ref.encrypt(ref.encode(msg, level))
    want = ref.decrypt(ct)
    data = torch.from_numpy(np.asarray(ct.data, dtype=np.uint64).view(np.int64))
    got = port.decrypt(Ciphertext(data=data, level=level))
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize('word_bits', [32, 64])
def test_lift_to_matches_lift_signed(word_bits):
    """Ternary, Gaussian and coefficients above every prime, both signs, on
    both words' chains."""
    moduli = chain(word_bits, 6)
    rng = np.random.default_rng(word_bits)
    for coeffs in (rng.integers(-1, 2, 1024), np.round(rng.normal(0, 3.2, 1024)).astype(np.int64),
                   rng.integers(-(1 << 62), 1 << 62, 1024)):
        got = lift_to(coeffs, moduli, 'cpu')
        assert got.dtype == torch.int64 and tuple(got.shape) == (len(moduli), 1024)
        assert np.array_equal(got.numpy(), lift_signed(coeffs, moduli))
