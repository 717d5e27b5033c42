"""User-facing BFV context: key ownership and the eager op facade.

Port of the ``BfvContext`` subset of ``lattisense_tpu/runtime/context.py``:
a context owns the parameter set, the secret, public and relinearization
keys, and exposes encode / encrypt / decrypt and the multiplication ops. It
runs on the card unless created with ``device='cpu'``.
"""

import numpy as np
import torch

from .. import resolve_device
from ..params import BfvParams
from ..schemes import keys as K
from ..schemes.bfv import BfvEngine
from ..schemes.types import KeySwitchKey, PublicKey
from ..utils.csprng import default_crypto_rng


class BfvContext:
    """BFV keys + engine on one device (reference: fhe_lib_v2.h BfvContext)."""

    def __init__(self, params: BfvParams, seed=None, device=None):
        self.params = params
        self.device = resolve_device(device)
        self.engine = BfvEngine(params, self.device)
        self.rng = default_crypto_rng(seed)
        self.sk = None
        self.pk = None
        self.rlk = None

    # ---- key generation / import ----
    @classmethod
    def create_random_context(cls, params: BfvParams, seed=None, device=None) -> 'BfvContext':
        """Sample sk/pk/rlk; deterministic when ``seed`` is given, with the
        same keys as ``lattisense_tpu``'s context of the same seed."""
        ctx = cls(params, seed, device)
        q, p, n = tuple(params.q), tuple(params.p), params.n
        ctx.sk = K.SecretKey(K.sample_ternary(ctx.rng, n))
        ctx.pk = K.gen_public_key(ctx.rng, ctx.sk, q, n, ctx.device)
        ctx.rlk = K.gen_relin_key(ctx.rng, ctx.sk, q, p, n, ctx.device)
        return ctx

    @classmethod
    def from_arrays(cls, params: BfvParams, sk, pk, rlk_key_q, rlk_key_p,
                    device=None) -> 'BfvContext':
        """A context holding existing keys given as arrays: ``sk`` the ternary
        secret coefficients (n,), ``pk`` (2, Lq, n), ``rlk_key_q``
        (β, 2, Lq, n) and ``rlk_key_p`` (β, 2, |P|, n), in the reference's
        layouts and domains. Encryption uses a fresh CSPRNG."""
        ctx = cls(params, None, device)
        n, Lq, Lp = params.n, len(params.q), len(params.p)
        beta = (Lq + Lp - 1) // Lp

        def tensor(a, shape, name):
            arr = np.asarray(a)
            if arr.shape != shape:
                raise ValueError(f'{name}: expected shape {shape}, got {arr.shape}')
            return torch.from_numpy(arr.astype(np.int64)).to(ctx.device)

        sk = np.asarray(sk, dtype=np.int64)
        if sk.shape != (n,) or not np.isin(sk, (-1, 0, 1)).all():
            raise ValueError('sk: expected (n,) ternary coefficients')
        ctx.sk = K.SecretKey(sk)
        ctx.pk = PublicKey(data=tensor(pk, (2, Lq, n), 'pk'))
        ctx.rlk = KeySwitchKey(key_q=tensor(rlk_key_q, (beta, 2, Lq, n), 'rlk_key_q'),
                               key_p=tensor(rlk_key_p, (beta, 2, Lp, n), 'rlk_key_p'),
                               level=Lq - 1, sp_level=Lp - 1)
        return ctx

    # ---- argument validation (reference-verbatim error strings) ----
    def _check_message(self, values, level):
        try:
            length = len(values)
        except TypeError:
            length = np.asarray(values).size
        if length == 0 or length > self.params.n:
            raise RuntimeError('Invalid message length.')
        if level is not None and not 0 <= level <= self.params.max_level:
            raise RuntimeError('Invalid level.')

    @staticmethod
    def _check_same_level(a, b):
        la, lb = getattr(a, 'level', None), getattr(b, 'level', None)
        if la is not None and lb is not None and la != lb:
            raise RuntimeError('x0 and x1 have different levels.')

    # ---- encode / encrypt / decrypt ----
    def encode(self, values, level=None):
        level = self.params.max_level if level is None else level
        self._check_message(values, level)
        return self.engine.encode(values, level)

    def encrypt(self, pt):
        return self.engine.encrypt_asymmetric(self.rng, self.pk, pt)

    def decrypt(self, ct):
        if self.sk is None:
            raise RuntimeError('Context does not have sk and decryptor.')
        return self.engine.decrypt(self.sk, ct)

    def decrypt_decode(self, ct):
        if self.sk is None:
            raise RuntimeError('Context does not have sk and decryptor.')
        return self.engine.decrypt_decode(self.sk, ct)

    # ---- evaluation ----
    def mult(self, a, b):
        self._check_same_level(a, b)
        return self.engine.mult(a, b)

    def relinearize(self, ct3):
        if self.rlk is None:
            raise RuntimeError('Context does not have a relinearization key.')
        return self.engine.relinearize(ct3, self.rlk)

    def mult_relin(self, a, b):
        return self.relinearize(self.mult(a, b))
