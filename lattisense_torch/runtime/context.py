"""User-facing BFV context: key ownership and the eager op facade.

Port of the ``BfvContext`` subset of ``lattisense_tpu/runtime/context.py``:
a context owns the parameter set, the secret, public, relinearization and
Galois keys, and exposes encode / encrypt / decrypt, the multiplication ops
and the rotations. It runs on the card unless created with
``device='cpu'``.
"""

import numpy as np
import torch

from .. import resolve_device
from ..params import BfvParams
from ..schemes import keys as K
from ..schemes.bfv import BfvEngine
from ..schemes.galois import col_sub_steps, galois_elt_col, galois_elt_row
from ..schemes.types import GaloisKeys, KeySwitchKey, PublicKey
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
        self.glk = GaloisKeys()

    # ---- key generation / import ----
    @classmethod
    def create_random_context(cls, params: BfvParams, seed=None, device=None) -> 'BfvContext':
        """Sample sk/pk/rlk; deterministic when ``seed`` is given, with the
        same keys as ``lattisense_tpu``'s context of the same seed."""
        ctx = cls(params, seed, device)
        q, p, n = tuple(params.q), tuple(params.p), params.n
        ctx.sk = K.SecretKey(K.sample_ternary(ctx.rng, n))
        wb = params.word_bits
        ctx.pk = K.gen_public_key(ctx.rng, ctx.sk, q, n, ctx.device, wb)
        ctx.rlk = K.gen_relin_key(ctx.rng, ctx.sk, q, p, n, ctx.device, wb)
        return ctx

    @classmethod
    def from_arrays(cls, params: BfvParams, sk, pk, rlk_key_q, rlk_key_p,
                    device=None) -> 'BfvContext':
        """A context holding existing keys given as arrays: ``sk`` the ternary
        secret coefficients (n,), ``pk`` (2, Lq, n), ``rlk_key_q``
        (β, 2, Lq, n) and ``rlk_key_p`` (β, 2, |P|, n), in the reference's
        layouts and domains (residues of either word, uint64 arrays
        included). Encryption uses a fresh CSPRNG."""
        ctx = cls(params, None, device)
        n, Lq = params.n, len(params.q)
        sk = np.asarray(sk, dtype=np.int64)
        if sk.shape != (n,) or not np.isin(sk, (-1, 0, 1)).all():
            raise ValueError('sk: expected (n,) ternary coefficients')
        ctx.sk = K.SecretKey(sk)
        ctx.pk = PublicKey(data=ctx._tensor(pk, (2, Lq, n), 'pk'))
        ctx.rlk = ctx._ksk_from_arrays(rlk_key_q, rlk_key_p, 'rlk')
        return ctx

    def add_galois_key_arrays(self, galois_elt: int, key_q, key_p):
        """Hold an existing Galois key for ``galois_elt``, given as arrays in
        the reference's layout: ``key_q`` (β, 2, Lq, n), ``key_p``
        (β, 2, |P|, n), NTT + Montgomery."""
        self.glk.keys[int(galois_elt)] = self._ksk_from_arrays(key_q, key_p,
                                                              f'galois key {galois_elt}')

    def _tensor(self, a, shape, name):
        arr = np.asarray(a)
        if arr.shape != shape:
            raise ValueError(f'{name}: expected shape {shape}, got {arr.shape}')
        return torch.from_numpy(arr.astype(np.int64)).to(self.device)

    def _ksk_from_arrays(self, key_q, key_p, name) -> KeySwitchKey:
        n, Lq, Lp = self.params.n, len(self.params.q), len(self.params.p)
        beta = (Lq + Lp - 1) // Lp
        return KeySwitchKey(key_q=self._tensor(key_q, (beta, 2, Lq, n), f'{name} key_q'),
                            key_p=self._tensor(key_p, (beta, 2, Lp, n), f'{name} key_p'),
                            level=Lq - 1, sp_level=Lp - 1)

    def gen_galois_keys_for_elements(self, galois_elements):
        """Sample the Galois key of each element not held yet."""
        q, p, n = tuple(self.params.q), tuple(self.params.p), self.params.n
        for elt in galois_elements:
            if elt not in self.glk.keys:
                self.glk.keys[elt] = K.gen_galois_key(self.rng, self.sk, elt, q, p, n,
                                                      self.device, self.params.word_bits)

    def gen_rotation_keys_for_rotations(self, rotations, swap_rows: bool = False, level=None):
        """Galois keys for the NAF power-of-two sub-rotations of each step,
        and with ``swap_rows`` the row key. ``level`` is accepted for the
        reference's signature: keys here serve every level."""
        n = self.params.n
        elts = [galois_elt_col(ss, n) for step in rotations for ss in col_sub_steps(step, n)]
        self.gen_galois_keys_for_elements(elts + ([galois_elt_row(n)] if swap_rows else []))

    def gen_rotation_keys(self, level=None):
        """The standard key set: every ±2^i column-rotation key and the row
        key, enough for any ``rotate_cols`` step and ``rotate_rows``."""
        steps = []
        i = 1
        while i < self.params.n // 2:
            steps += [i, -i]
            i *= 2
        self.gen_rotation_keys_for_rotations(steps, swap_rows=True, level=level)

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

    def encode_ringt(self, values):
        self._check_message(values, None)
        return self.engine.encode_ringt(values)

    def encode_mul(self, values, level=None):
        level = self.params.max_level if level is None else level
        self._check_message(values, level)
        return self.engine.encode_mul(values, level)

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

    # ---- rotations ----
    def _glk_for(self, elt: int):
        if elt not in self.glk.keys:
            raise RuntimeError(f'missing Galois key for element {elt}; call '
                               f'gen_rotation_keys_for_rotations first')
        return self.glk.keys[elt]

    def _rotate_unit(self, ct, step: int):
        elt = galois_elt_col(step, self.params.n)
        return self.engine.apply_galois(ct, elt, self._glk_for(elt))

    def rotate_cols(self, ct, steps: int):
        """Column rotation by ``steps`` as the NAF chain of ±2^i
        sub-rotations (each needs its key)."""
        out = ct
        for ss in col_sub_steps(steps, self.params.n):
            out = self._rotate_unit(out, ss)
        return out

    def rotate_rows(self, ct):
        elt = galois_elt_row(self.params.n)
        return self.engine.apply_galois(ct, elt, self._glk_for(elt))

    def advanced_rotate_cols(self, ct, steps):
        """Rotation with the key of the step itself; a list of steps returns
        {step: ct}, all sharing one hoisted decomposition."""
        if isinstance(steps, int):
            return self._rotate_unit(ct, steps)
        dct = self.engine.rns_sp_decomp(ct)
        out = {}
        for s in steps:
            elt = galois_elt_col(s, self.params.n)
            out[s] = self.engine.apply_galois_decomposed(dct, elt, self._glk_for(elt))
        return out
