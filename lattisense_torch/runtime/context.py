"""User-facing contexts: key ownership and the eager op facade.

Port of ``lattisense_tpu/runtime/context.py`` (after the reference SDK's
BfvContext and CkksContext, fhe_lib_v2.h:358-706, :831-1163). A context owns
the parameter set, the secret, public, relinearization, Galois and switching
keys, and exposes encode / encrypt / decrypt, the evaluation ops, the
rotations and serialization. ``FheContext`` holds what both schemes share;
``BfvContext`` and ``CkksContext`` pick the engine. A context runs on the
card unless created with ``device='cpu'``; keys from a seed equal the JAX
package's context keys for the same seed.

``make_public_context()`` drops the secret key for the server side of
client/server protocols.
"""

import numpy as np
import torch

from .. import resolve_device
from ..params import BfvParams
from ..schemes import keys as K
from ..schemes.bfv import BfvEngine
from ..schemes.ckks import CkksEngine
from ..schemes.galois import col_sub_steps, galois_elt_col, galois_elt_row
from ..schemes.types import GaloisKeys, KeySwitchKey, PublicKey
from ..utils.csprng import default_crypto_rng


class FheContext:
    """Keys and engine of either scheme on one device."""

    engine_cls = None

    def __init__(self, params, seed=None, device=None):
        self.params = params
        self.device = resolve_device(device)
        self.engine = self.engine_cls(params, self.device)
        # CSPRNG for all secret sampling (keys, noise, compressed-ct seeds)
        self.rng = default_crypto_rng(seed)
        self.sk = None
        self.pk = None
        self.rlk = None
        self.glk = GaloisKeys()
        self.swk = {}              # name -> KeySwitchKey

    # ---- key generation / import ----
    @classmethod
    def create_random_context(cls, params, seed=None, device=None) -> 'FheContext':
        """Sample sk/pk/rlk; deterministic when ``seed`` is given, with the
        same keys as ``lattisense_tpu``'s context of the same seed."""
        ctx = cls(params, seed, device)
        q, p, n, wb = tuple(params.q), tuple(params.p), params.n, params.word_bits
        ctx.sk = K.SecretKey(K.sample_ternary(ctx.rng, n))
        ctx.pk = K.gen_public_key(ctx.rng, ctx.sk, q, n, ctx.device, wb)
        ctx.rlk = K.gen_relin_key(ctx.rng, ctx.sk, q, p, n, ctx.device, wb)
        return ctx

    @classmethod
    def create_empty_context(cls, params, device=None) -> 'FheContext':
        """A context without keys (the server side before keys arrive)."""
        return cls(params, device=device)

    @classmethod
    def from_arrays(cls, params, sk, pk, rlk_key_q, rlk_key_p, device=None) -> 'FheContext':
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
        arr = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
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

    def make_public_context(self) -> 'FheContext':
        """An evaluation-only copy: public and evaluation keys, no secret key.
        The key containers are copied, so keys added later to either context
        stay out of the other."""
        pub = type(self)(self.params, device=self.device)
        pub.pk, pub.rlk = self.pk, self.rlk
        pub.glk = GaloisKeys(dict(self.glk.keys))
        pub.swk = dict(self.swk)
        return pub

    @property
    def is_public(self) -> bool:
        return self.sk is None

    # ---- serialization (byte-compatible with lattisense_tpu) ----
    def serialize(self) -> bytes:
        """The context's state without evaluation keys."""
        from ..utils.serialize import serialize_context
        return serialize_context(self, advanced=False)

    def serialize_advanced(self) -> bytes:
        """The context's state with the relinearization, Galois and switching keys."""
        from ..utils.serialize import serialize_context
        return serialize_context(self, advanced=True)

    @staticmethod
    def deserialize(blob: bytes, device=None) -> 'FheContext':
        from ..utils.serialize import deserialize_context
        return deserialize_context(blob, device)

    deserialize_advanced = deserialize

    def serialize_ciphertext(self, ct, n_drop_bit_0: int = 0, n_drop_bit_1: int = 0) -> bytes:
        from ..utils.serialize import serialize_ciphertext
        return serialize_ciphertext(ct, self.params, n_drop_bit_0, n_drop_bit_1)

    @staticmethod
    def deserialize_ciphertext(blob: bytes, device=None):
        from ..utils.serialize import deserialize_ciphertext
        return deserialize_ciphertext(blob, device)

    def encrypt_symmetric_compressed(self, pt, seed=None):
        self._require_sk('Context does not have sk and the corresponding encryptor.')
        return self.engine.encrypt_symmetric_compressed(self.rng, self.sk, pt, seed)

    def compressed_ciphertext_to_ciphertext(self, cct):
        return self.engine.decompress_ciphertext(cct)

    # ---- argument validation (reference-verbatim error strings) ----
    def _require_sk(self, msg: str):
        if self.sk is None:
            raise RuntimeError(msg)

    def _max_message_len(self) -> int:
        return self.params.n

    def _check_message(self, values, level):
        try:
            length = len(values)
        except TypeError:
            length = np.asarray(values).size
        if length == 0 or length > self._max_message_len():
            raise RuntimeError('Invalid message length.')
        if level is not None and not 0 <= level <= self.params.max_level:
            raise RuntimeError('Invalid level.')

    @staticmethod
    def _check_same_level(a, b):
        la, lb = getattr(a, 'level', None), getattr(b, 'level', None)
        if la is not None and lb is not None and la != lb:
            raise RuntimeError('x0 and x1 have different levels.')

    # ---- encode / encrypt / decrypt ----
    def encode(self, values, level=None, **kw):
        level = self.params.max_level if level is None else level
        self._check_message(values, level)
        return self.engine.encode(values, level, **kw)

    def encode_ringt(self, values, **kw):
        self._check_message(values, None)
        return self.engine.encode_ringt(values, **kw)

    def encode_mul(self, values, level=None, **kw):
        level = self.params.max_level if level is None else level
        self._check_message(values, level)
        return self.engine.encode_mul(values, level, **kw)

    def encrypt(self, pt):
        return self.engine.encrypt_asymmetric(self.rng, self.pk, pt)

    def encrypt_symmetric(self, pt):
        self._require_sk('Context does not have sk and the corresponding encryptor.')
        return self.engine.encrypt_symmetric(self.rng, self.sk, pt)

    def decrypt(self, ct):
        self._require_sk('Context does not have sk and decryptor.')
        return self.engine.decrypt(self.sk, ct)

    def decrypt_decode(self, ct):
        self._require_sk('Context does not have sk and decryptor.')
        return self.engine.decrypt_decode(self.sk, ct)

    # ---- evaluation ----
    def add(self, a, b):
        self._check_same_level(a, b)
        return self.engine.add(a, b)

    def sub(self, a, b):
        self._check_same_level(a, b)
        return self.engine.sub(a, b)

    def neg(self, a):
        return self.engine.neg(a)

    def mult(self, a, b):
        self._check_same_level(a, b)
        return self.engine.mult(a, b)

    def relinearize(self, ct3):
        if self.rlk is None:
            raise RuntimeError('Context does not have a relinearization key.')
        return self.engine.relinearize(ct3, self.rlk)

    def mult_relin(self, a, b):
        return self.relinearize(self.mult(a, b))

    def rescale(self, ct, *a, **kw):
        return self.engine.rescale(ct, *a, **kw)

    def get_coeff(self, ct, poly_idx: int, limb: int, coeff_idx: int) -> int:
        """One raw RNS coefficient (reference BfvCiphertext::get_coeff)."""
        return int(ct.data[poly_idx, limb, coeff_idx])

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


class BfvContext(FheContext):
    """BFV keys + engine on one device (reference: fhe_lib_v2.h BfvContext)."""

    engine_cls = BfvEngine

    def mult_scalar(self, ct, scalar: int):
        return self.engine.mult_scalar(ct, scalar)

    def encode_coeffs(self, coeffs, level=None):
        level = self.params.max_level if level is None else level
        return self.engine.encode_coeffs(coeffs, level)

    def encode_coeffs_ringt(self, coeffs):
        return self.engine.encode_coeffs_ringt(coeffs)

    def encode_coeffs_mul(self, coeffs, level=None):
        level = self.params.max_level if level is None else level
        return self.engine.encode_coeffs_mul(coeffs, level)

    def decrypt_coeffs(self, ct):
        self._require_sk('Context does not have sk and decryptor.')
        return self.engine.decrypt_coeffs(self.sk, ct)

    def noise_budget(self, ct) -> float:
        """Remaining invariant-noise budget of ``ct`` in bits (SEAL semantics:
        decryption is reliable while positive); needs the secret key."""
        if self.sk is None:
            raise RuntimeError('noise_budget requires the secret key')
        return self.engine.noise_budget(self.sk, ct)


class CkksContext(FheContext):
    """CKKS keys + engine on one device (reference: fhe_lib_v2.h CkksContext).

    ``conjugate``, ``drop_level``, ``set_log_slots`` and ``mult_scalar`` are
    the JAX package's ``CkksBtpContext`` methods that need no bootstrapping;
    the polynomial activations and ``create_bootstrapper`` / ``bootstrap``
    are the reference's ``CkksContext`` methods."""

    engine_cls = CkksEngine

    def _max_message_len(self) -> int:
        return self.params.slots

    def conjugate(self, ct):
        return self.rotate_rows(ct)

    def drop_level(self, ct, levels: int = 1):
        return self.engine.drop_level(ct, levels)

    def set_log_slots(self, log_slots: int):
        self.params.set_log_slots(log_slots)

    def mult_scalar(self, ct, scalar: float):
        return self.engine.mult_scalar(ct, scalar)

    def poly_eval_relu_function(self, ct, degree: int = 15, bound: float = 1.0):
        """Polynomial ReLU activation (reference poly_eval_relu_function,
        fhe_lib_v2.h:1101)."""
        from ..schemes.poly_eval import poly_eval_relu
        return poly_eval_relu(self.engine, ct, self.rlk, degree, bound)

    def poly_eval_step_function(self, ct, degree: int = 15, bound: float = 1.0):
        """Polynomial step activation (reference poly_eval_step_function)."""
        from ..schemes.poly_eval import poly_eval_step
        return poly_eval_step(self.engine, ct, self.rlk, degree, bound)

    def create_bootstrapper(self, config=None):
        """Build the bootstrap precompute and its Galois keys (reference
        CkksBtpContext::create_bootstrapper, fhe_lib_v2.h:1216)."""
        from ..schemes.bootstrap import CkksBootstrapper
        btp = CkksBootstrapper(self.engine, config)
        self.gen_galois_keys_for_elements(btp.galois_elements())
        self.engine.bootstrapper = btp
        return btp

    def bootstrap(self, ct):
        btp = self.engine.bootstrapper
        if btp is None:
            raise RuntimeError('call create_bootstrapper() first')
        return btp(ct, self.rlk, self.glk.keys, swk_dts=self.swk.get('swk_dts'),
                   swk_std=self.swk.get('swk_std'))


class CkksBtpContext(CkksContext):
    """A CKKS context with bootstrapping made at creation (reference
    CkksBtpContext, fhe_lib_v2.h:1173-1217). Two secrets: the dense
    evaluation secret and a sparse bootstrapping secret of weight h (the
    reference's parameter sets use H192), bridged by the switching keys
    ``swk['swk_dts']`` (dense to sparse) and ``swk['swk_std']`` (sparse to
    dense). One seed gives the JAX package's keys, both secrets included."""

    @classmethod
    def create_random_context(cls, params, seed=None, h: int = 192, btp_config=None,
                              device=None) -> 'CkksBtpContext':
        ctx = cls(params, seed, device)
        q, p, n, wb = tuple(params.q), tuple(params.p), params.n, params.word_bits
        dev = ctx.device
        ctx.sk = K.SecretKey(K.sample_ternary(ctx.rng, n))
        ctx.pk = K.gen_public_key(ctx.rng, ctx.sk, q, n, dev, wb)
        ctx.rlk = K.gen_relin_key(ctx.rng, ctx.sk, q, p, n, dev, wb)
        ctx.sk_sparse = K.SecretKey(K.sample_ternary(ctx.rng, n, h=min(h, n // 4)))
        # swk_dts re-keys dense to sparse (it encrypts s_dense under s_sparse),
        # swk_std sparse to dense
        ctx.swk['swk_dts'] = K.gen_keyswitch_key(
            ctx.rng, ctx.sk_sparse, lambda mods: ctx.sk.ntt_form(tuple(mods), n, dev, wb),
            q, p, n, dev, wb)
        ctx.swk['swk_std'] = K.gen_keyswitch_key(
            ctx.rng, ctx.sk, lambda mods: ctx.sk_sparse.ntt_form(tuple(mods), n, dev, wb),
            q, p, n, dev, wb)
        ctx.create_bootstrapper(btp_config)
        return ctx


def create_context_for_params(params, seed=None, random: bool = True, device=None):
    """A BFV or CKKS context for ``params``: with keys from ``seed`` when
    ``random``, else empty."""
    cls = BfvContext if isinstance(params, BfvParams) else CkksContext
    return (cls.create_random_context(params, seed, device) if random
            else cls(params, device=device))
