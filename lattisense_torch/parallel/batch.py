"""Batched FHE pipelines on one device.

Port of the single-device part of ``lattisense_tpu/parallel/batch.py``: the
reference vmaps a single-ciphertext step and jits it; here the batch
dimension is written out — every engine op takes (B, ..., L, n) data — and
PyTorch runs the step eagerly.
"""

from ..params import CkksParams
from ..schemes.types import Ciphertext, KeySwitchKey


def make_batched_step(engine, step_fn, level: int, n_inputs: int = 2, is_ntt: bool = False):
    """``step_fn(engine, *cts, keys) -> ct`` as a callable over raw tensors:
    f(a_data[B,2,L,n], ..., keys) -> out_data[B,...] with ``n_inputs``
    ciphertext arguments before the keys. The inputs are wrapped at
    ``level`` in the domain ``is_ntt`` (CKKS: True) and at the parameter
    set's scale (BFV carries 1.0)."""
    scale = getattr(engine.params, 'scale', 1.0)

    def batched(*args):
        if len(args) != n_inputs + 1:
            raise TypeError(f'expected {n_inputs} ciphertext tensors and the keys, '
                            f'got {len(args)} arguments')
        cts = [Ciphertext(data=a, level=level, is_ntt=is_ntt, scale=scale)
               for a in args[:n_inputs]]
        return step_fn(engine, *cts, args[n_inputs]).data

    return batched


def bfv_mult_relin(engine, a, b, keys):
    """BFV mult + relinearize (the reference's benchmark_cpu.cpp:27-51 op)."""
    return engine.relinearize(engine.mult(a, b), keys['rlk'])


def ckks_mult_relin_rescale(engine, a, b, keys):
    """CKKS mult + relinearize + rescale (benchmark_cpu.cpp:53-78)."""
    return engine.rescale(engine.relinearize(engine.mult(a, b), keys['rlk']))


def ckks_mult_relin_rescale2(engine, a, b, keys):
    """CKKS mult + relinearize + two rescales: one multiplicative level on a
    composite chain of 31-bit primes (two primes a level, scale about
    2^60), the 32-bit word's counterpart of the u64 measurement."""
    return engine.rescale(ckks_mult_relin_rescale(engine, a, b, keys))


def ckks_composite_params(n: int = 16384) -> CkksParams:
    """The chain ``ckks_mult_relin_rescale2`` runs on: the 31-bit primes of
    ``CkksParams.create_tpu_param(n)`` at scale 2^60 (two primes a level),
    as the JAX package's ``bench.py`` measures it."""
    tpu = CkksParams.create_tpu_param(n)
    return CkksParams.create_custom(n, tpu.q, tpu.p, slots=n // 2, scale=2.0 ** 60,
                                    word_bits=32)


def make_rotate_step(galois_elt: int):
    """A one-input step applying the Galois automorphism ``galois_elt``
    (e.g. ``galois_elt_col(1, n)``: rotate_col by 1) with its key."""
    def rot(engine, a, keys):
        return engine.apply_galois(a, galois_elt, keys['glk'][galois_elt])
    return rot


def key_tree(context, galois_elts=()):
    """Context keys (BFV or CKKS) → the ``keys`` argument of a batched step:
    the relinearization key, and under ``'glk'`` the Galois keys of
    ``galois_elts``."""
    rlk = context.rlk
    tree = {'rlk': KeySwitchKey(key_q=rlk.key_q, key_p=rlk.key_p, level=rlk.level,
                                sp_level=rlk.sp_level)}
    if galois_elts:
        tree['glk'] = {e: context.glk.keys[e] for e in galois_elts}
    return tree
