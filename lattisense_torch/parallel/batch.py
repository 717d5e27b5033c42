"""Batched FHE pipelines on one device.

Port of the single-device part of ``lattisense_tpu/parallel/batch.py``: the
reference vmaps a single-ciphertext step and jits it; here the batch
dimension is written out — every engine op takes (B, ..., L, n) data — and
PyTorch runs the step eagerly.
"""

from ..schemes.types import Ciphertext, KeySwitchKey


def make_batched_step(engine, step_fn, level: int):
    """``step_fn(engine, a, b, keys) -> ct`` as a callable over raw tensors:
    f(a_data[B,2,L,n], b_data[B,2,L,n], keys) -> out_data[B,...]."""

    def batched(a, b, keys):
        return step_fn(engine, Ciphertext(data=a, level=level),
                       Ciphertext(data=b, level=level), keys).data

    return batched


def bfv_mult_relin(engine, a, b, keys):
    """BFV mult + relinearize (the reference's benchmark_cpu.cpp:27-51 op)."""
    return engine.relinearize(engine.mult(a, b), keys['rlk'])


def key_tree(context):
    """Context keys → the ``keys`` argument of a batched step."""
    rlk = context.rlk
    return {'rlk': KeySwitchKey(key_q=rlk.key_q, key_p=rlk.key_p, level=rlk.level,
                                sp_level=rlk.sp_level)}
