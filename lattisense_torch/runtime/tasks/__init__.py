"""Compiled BFV task directories shipped with the port, and their arguments.

Each directory holds a ``mega_ag.json`` and a ``task_signature.json`` made by
the JAX package's frontend (``python -m tests.test_torch_task`` writes them,
with the frontend's random node ids mapped to ids in topological order; a
test regenerates each and compares):

- ``bfv_mult_relin_x32_w32_n16384_l7``: 32 independent ``mult_relin``s,
  ``x{k}``, ``y{k}`` → ``z{k}``, on the primes and t of
  ``BfvParams.create_tpu_param(16384)`` at level 7;
- ``bfv_ops_mix_w32_n16384_l7``: on the same chain and level, one node or
  more of every BFV executor branch of ``FheTaskGpu`` but custom and
  bootstrap (``MIX_OUTPUTS``), with an offline input;
- ``bfv_ops_mix_u64_n16384_l3``: the same graph on ``BfvParams.create(16384)``
  at level 3.

``mult_relin_arguments``, ``mix_arguments`` and ``mix_expected`` make a
task's arguments on a port context and the slots each output decrypts to,
computed in NumPy.
"""

import os

import numpy as np
import torch

from ...schemes.types import Ciphertext, PlaintextRingt

HERE = os.path.dirname(os.path.abspath(__file__))
MULT_RELIN = 'bfv_mult_relin_x32_w32_n16384_l7'
MIX_W32 = 'bfv_ops_mix_w32_n16384_l7'
MIX_U64 = 'bfv_ops_mix_u64_n16384_l3'
MULT_RELIN_COUNT = 32
# the op mix's ciphertext, plaintext (pt), pt_ringt and pt_mul arguments, its
# compressed pt_ringt of MIX_BLOCKS blocks and its offline pt_mul
MIX_CTS = ('x', 'y', 'u0', 'u1', 'u2', 'u3')
MIX_PTS = ('p0', 'p1')
MIX_RINGTS = ('r0', 'r1')
MIX_MULS = ('w0', 'w1')
MIX_BLOCKS = 4
MIX_OFFLINE = 'v'
MIX_OUTPUTS = ('o_add', 'o_add_pt', 'o_dbl', 'o_zero', 'o_sub_r', 'o_neg', 'o_rs', 'o_sq',
               'o_mpt', 'o_mr', 'o_mw', 'o_mv', 'o_cmp', 'o_cs', 'o_cac', 'o_rc', 'o_rr',
               'o_h', 'o_nt', 'o_inv', 'o_mf', 'o_mul')


def task_dir(name: str) -> str:
    return os.path.join(HERE, name)


def mult_relin_arguments(a_cts, b_cts) -> dict:
    """The mult_relin task's arguments: ``x{k}`` = a_cts[k], ``y{k}`` = b_cts[k]."""
    args = {f'x{k}': ct for k, ct in enumerate(a_cts)}
    args.update({f'y{k}': ct for k, ct in enumerate(b_cts)})
    return args


def mix_messages(t: int, n: int, seed: int) -> dict:
    """The op mix's slot vectors in [0, t), from ``seed``; 'c' holds the
    compressed plaintext's blocks."""
    rng = np.random.default_rng(seed)
    names = MIX_CTS + MIX_PTS + MIX_RINGTS + MIX_MULS + (MIX_OFFLINE,)
    msgs = {k: rng.integers(0, t, n) for k in names}
    msgs['c'] = rng.integers(0, t, (MIX_BLOCKS, n))
    return msgs


def mix_arguments(context, level: int, msgs: dict) -> tuple[dict, dict]:
    """(online, offline) arguments of the op mix at ``level`` on ``context``."""
    online = {k: context.encrypt(context.encode(msgs[k], level)) for k in MIX_CTS}
    online.update({k: context.encode(msgs[k], level) for k in MIX_PTS})
    online.update({k: context.encode_ringt(msgs[k]) for k in MIX_RINGTS})
    online.update({k: context.encode_mul(msgs[k], level) for k in MIX_MULS})
    online['c'] = PlaintextRingt(data=torch.stack(
        [context.encode_ringt(b).data for b in msgs['c']]))
    return online, {MIX_OFFLINE: context.encode_mul(msgs[MIX_OFFLINE], level)}


def _rot_col(m, step: int):
    half = len(m) // 2
    return np.concatenate([np.roll(m[:half], -step), np.roll(m[half:], -step)])


def _rot_row(m):
    half = len(m) // 2
    return np.concatenate([m[half:], m[:half]])


def mix_expected(msgs: dict, t: int) -> dict:
    """The slots each op-mix output decrypts to (lists for list outputs)."""
    m = {k: np.asarray(v, dtype=object) for k, v in msgs.items()}
    x, y, u, c = m['x'], m['y'], [m[f'u{i}'] for i in range(4)], m['c']
    s = x + y
    exp = {
        'o_add': s, 'o_add_pt': [x + m['p0'], y + m['p1']], 'o_dbl': 2 * x, 'o_zero': 0 * x,
        'o_sub_r': [x - m['r0'], y - m['r1']], 'o_neg': -s, 'o_rs': s * (x - y), 'o_sq': x * x,
        'o_mpt': [x * m['p0'], y * m['p1']], 'o_mr': [x * m['r0'], y * m['r1']],
        'o_mw': [x * m['w0'], y * m['w1']], 'o_mv': (x - y) * m['v'],
        'o_cmp': sum(u[i] * c[i] for i in range(MIX_BLOCKS)),
        'o_cs': u[0] * m['p0'] + u[1] * m['p1'], 'o_cac': u[2] * m['r0'] + u[3] * m['r1'] + x,
        'o_rc': _rot_col(s, 3), 'o_rr': [_rot_row(x), _rot_row(y)],
        'o_h': [_rot_col(y, 1), _rot_col(y, 5)], 'o_nt': _rot_col(x, 3),
        'o_inv': x, 'o_mf': x, 'o_mul': y}

    def mod(v):
        return [mod(e) for e in v] if isinstance(v, list) else (
            np.asarray(v, dtype=object) % t).astype(np.int64)
    return {k: mod(v) for k, v in exp.items()}


def coefficient_form(engine, ct: Ciphertext) -> Ciphertext:
    """An output ciphertext in the coefficient domain out of Montgomery form,
    as decryption takes it."""
    ring = engine.ring(ct.level)
    data = ct.data
    if ct.is_mform:
        data = ring.word.from_mont(data, ring.q, ring.pinv)
    if ct.is_ntt:
        return engine.to_inv_ntt(Ciphertext(data=data, level=ct.level, is_ntt=True))
    return Ciphertext(data=data, level=ct.level)
