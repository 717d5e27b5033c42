"""Compiled task directories shipped with the port, and their arguments.

Each directory holds a ``mega_ag.json`` and a ``task_signature.json`` made by
the port's frontend (``lattisense_torch/frontend/``; ``python -m
tests.test_torch_task`` writes them, with the frontend's random node ids
mapped to ids in topological order; a test regenerates each and compares):

- ``bfv_mult_relin_x32_w32_n16384_l7``: 32 independent ``mult_relin``s,
  ``x{k}``, ``y{k}`` → ``z{k}``, on the primes and t of
  ``BfvParams.create_tpu_param(16384)`` at level 7;
- ``bfv_mult_rotate_w32_n16384_l7``: on the same chain and level, the
  plug-in tests' graph ``x``, ``y`` → ``w`` = rotate_cols(mult_relin(x, y),
  1), the arguments the C ABI client (``csrc/plugin_client.cpp``) passes;
- ``bfv_ops_mix_w32_n16384_l7``: on the same chain and level, one node or
  more of every BFV executor branch of ``FheTaskGpu`` but custom and
  bootstrap (``MIX_OUTPUTS``), with an offline input;
- ``bfv_ops_mix_u64_n16384_l3``: the same graph on ``BfvParams.create(16384)``
  at level 3;
- ``ckks_ops_mix_w32_n16384_l10``: on the primes of
  ``CkksParams.create_tpu_param(16384)`` at level 10, one node or more of
  every CKKS executor branch but custom and bootstrap (``CKKS_MIX_OUTPUTS``),
  with an offline input; at scale 2^36 (``CKKS_MIX_W32_SCALE``): at 2^30 the
  rotations' key-switch noise at n=16384 decodes 1e-2 off, and a pt_ringt's
  largest scaled coefficient (about 0.015·Δ for the mix's slots) must stay
  below the 31-bit primes;
- ``ckks_ops_mix_u64_n16384_l3``: the same graph on ``CkksParams.create(16384)``
  at level 3, scale 2^34;
- ``ckks_bootstrap_toy_n8192``: one bootstrap node, ``x`` at level 0 → ``z``,
  on the reference's toy bootstrap profile (``schemes/bootstrap_params.py``
  ``toy_profile()``: n = 8192, 25 q and 5 p primes, scale 2^40); its
  signature lists the Galois keys the frontend predicts and the switching
  keys ``swk_dts`` / ``swk_std``, so it runs on a ``CkksBtpContext``;
- ``ckks_bootstrap_u64_n256`` and ``ckks_bootstrap_w32_n256``: one bootstrap
  node at level 0 (u64) or 1 (w32) on the n = 256 chains of the JAX
  package's bootstrap tests (``bootstrap_n256``), for the card tests.

``mult_relin_arguments``, ``mix_arguments`` / ``ckks_mix_arguments`` and
``mix_expected`` / ``ckks_mix_expected`` make a task's arguments on a port
context and the slots each output decrypts to, computed in NumPy (float64
for CKKS).
"""

import json
import os
import re

import numpy as np
import torch

from ...schemes.types import Ciphertext, PlaintextRingt

HERE = os.path.dirname(os.path.abspath(__file__))
MULT_RELIN = 'bfv_mult_relin_x32_w32_n16384_l7'
MULT_ROTATE = 'bfv_mult_rotate_w32_n16384_l7'
MIX_W32 = 'bfv_ops_mix_w32_n16384_l7'
MIX_U64 = 'bfv_ops_mix_u64_n16384_l3'
CKKS_MIX_W32 = 'ckks_ops_mix_w32_n16384_l10'
CKKS_MIX_U64 = 'ckks_ops_mix_u64_n16384_l3'
CKKS_BOOTSTRAP_TOY = 'ckks_bootstrap_toy_n8192'
BOOTSTRAP_N256 = {64: 'ckks_bootstrap_u64_n256', 32: 'ckks_bootstrap_w32_n256'}
CKKS_MIX_W32_SCALE = 2.0 ** 36
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


_RANDOM_ID = re.compile(r'^[a-z]{12}$')


def normalize(path: str):
    """(mega_ag, signature) of the task directory ``path`` with the
    frontend's random node ids (12 lowercase letters, ``custom_task.py``
    ``random_id``) mapped to ids in topological order: data node i → 'd{i}',
    compute node i → 'op{i}' (the frontend numbers nodes as it creates them,
    after their inputs). The committed directories hold this form."""
    with open(os.path.join(path, 'mega_ag.json')) as f:
        mag = json.load(f)
    with open(os.path.join(path, 'task_signature.json')) as f:
        sig = json.load(f)
    for kind, prefix in (('data', 'd'), ('compute', 'op')):
        for idx, node in mag[kind].items():
            if kind == 'compute' or _RANDOM_ID.match(node['id']):
                node['id'] = f'{prefix}{idx}'
    return mag, sig


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


# ---- the CKKS op mix ------------------------------------------------------
CKKS_MIX_CTS = ('x', 'y', 'u0', 'u1', 'u2', 'u3')
CKKS_MIX_PTS = ('p0', 'p1')
CKKS_MIX_RINGTS = ('r0', 'r1')
CKKS_MIX_MULS = ('w0', 'w1')
CKKS_MIX_OFFLINE = 'v'
CKKS_MIX_OUTPUTS = ('o_add', 'o_add_pt', 'o_add_r', 'o_dbl', 'o_zero', 'o_sub_pt', 'o_sub_r',
                    'o_neg', 'o_rs', 'o_sq', 'o_mpt', 'o_mr', 'o_mw', 'o_mv', 'o_drop',
                    'o_cmp', 'o_cs', 'o_cac', 'o_rc', 'o_rr', 'o_ar', 'o_h')


def ckks_mix_messages(slots: int, seed: int) -> dict:
    """The CKKS op mix's complex slot vectors (real and imaginary parts
    uniform in [-1/2, 1/2)), from ``seed``."""
    rng = np.random.default_rng(seed)
    names = CKKS_MIX_CTS + CKKS_MIX_PTS + CKKS_MIX_RINGTS + CKKS_MIX_MULS + (CKKS_MIX_OFFLINE,)
    return {k: rng.uniform(-0.5, 0.5, slots) + 1j * rng.uniform(-0.5, 0.5, slots)
            for k in names}


def ckks_mix_arguments(context, level: int, msgs: dict, scale: float) -> tuple[dict, dict]:
    """(online, offline) arguments of the CKKS op mix at ``level``, every one
    encoded at ``scale``, on ``context``."""
    online = {k: context.encrypt(context.encode(msgs[k], level, scale=scale))
              for k in CKKS_MIX_CTS}
    online.update({k: context.encode(msgs[k], level, scale=scale) for k in CKKS_MIX_PTS})
    online.update({k: context.encode_ringt(msgs[k], scale=scale) for k in CKKS_MIX_RINGTS})
    online.update({k: context.encode_mul(msgs[k], level, scale=scale) for k in CKKS_MIX_MULS})
    return online, {CKKS_MIX_OFFLINE: context.encode_mul(msgs[CKKS_MIX_OFFLINE], level,
                                                         scale=scale)}


def ckks_mix_expected(msgs: dict) -> dict:
    """The slots each CKKS op-mix output decodes to, in float64 (lists for
    list outputs): column rotations roll the slot vector, the row rotation
    conjugates it."""
    m = msgs
    x, y, u = m['x'], m['y'], [m[f'u{i}'] for i in range(4)]
    p, r, w = (m['p0'], m['p1']), (m['r0'], m['r1']), (m['w0'], m['w1'])
    s = x + y
    return {
        'o_add': s, 'o_add_pt': [x + p[0], y + p[1]], 'o_add_r': y + r[1], 'o_dbl': 2 * x,
        'o_zero': 0 * x, 'o_sub_pt': x - p[0], 'o_sub_r': [x - r[0], y - r[1]], 'o_neg': -s,
        'o_rs': s * (x - y), 'o_sq': x * x, 'o_mpt': [x * p[0], y * p[1]],
        'o_mr': [x * r[0], y * r[1]], 'o_mw': [x * w[0], y * w[1]], 'o_mv': (x - y) * m['v'],
        'o_drop': x, 'o_cmp': u[0] * p[0] + u[1] * p[1] + u[2] * r[0] + u[3] * r[1],
        'o_cs': u[0] * p[0] + u[1] * p[1], 'o_cac': u[2] * r[0] + u[3] * r[1] + x * p[0],
        'o_rc': np.roll(s, -3), 'o_rr': [np.conj(x), np.conj(y)], 'o_ar': np.roll(x, -2),
        'o_h': [np.roll(y, -1), np.roll(y, -5)]}


def bootstrap_n256(word_bits: int) -> dict:
    """The n = 256 bootstrap chain of the JAX package's tests
    (tests/test_bootstrap.py) at either word: the primes, the scale, the
    bootstrapping configuration's fields, the context's seed and secret
    weight, and the input level (the chain's base level)."""
    from ...core.modring import gen_ntt_primes
    n = 256
    cfg = dict(cts_depth=3, stc_depth=3, k=16, sine_deg=30, double_angle=3)
    if word_bits == 64:
        q0 = gen_ntt_primes(n, 61, 1)
        q = q0 + gen_ntt_primes(n, 60, 22)
        p = gen_ntt_primes(n, 61, 3, exclude=tuple(q0))[1:]
        return dict(n=n, q=q, p=p, scale=float(1 << 45), cfg=cfg, seed=71, h=32, level=0)
    q = gen_ntt_primes(n, 31, 46)
    p = gen_ntt_primes(n, 31, 3, exclude=tuple(q))
    return dict(n=n, q=q, p=p, scale=float(1 << 30), seed=7, h=32, level=1,
                cfg=dict(cfg, message_ratio=8.0, arcsine=True))
