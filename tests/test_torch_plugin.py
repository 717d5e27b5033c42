"""lattisense_torch's ForeignTask held against lattisense_tpu's.

The task of ``tests/test_plugin.py`` (w = rotate_cols(mult_relin(x, y), 1))
is compiled by the JAX frontend; a foreign client holding only C structs
hands the same structs to both packages' ``ForeignTask`` (the port on the
CPU), whose outputs must be equal, with ``mf_nbits`` 64 and 0, on the
reference's 50-bit chain and on 31-bit primes. The signature errors are
the JAX package's strings, and a non-empty offline signature replaces the
online one. On the 32-bit word (``word_bits=32``) the port's ForeignTask
equals its own ``FheTask`` on a context of that word.
"""

import ctypes

import numpy as np
import pytest
import torch

from lattisense_tpu import abi as rabi
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.core.modring import get_rns_ring as ref_ring
from lattisense_tpu.frontend import custom_task as ctk
from lattisense_tpu.frontend.custom_task import BfvParam
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.plugin import ForeignTask as RefForeignTask
from lattisense_tpu.plugin import ForeignVectorArgument as RefArg
from lattisense_tpu.runtime import BfvContext as RefBfvContext

from lattisense_torch import abi
from lattisense_torch.core.modring import get_rns_ring
from lattisense_torch.params import BfvParams
from lattisense_torch.plugin import ForeignTask, ForeignVectorArgument
from lattisense_torch.runtime import BfvContext, FheTask

N, T, LEVEL = 64, 65537, 2


def chain(kind):
    if kind == 'u64':
        q = gen_ntt_primes(N, 50, 4)
        return q, gen_ntt_primes(N, 51, 2, exclude=tuple(q))
    primes = gen_ntt_primes(N, 31, 6)
    return primes[:4], primes[4:]


def compile_task(path, q, p, build):
    ctk.set_fhe_param(BfvParam.create_custom_param(N, list(q), list(p), T))
    ins, outs, offline = build()
    ctk.process_custom_task(ins, outs, output_instruction_path=str(path),
                            offline_input_args=offline)
    return str(path)


def mult_rotate():
    x, y = ctk.BfvCiphertextNode('x', LEVEL), ctk.BfvCiphertextNode('y', LEVEL)
    w = ctk.rotate_cols(ctk.mult_relin(x, y, 'z'), 1, 'w')
    return [ctk.Argument('x', x), ctk.Argument('y', y)], [ctk.Argument('w', w)], []


def offline_add():
    a, b = ctk.BfvCiphertextNode('a', LEVEL), ctk.BfvCiphertextNode('b', LEVEL)
    return [], [ctk.Argument('c', ctk.add(a, b, 'c'))], [ctk.Argument('a', a),
                                                          ctk.Argument('b', b)]


def port_struct(s):
    """The port's view of a JAX struct: the same memory, the port's type
    (what a foreign binary linked against either library hands over)."""
    return getattr(abi, type(s).__name__).from_address(ctypes.addressof(s))


class Client:
    """The foreign client: a JAX context of the 64-bit word, everything it
    hands out exported as C structs (kept alive here)."""

    def __init__(self, q, p, seed):
        self.params = RefBfvParams.create_custom(N, T, q, p)
        self.ctx = RefBfvContext.create_random_context(self.params, seed=seed)
        self.ctx.gen_rotation_keys_for_rotations([1])
        self.ring = ref_ring(tuple(q) + tuple(p), N)
        self.keep = []

    def ct(self, m, level=LEVEL):
        e = rabi.export_ciphertext(self.ctx.encrypt(self.ctx.encode(m, level)))
        self.keep.append(e)
        return e.struct

    def keys(self, mf_nbits):
        rlk = rabi.export_keyswitch_key(self.ctx.rlk, mf_nbits, self.ring)
        glk = rabi.export_galois_keys(self.ctx.glk.keys, mf_nbits, self.ring)
        self.keep += [rlk, glk]
        return rlk.struct, glk.struct


def run_both(ref_task, port_task, rlk, glk, args, mf_nbits):
    """Both tasks on the same structs → (reference outputs, port outputs,
    the error each raised)."""
    outs, errs = [], []
    for task, Arg, conv in ((ref_task, RefArg, lambda s: s), (port_task, ForeignVectorArgument,
                                                              port_struct)):
        try:
            outs.append(task.run(rlk=None if rlk is None else conv(rlk),
                                 glk=None if glk is None else conv(glk),
                                 args=[Arg(i, conv(s)) for i, s in args],
                                 mf_nbits=mf_nbits)[0])
            errs.append(None)
        except RuntimeError as exc:
            outs.append(None)
            errs.append(str(exc))
    return outs[0], outs[1], errs


def same_ct_struct(port_exp, ref_exp):
    a = rabi.import_ciphertext(ref_exp.struct)
    b = abi.import_ciphertext(port_exp.struct, device='cpu')
    np.testing.assert_array_equal(b.data.numpy().view(np.uint64), a.data)
    assert b.level == a.level


@pytest.fixture(scope='module')
def tasks(tmp_path_factory):
    out = {}
    for kind in ('u64', 'w32'):
        q, p = chain(kind)
        d = compile_task(tmp_path_factory.mktemp(f'task_{kind}'), q, p, mult_rotate)
        out[kind] = (q, p, d, RefForeignTask(d, mode='eager'),
                     ForeignTask(d, mode='eager', device='cpu'))
    return out


@pytest.mark.parametrize('kind', ['u64', 'w32'], ids=['chain_u64', 'chain_31bit'])
@pytest.mark.parametrize('mf_nbits', [64, 0])
def test_outputs_match_reference(tasks, kind, mf_nbits):
    q, p, _, ref_task, port_task = tasks[kind]
    client = Client(q, p, seed=77)
    rng = np.random.default_rng(3)
    m1, m2 = (rng.integers(0, T, N, dtype=np.uint64) for _ in range(2))
    rlk, glk = client.keys(mf_nbits)
    ref_out, port_out, errs = run_both(ref_task, port_task, rlk, glk,
                                       [('x', client.ct(m1)), ('y', client.ct(m2))], mf_nbits)
    assert errs == [None, None]
    same_ct_struct(port_out['w'], ref_out['w'])
    got = client.ctx.decrypt_decode(rabi.import_ciphertext(port_struct(port_out['w'].struct)))
    prod = (m1 * m2) % T
    np.testing.assert_array_equal(got, np.roll(prod.reshape(2, -1), -1, axis=1).reshape(-1))
    assert set(port_task.timing) == {'import_s', 'run_s', 'export_s'}


def test_signature_error_strings_match_reference(tasks):
    q, p, _, ref_task, port_task = tasks['u64']
    client = Client(q, p, seed=78)
    m = np.arange(N, dtype=np.uint64)
    good, bad = client.ct(m), client.ct(m, LEVEL - 1)
    rlk, glk = client.keys(64)
    cases = [
        (rlk, glk, [('x', bad), ('y', good)], 'For argument x, expected level is 2, but input '
                                              'level is 1.'),
        (rlk, glk, [('x', good)], 'expected 2 arguments, got 1.'),
        (rlk, glk, [('y', good), ('x', good)], 'For argument y, expected id is x, but input id '
                                               'is y.'),
        (None, glk, [('x', good), ('y', good)], 'Level of relin key is smaller than the '
                                                'expected level.'),
        (rlk, None, [('x', good), ('y', good)], 'Level of Galois key is smaller than the '
                                                'expected level.'),
    ]
    for rk, gk, args, msg in cases:
        _, _, errs = run_both(ref_task, port_task, rk, gk, args, 64)
        assert errs == [msg, msg]


def test_offline_signature_replaces_online(tmp_path):
    """A non-empty offline signature replaces the online one for argument
    checking (plug-in/SEAL/acc/check_sig.h:209-211), as in the JAX package."""
    q, p = chain('u64')
    d = compile_task(tmp_path, q, p, offline_add)
    ref_task, port_task = RefForeignTask(d, mode='eager'), ForeignTask(d, mode='eager',
                                                                       device='cpu')
    assert port_task.signature['offline']
    client = Client(q, p, seed=79)
    rng = np.random.default_rng(5)
    m1, m2 = (rng.integers(0, T, N, dtype=np.uint64) for _ in range(2))
    a, b = client.ct(m1), client.ct(m2)
    ref_out, port_out, errs = run_both(ref_task, port_task, None, None, [('a', a), ('b', b)], 0)
    assert errs == [None, None]
    same_ct_struct(port_out['c'], ref_out['c'])
    got = client.ctx.decrypt_decode(rabi.import_ciphertext(port_struct(port_out['c'].struct)))
    np.testing.assert_array_equal(got, (m1 + m2) % T)
    for args in ([('b', b), ('a', a)], [('a', client.ct(m1, LEVEL - 1)), ('b', b)]):
        _, _, errs = run_both(ref_task, port_task, None, None, args, 0)
        assert errs[0] is not None and errs == [errs[0], errs[0]]


@pytest.mark.parametrize('mf_nbits', [64, 0])
def test_word32_task_equals_fhe_task(tasks, mf_nbits):
    """``word_bits=32`` runs the task on the 32-bit word: the keys cross as
    stored (64) or plain (0), and the output equals the port's FheTask on a
    32-bit context holding the same keys."""
    q, p, d, _, _ = tasks['w32']
    ctx = BfvContext.create_random_context(BfvParams.create_custom(N, T, q, p, word_bits=32),
                                           seed=80, device='cpu')
    ctx.gen_rotation_keys_for_rotations([1])
    ring = get_rns_ring(tuple(q) + tuple(p), N, 'cpu', 32)
    rng = np.random.default_rng(6)
    m1, m2 = (rng.integers(0, T, N, dtype=np.uint64) for _ in range(2))
    x, y = (ctx.encrypt(ctx.encode(m, LEVEL)) for m in (m1, m2))
    rlk = abi.export_keyswitch_key(ctx.rlk, mf_nbits, ring)
    glk = abi.export_galois_keys(ctx.glk.keys, mf_nbits, ring)
    xs, ys = abi.export_ciphertext(x), abi.export_ciphertext(y)
    task = ForeignTask(d, mode='jit', device='cpu', word_bits=32)
    out, _ = task.run(rlk=rlk.struct, glk=glk.struct, mf_nbits=mf_nbits,
                      args=[ForeignVectorArgument('x', xs.struct),
                            ForeignVectorArgument('y', ys.struct)])
    want, _ = FheTask(d, mode='eager', device='cpu').run(ctx, {'x': x, 'y': y})
    got = abi.import_ciphertext(out['w'].struct, device='cpu')
    assert torch.equal(got.data, want['w'].data)
    prod = (m1 * m2) % T
    np.testing.assert_array_equal(ctx.decrypt_decode(got),
                                  np.roll(prod.reshape(2, -1), -1, axis=1).reshape(-1))
    # a second run with new key buffers reuses the task's key tensors
    keys = task._ctx.rlk.key_q
    rlk2 = abi.export_keyswitch_key(ctx.rlk, mf_nbits, ring)
    task.run(rlk=rlk2.struct, glk=glk.struct, mf_nbits=mf_nbits,
             args=[ForeignVectorArgument('x', xs.struct), ForeignVectorArgument('y', ys.struct)])
    assert task._ctx.rlk.key_q is keys
