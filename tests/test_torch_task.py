"""lattisense_torch's compiled-task runtime held bit for bit against lattisense_tpu.

Task directories are made with the port's frontend
(``lattisense_torch/frontend/``), which writes the JAX package's frontend's
bytes (``tests/test_torch_frontend.py``). The port's ``FheTask(dir, mode=m,
device='cpu')``, m in {eager, jit}, must give the same output data as the
reference's ``FheTaskTpu(dir, mode='eager')`` (NumPy) on the same keys
(carried across by ``BfvContext.from_arrays`` and ``add_galois_key_arrays``)
and the same arguments, at both words, over every BFV executor branch (the
op mix of ``lattisense_torch.runtime.tasks``) and every CKKS one (its CKKS op
mix, whose outputs carry the scales the reference gives them and decode
within 1e-3 of the float64 slots). Also: the fused plan, the
``check_sig`` messages, offline inputs, a custom executor, the refusals, and
the committed task directories against their regeneration.

``python -m tests.test_torch_task`` (from the repository root) writes the
committed directories under ``lattisense_torch/runtime/tasks/``.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lattisense_tpu.core.modring import gen_ntt_primes as ref_primes
from lattisense_tpu.params import BfvParams as RefBfvParams
from lattisense_tpu.params import CkksParams as RefCkksParams
from lattisense_tpu.runtime import BfvContext as RefContext
from lattisense_tpu.runtime import CkksContext as RefCkksContext
from lattisense_tpu.runtime import FheTaskTpu
from lattisense_tpu.schemes.types import PlaintextRingt as RefRingt

from lattisense_torch.frontend import custom_task as ct
from lattisense_torch.params import BfvParams, CkksParams
from lattisense_torch.runtime import BfvContext, CkksContext, FheTask, FheTaskGpu
from lattisense_torch.schemes.ckks import CkksEngine
from lattisense_torch.runtime import tasks as fixtures
from lattisense_torch.schemes.types import (Ciphertext, Plaintext, PlaintextMul,
                                            PlaintextRingt)

N = 256
T_MOD = 65537
LEVEL = 3


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    """The n=256 bootstraps are tens of thousands of small tensor ops; with
    one intra-op thread each, parallel test workers do not oversubscribe the
    cores (under six workers with a thread per core each, a bootstrap ran
    60 times slower than alone)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

# ---------------------------------------------------------------------------
# the task graphs (the committed directories are these at full width)
# ---------------------------------------------------------------------------


def build_mult_relin(level: int, count: int):
    ins, outs = [], []
    for k in range(count):
        x = ct.BfvCiphertextNode(f'x{k}', level)
        y = ct.BfvCiphertextNode(f'y{k}', level)
        outs.append(ct.mult_relin(x, y, f'z{k}'))
        ins += [x, y]
    return ([ct.Argument(nd.id, nd) for nd in ins],
            [ct.Argument(f'z{k}', o) for k, o in enumerate(outs)], [])


def build_mult_rotate(level: int):
    """The plug-in tests' graph (``tests/test_plugin.py``): w = rotate_cols(
    mult_relin(x, y), 1), the arguments the C ABI client passes."""
    x = ct.BfvCiphertextNode('x', level)
    y = ct.BfvCiphertextNode('y', level)
    w = ct.rotate_cols(ct.mult_relin(x, y, 'z'), 1, 'w')
    return [ct.Argument('x', x), ct.Argument('y', y)], [ct.Argument('w', w)], []


def build_ops_mix(level: int):
    """Every BFV executor branch but custom and bootstrap: add / sub with a
    ciphertext, a plaintext, a pt_ringt and unary; neg; mult by a
    ciphertext, itself, a pt, a pt_ringt, a pt_mul, an offline pt_mul and
    compressed pt_ringt blocks; relin; rescale; rotate_col (a NAF chain,
    hoisted after rns_sp_decomp, NTT-form in and out) and rotate_row;
    cmp_sum and cmpac_sum (plain and compressed); to_ntt, to_inv_ntt, to_mf
    and to_mul. Pairs of like nodes in one wave fuse in the jit plan."""
    L = level
    x, y = ct.BfvCiphertextNode('x', L), ct.BfvCiphertextNode('y', L)
    u = [ct.BfvCiphertextNode(f'u{i}', L) for i in range(4)]
    p = [ct.BfvPlaintextNode(f'p{i}', L) for i in range(2)]
    r = [ct.BfvPlaintextRingtNode(f'r{i}') for i in range(2)]
    w = [ct.BfvPlaintextMulNode(f'w{i}', L) for i in range(2)]
    c = ct.BfvCompressedPlaintextRingtNode('c', compressed_block_info=list(range(
        fixtures.MIX_BLOCKS)))
    v = ct.BfvPlaintextMulNode(fixtures.MIX_OFFLINE, L)
    a = ct.add(x, y)
    e = ct.sub(x, y)
    t1 = ct.to_ntt(x)
    r1 = ct.advanced_rotate_cols(x, [1], out_ct_type='ct-ntt')[0]
    outs = {
        'o_add': a, 'o_add_pt': [ct.add(x, p[0]), ct.add(y, p[1])], 'o_dbl': ct.add(x, x),
        'o_zero': ct.sub(y, y), 'o_sub_r': [ct.sub(x, r[0]), ct.sub(y, r[1])],
        'o_neg': ct.neg(a), 'o_rs': ct.rescale(ct.mult_relin(a, e)),
        'o_sq': ct.mult_relin(x, x), 'o_mpt': [ct.mult(x, p[0]), ct.mult(y, p[1])],
        'o_mr': [ct.mult(x, r[0]), ct.mult(y, r[1])],
        'o_mw': [ct.mult(x, w[0]), ct.mult(y, w[1])], 'o_mv': ct.mult(e, v),
        'o_cmp': ct.ct_pt_mult_accumulate(u, c),
        'o_cs': ct.ct_pt_mult_accumulate_slice(u[:2], p),
        'o_cac': ct.ct_pt_mult_accumulate_add_ct_slice(u[2:] + [x], r),
        'o_rc': ct.rotate_cols(a, [3])[0], 'o_rr': [ct.rotate_rows(x), ct.rotate_rows(y)],
        'o_h': ct.advanced_rotate_cols(y, [1, 5], rot_type='hoisted'),
        'o_nt': ct.advanced_rotate_cols(r1, [2], out_ct_type='ct-ntt-mf')[0],
        'o_inv': ct.to_inv_ntt(t1), 'o_mf': ct.to_mform(t1), 'o_mul': ct.to_mul(y)}
    assert tuple(outs) == fixtures.MIX_OUTPUTS
    ins = [x, y] + u + p + r + w + [c]
    return ([ct.Argument(nd.id, nd) for nd in ins],
            [ct.Argument(k, o) for k, o in outs.items()], [ct.Argument(v.id, v)])


def build_ckks_ops_mix(level: int):
    """Every CKKS executor branch but custom and bootstrap: add / sub with a
    ciphertext, a plaintext, a pt_ringt and unary; neg; mult by a
    ciphertext, itself, a pt, a pt_ringt, a pt_mul and an offline pt_mul;
    relin; rescale; drop_level; rotate_col (a NAF chain, by its own key,
    hoisted after rns_sp_decomp) and rotate_row (conjugation); cmp_sum and
    cmpac_sum. Pairs of like nodes in one wave fuse in the jit plan."""
    L = level
    x, y = ct.CkksCiphertextNode('x', L), ct.CkksCiphertextNode('y', L)
    u = [ct.CkksCiphertextNode(f'u{i}', L) for i in range(4)]
    p = [ct.CkksPlaintextNode(f'p{i}', L) for i in range(2)]
    r = [ct.CkksPlaintextRingtNode(f'r{i}') for i in range(2)]
    w = [ct.CkksPlaintextMulNode(f'w{i}', L) for i in range(2)]
    v = ct.CkksPlaintextMulNode(fixtures.CKKS_MIX_OFFLINE, L)
    a = ct.add(x, y)
    e = ct.sub(x, y)
    outs = {
        'o_add': a, 'o_add_pt': [ct.add(x, p[0]), ct.add(y, p[1])], 'o_add_r': ct.add(y, r[1]),
        'o_dbl': ct.add(x, x), 'o_zero': ct.sub(y, y), 'o_sub_pt': ct.sub(x, p[0]),
        'o_sub_r': [ct.sub(x, r[0]), ct.sub(y, r[1])], 'o_neg': ct.neg(a),
        'o_rs': ct.rescale(ct.mult_relin(a, e)), 'o_sq': ct.rescale(ct.mult_relin(x, x)),
        'o_mpt': [ct.rescale(ct.mult(x, p[0])), ct.rescale(ct.mult(y, p[1]))],
        'o_mr': [ct.rescale(ct.mult(x, r[0])), ct.rescale(ct.mult(y, r[1]))],
        'o_mw': [ct.rescale(ct.mult(x, w[0])), ct.rescale(ct.mult(y, w[1]))],
        'o_mv': ct.rescale(ct.mult(e, v)), 'o_drop': ct.drop_level(x, 2),
        'o_cmp': ct.ct_pt_mult_accumulate(u, p + r),
        'o_cs': ct.ct_pt_mult_accumulate_slice(u[:2], p),
        'o_cac': ct.ct_pt_mult_accumulate_add_ct_slice(u[2:] + [ct.mult(x, p[0])], r),
        'o_rc': ct.rotate_cols(a, [3])[0], 'o_rr': [ct.rotate_rows(x), ct.rotate_rows(y)],
        'o_ar': ct.advanced_rotate_cols(x, [2])[0],
        'o_h': ct.advanced_rotate_cols(y, [1, 5], rot_type='hoisted')}
    assert tuple(outs) == fixtures.CKKS_MIX_OUTPUTS
    ins = [x, y] + u + p + r + w
    return ([ct.Argument(nd.id, nd) for nd in ins],
            [ct.Argument(k, o) for k, o in outs.items()], [ct.Argument(v.id, v)])


def build_bootstrap(level: int):
    """One bootstrap node: ``x`` at ``level`` → ``z``."""
    x = ct.CkksCiphertextNode('x', level)
    return [ct.Argument('x', x)], [ct.Argument('z', ct.bootstrap(x, 'z'))], []


def gen_task(fe_param, build, path, *args) -> str:
    ct.set_fhe_param(fe_param)
    ins, outs, offline = build(*args)
    ct.process_custom_task(input_args=ins, output_args=outs, offline_input_args=offline,
                           output_instruction_path=str(path))
    return str(path)


normalize = fixtures.normalize


def committed_fixtures():
    """name → (frontend parameter, build function, its arguments)."""
    w32 = RefBfvParams.create_tpu_param(16384)
    u64 = RefBfvParams.create(16384)
    ckks_w32 = RefCkksParams.create_tpu_param(16384)
    ckks_u64 = RefCkksParams.create(16384)

    def fe(params):
        return ct.BfvParam.create_custom_param(n=params.n, q=list(params.q),
                                               p=list(params.p), t=params.t)

    def fe_ckks(params, scale):
        return ct.CkksParam.create_custom_param(params.n, list(params.q), list(params.p),
                                                slots=params.slots, scale=scale)
    return {
        fixtures.MULT_RELIN: (fe(w32), build_mult_relin, (7, fixtures.MULT_RELIN_COUNT)),
        fixtures.MIX_W32: (fe(w32), build_ops_mix, (7,)),
        fixtures.MULT_ROTATE: (fe(w32), build_mult_rotate, (7,)),
        fixtures.MIX_U64: (fe(u64), build_ops_mix, (3,)),
        fixtures.CKKS_MIX_W32: (fe_ckks(ckks_w32, fixtures.CKKS_MIX_W32_SCALE),
                                build_ckks_ops_mix, (10,)),
        fixtures.CKKS_MIX_U64: (fe_ckks(ckks_u64, ckks_u64.scale), build_ckks_ops_mix, (3,)),
        fixtures.CKKS_BOOTSTRAP_TOY: (ct.CkksBtpParam.create_toy_param(), build_bootstrap, (0,)),
        **{fixtures.BOOTSTRAP_N256[w]: (fe_btp256(w), build_bootstrap, (0,)) for w in (64, 32)},
    }


def fe_btp256(word_bits: int):
    """The frontend parameter of the n=256 bootstrap chain of the word."""
    b = fixtures.bootstrap_n256(word_bits)
    cfg = b['cfg']
    return ct.CkksBtpParam.create_custom_param(
        n=b['n'], q=b['q'], p=b['p'], slots=b['n'] // 2, scale=b['scale'],
        cts_depth=cfg['cts_depth'], stc_depth=cfg['stc_depth'], eval_mod_k=cfg['k'],
        sine_deg=cfg['sine_deg'], double_angle=cfg['double_angle'], btp_output_level=3)


def lift_input_level(mag: dict, sig: dict, level: int):
    """Move a bootstrap task's input ``x`` from level 0 to ``level``: the
    frontend takes a bootstrap input at level 0 only, and on the 32-bit word
    the base level is 1 (two limbs a level), where ``CkksBootstrapper``
    starts."""
    for node in mag['data'].values():
        if node['id'] == 'x':
            node['level'] = level
    for row in sig['online']:
        if row['id'] == 'x':
            row['level'] = level


def write_fixture(name: str, path: str):
    fe, build, args = committed_fixtures()[name]
    gen_task(fe, build, path, *args)
    mag, sig = normalize(path)
    if name == fixtures.BOOTSTRAP_N256[32]:
        lift_input_level(mag, sig, fixtures.bootstrap_n256(32)['level'])
    for fname, obj in (('mega_ag.json', mag), ('task_signature.json', sig)):
        with open(os.path.join(path, fname), 'w', encoding='utf-8') as f:
            json.dump(obj, f, indent=1)
            f.write('\n')


@pytest.mark.parametrize('name', [fixtures.MULT_RELIN, fixtures.MULT_ROTATE, fixtures.MIX_W32,
                                  fixtures.MIX_U64,
                                  fixtures.CKKS_MIX_W32, fixtures.CKKS_MIX_U64,
                                  fixtures.CKKS_BOOTSTRAP_TOY, *fixtures.BOOTSTRAP_N256.values()])
def test_committed_fixture_matches_regeneration(name, tmp_path):
    write_fixture(name, str(tmp_path))
    assert normalize(str(tmp_path)) == normalize(fixtures.task_dir(name))
    # the committed directory loads, binds every node, and fuses as built
    task = FheTask(fixtures.task_dir(name), mode='jit', device='cpu')
    if name == fixtures.MULT_RELIN:
        assert len(task.plan) == 2


# ---------------------------------------------------------------------------
# parity with the reference runtime at small n, both words
# ---------------------------------------------------------------------------

def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def to_port(v):
    """A reference argument → the port's carrier, on the CPU."""
    if isinstance(v, list):
        return [to_port(e) for e in v]
    name = type(v).__name__
    if name == 'Ciphertext':
        return Ciphertext(data=T(v.data), level=v.level, is_ntt=v.is_ntt, is_mform=v.is_mform,
                          scale=v.scale)
    if name == 'Plaintext':
        return Plaintext(data=T(v.data), level=v.level, is_ntt=v.is_ntt, scale=v.scale)
    if name == 'PlaintextRingt':
        return PlaintextRingt(data=T(v.data), scale=v.scale)
    assert name == 'PlaintextMul', name
    return PlaintextMul(data=T(v.data), level=v.level, scale=v.scale)


def chain(word: int):
    if word == 32:
        primes = ref_primes(N, 31, 7)
        return primes[:5], primes[5:]
    q = ref_primes(N, 50, 5)
    return q, ref_primes(N, 51, 1, exclude=tuple(q))


@pytest.fixture(scope='module', params=[32, 64], ids=['w32', 'u64'])
def setup(request, tmp_path_factory):
    """A reference context with every Galois key the op mix needs, a port
    context on the CPU with the same keys, and the op-mix task directory."""
    word = request.param
    q, p = chain(word)
    fe = ct.BfvParam.create_custom_param(n=N, q=list(q), p=list(p), t=T_MOD)
    mix = gen_task(fe, build_ops_mix, tmp_path_factory.mktemp(f'mix{word}'), LEVEL)
    mr = gen_task(fe, build_mult_relin, tmp_path_factory.mktemp(f'mr{word}'), LEVEL, 8)
    with open(os.path.join(mix, 'task_signature.json')) as f:
        elts = [int(e) for e in json.load(f)['key']['glk']]
    ref = RefContext.create_random_context(
        RefBfvParams.create_custom(N, T_MOD, q, p, word_bits=word), seed=41)
    ref.gen_galois_keys_for_elements(elts)
    port = BfvContext.from_arrays(BfvParams.create_custom(N, T_MOD, q, p, word_bits=word),
                                  ref.sk.coeffs, ref.pk.data, ref.rlk.key_q, ref.rlk.key_p,
                                  device='cpu')
    for elt, k in ref.glk.keys.items():
        port.add_galois_key_arrays(elt, k.key_q, k.key_p)
    return {'word': word, 'ref': ref, 'port': port, 'mix': mix, 'mult_relin': mr, 'fe': fe}


def ref_mix_arguments(ref, seed):
    msgs = fixtures.mix_messages(T_MOD, N, seed)
    online = {k: ref.encrypt(ref.encode(msgs[k], LEVEL)) for k in fixtures.MIX_CTS}
    online.update({k: ref.encode(msgs[k], LEVEL) for k in fixtures.MIX_PTS})
    online.update({k: ref.encode_ringt(msgs[k]) for k in fixtures.MIX_RINGTS})
    online.update({k: ref.encode_mul(msgs[k], LEVEL) for k in fixtures.MIX_MULS})
    online['c'] = RefRingt(data=np.stack([ref.encode_ringt(b).data for b in msgs['c']]))
    offline = {fixtures.MIX_OFFLINE: ref.encode_mul(msgs[fixtures.MIX_OFFLINE], LEVEL)}
    return msgs, online, offline


def flat(v):
    return [e for x in v for e in flat(x)] if isinstance(v, list) else [v]


def same(port_out, ref_out):
    return all(np.array_equal(a.data.numpy().astype(np.uint64),
                              np.asarray(b.data).astype(np.uint64))
               and (a.level, a.is_ntt, a.is_mform, a.scale) == (b.level, b.is_ntt, b.is_mform,
                                                                 b.scale)
               for a, b in zip(flat(port_out), flat(ref_out)))


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_op_mix_matches_reference(setup, mode):
    ref, port = setup['ref'], setup['port']
    msgs, online, offline = ref_mix_arguments(ref, 5)
    want, _ = FheTaskTpu(setup['mix'], mode='eager').run(ref, {**online, **offline})
    task = FheTask(setup['mix'], mode=mode, device='cpu')
    task.preload(port, {k: to_port(v) for k, v in offline.items()})
    got, dur_ns = task.run(port, {k: to_port(v) for k, v in online.items()})
    assert dur_ns > 0 and task.engine.word_bits == setup['word']
    assert set(got) == set(fixtures.MIX_OUTPUTS)
    bad = [k for k in fixtures.MIX_OUTPUTS if not same(got[k], want[k])]
    assert bad == []
    # and each output decrypts to its NumPy plaintext
    expected = fixtures.mix_expected(msgs, T_MOD)
    for k in fixtures.MIX_OUTPUTS:
        for out, m in zip(flat(got[k]), flat(expected[k])):
            pt = port.decrypt_decode(fixtures.coefficient_form(port.engine, out))
            assert np.array_equal(pt, m), k


def ckks_chain(word: int):
    """(q, p, scale) at n=N: 31-bit primes at the 32-bit word; a 60-bit q0,
    40-bit primes and a 60-bit special prime at the 64-bit word."""
    if word == 32:
        primes = ref_primes(N, 31, 7)
        return primes[:5], primes[5:], float(1 << 30)
    big = ref_primes(N, 60, 2)
    return [big[0]] + ref_primes(N, 40, 4), [big[1]], float(1 << 40)


@pytest.fixture(scope='module', params=[32, 64], ids=['w32', 'u64'])
def ckks_setup(request, tmp_path_factory):
    """The CKKS op-mix task at n=N, a reference context with its Galois
    keys and a port context on the CPU with the same keys."""
    word = request.param
    q, p, scale = ckks_chain(word)
    fe = ct.CkksParam.create_custom_param(N, list(q), list(p), scale=scale)
    mix = gen_task(fe, build_ckks_ops_mix, tmp_path_factory.mktemp(f'ckks{word}'), LEVEL)
    with open(os.path.join(mix, 'task_signature.json')) as f:
        elts = [int(e) for e in json.load(f)['key']['glk']]
    ref = RefCkksContext.create_random_context(
        RefCkksParams.create_custom(N, q, p, scale=scale, word_bits=word), seed=43)
    ref.gen_galois_keys_for_elements(elts)
    port = CkksContext.from_arrays(CkksParams.create_custom(N, q, p, scale=scale, word_bits=word),
                                   ref.sk.coeffs, ref.pk.data, ref.rlk.key_q, ref.rlk.key_p,
                                   device='cpu')
    for elt, k in ref.glk.keys.items():
        port.add_galois_key_arrays(elt, k.key_q, k.key_p)
    return {'word': word, 'ref': ref, 'port': port, 'mix': mix, 'scale': scale}


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_ckks_op_mix_matches_reference(ckks_setup, mode):
    """Every output equals the reference's eager NumPy run bit for bit, with
    its level and scale, and decodes within 1e-3 of its float64 slots."""
    ref, port, scale = ckks_setup['ref'], ckks_setup['port'], ckks_setup['scale']
    msgs = fixtures.ckks_mix_messages(N // 2, 5)
    online, offline = fixtures.ckks_mix_arguments(ref, LEVEL, msgs, scale)
    want, _ = FheTaskTpu(ckks_setup['mix'], mode='eager').run(ref, {**online, **offline})
    task = FheTask(ckks_setup['mix'], mode=mode, device='cpu')
    task.preload(port, {k: to_port(v) for k, v in offline.items()})
    got, _ = task.run(port, {k: to_port(v) for k, v in online.items()})
    assert isinstance(task.engine, CkksEngine) and task.engine.word_bits == ckks_setup['word']
    assert set(got) == set(fixtures.CKKS_MIX_OUTPUTS)
    assert [k for k in fixtures.CKKS_MIX_OUTPUTS if not same(got[k], want[k])] == []
    expected = fixtures.ckks_mix_expected(msgs)
    for k in fixtures.CKKS_MIX_OUTPUTS:
        for out, m in zip(flat(got[k]), flat(expected[k])):
            assert np.abs(port.decrypt_decode(out) - m).max() < 1e-3, k


def test_ckks_scales_select_their_own_run(ckks_setup):
    """A second set of input scales gives outputs at the scales the
    reference gives them, and the first set's outputs are unchanged."""
    ref, port = ckks_setup['ref'], ckks_setup['port']
    msgs = fixtures.ckks_mix_messages(N // 2, 6)
    task = FheTask(ckks_setup['mix'], mode='jit', device='cpu')
    runs = []
    for scale in (ckks_setup['scale'], ckks_setup['scale'] / 4):
        online, offline = fixtures.ckks_mix_arguments(ref, LEVEL, msgs, scale)
        want, _ = FheTaskTpu(ckks_setup['mix'], mode='eager').run(ref, {**online, **offline})
        got, _ = task.run(port, {k: to_port(v) for k, v in {**online, **offline}.items()})
        assert all(same(got[k], want[k]) for k in fixtures.CKKS_MIX_OUTPUTS)
        runs.append(got['o_rs'].scale)
    assert runs[0] == 16 * runs[1]
    assert len(task._out_scales) == 2


def test_fused_plan_of_mult_relins(setup):
    """8 mult_relins fuse into a mult wave and a relin wave; jit equals the
    reference's eager run and the port's eager run bit for bit."""
    ref, port = setup['ref'], setup['port']
    fused = FheTask(setup['mult_relin'], mode='jit', device='cpu')
    assert len(fused.plan) == 2
    eager = FheTaskGpu(setup['mult_relin'], mode='eager', device='cpu')
    assert len(eager.plan) == 16
    rng = np.random.default_rng(6)
    args = {f'{v}{k}': ref.encrypt(ref.encode(rng.integers(0, T_MOD, N), LEVEL))
            for k in range(8) for v in 'xy'}
    want, _ = FheTaskTpu(setup['mult_relin'], mode='eager').run(ref, args)
    port_args = {k: to_port(v) for k, v in args.items()}
    for task in (fused, eager):
        got, _ = task.run(port, port_args)
        assert all(same(got[f'z{k}'], want[f'z{k}']) for k in range(8))


def test_fused_group_with_unlike_inputs_runs_per_op(setup, tmp_path, caplog):
    """Two fused mults whose compressed plaintexts hold different block
    counts cannot be stacked: the group runs per op, with a warning, and
    gives the eager run's data."""
    port = setup['port']

    def build():
        x, y = ct.BfvCiphertextNode('x', 1), ct.BfvCiphertextNode('y', 1)
        c1 = ct.BfvCompressedPlaintextRingtNode('c1', compressed_block_info=[0, 1])
        c2 = ct.BfvCompressedPlaintextRingtNode('c2', compressed_block_info=[0, 1, 2])
        outs = [ct.mult(x, c1, start_block_idx=0), ct.mult(y, c2, start_block_idx=0)]
        return ([ct.Argument(nd.id, nd) for nd in (x, y, c1, c2)], [ct.Argument('z', outs)], [])

    d = gen_task(setup['fe'], build, tmp_path)
    rng = np.random.default_rng(11)
    ms = rng.integers(0, T_MOD, (7, N))
    args = {'x': port.encrypt(port.encode(ms[0], 1)), 'y': port.encrypt(port.encode(ms[1], 1)),
            'c1': PlaintextRingt(data=torch.stack([port.encode_ringt(m).data for m in ms[2:4]])),
            'c2': PlaintextRingt(data=torch.stack([port.encode_ringt(m).data for m in ms[4:]]))}
    fused = FheTask(d, mode='jit', device='cpu')
    assert len(fused.plan) == 1
    with caplog.at_level('WARNING', logger='lattisense_torch.runtime.task'):
        got, _ = fused.run(port, args)
    assert 'fell back to per-op execution for 2' in caplog.text
    want, _ = FheTask(d, mode='eager', device='cpu').run(port, args)
    assert all(torch.equal(a.data, b.data) for a, b in zip(got['z'], want['z']))
    for z, m, c in zip(got['z'], ms[:2], (ms[2], ms[4])):
        assert np.array_equal(port.decrypt_decode(z), (m * c) % T_MOD)


def test_progress_callback(setup):
    calls = []
    task = FheTask(setup['mult_relin'], mode='eager', device='cpu')
    rng = np.random.default_rng(7)
    port = setup['port']
    args = {f'{v}{k}': port.encrypt(port.encode(rng.integers(0, T_MOD, N), LEVEL))
            for k in range(8) for v in 'xy'}
    task.run(port, args, progress_cb=lambda done, total: calls.append((done, total)))
    assert calls[-1] == (16, 16)
    calls.clear()
    FheTask(setup['mult_relin'], mode='jit', device='cpu').run(
        port, args, progress_cb=lambda done, total: calls.append((done, total)))
    assert calls == [(0, 2), (2, 2)]


# ---------------------------------------------------------------------------
# a bootstrap node, n=256 u64 (the fixture of tests/test_bootstrap.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def btp_setup(tmp_path_factory):
    """Reference and port bootstrapping contexts of one seed on the n=256
    u64 chain (``tasks.bootstrap_n256``), the committed one-node bootstrap
    task of that chain, and a task made by the frontend with a custom node
    (``negate``) feeding a bootstrap node."""
    from lattisense_tpu.runtime import CkksBtpContext as RefBtpContext
    from lattisense_tpu.schemes.bootstrap import BootstrapConfig as RefConfig
    from lattisense_torch.runtime import CkksBtpContext
    from lattisense_torch.schemes.bootstrap import BootstrapConfig
    b = fixtures.bootstrap_n256(64)
    ref = RefBtpContext.create_random_context(
        RefCkksParams.create_custom(N, b['q'], b['p'], scale=b['scale']), seed=b['seed'],
        h=b['h'], btp_config=RefConfig(**b['cfg']))
    port = CkksBtpContext.create_random_context(
        CkksParams.create_custom(N, b['q'], b['p'], scale=b['scale']), seed=b['seed'], h=b['h'],
        btp_config=BootstrapConfig(**b['cfg']), device='cpu')

    def build_custom():
        x = ct.CkksCiphertextNode('x', 0)
        y = ct.CkksCiphertextNode('y', 0)
        ct.custom_compute([x], y, type='negate', attributes={})
        return [ct.Argument('x', x)], [ct.Argument('z', ct.bootstrap(y, 'z'))], []
    custom = gen_task(fe_btp256(64), build_custom, tmp_path_factory.mktemp('btp_custom'))
    return {'ref': ref, 'port': port, 'single': fixtures.task_dir(fixtures.BOOTSTRAP_N256[64]),
            'custom': custom}


def test_bootstrap_node_modes_match_reference(btp_setup):
    """Eager, jit and partitioned runs of the bootstrap task equal each
    other and the reference's ``FheTaskTpu(dir, mode='eager')`` bit for bit,
    with the input's scale restored on the output; the partitioned run has
    one segment, the bootstrap node."""
    ref, port = btp_setup['ref'], btp_setup['port']
    msg = np.random.default_rng(5).uniform(-1, 1, N // 2)
    x = ref.encrypt(ref.encode(msg, 0))
    want, _ = FheTaskTpu(btp_setup['single'], mode='eager').run(ref, {'x': x})
    outs = {}
    for mode in ('eager', 'jit', 'partitioned'):
        task = FheTask(btp_setup['single'], mode=mode, device='cpu')
        outs[mode], _ = task.run(port, {'x': to_port(x)})
        assert same(outs[mode]['z'], want['z']), mode
    assert [k for k, _ in task._segments()] == ['btp']
    assert outs['eager']['z'].scale == x.scale
    assert np.abs(port.decrypt_decode(outs['eager']['z']).real - msg).max() < 5e-3


def test_partitioned_custom_executor_before_bootstrap(btp_setup):
    """A custom executor (on the host, between segments) feeding a bootstrap
    node: partitioned equals eager and the reference bit for bit, and decodes
    to the negated message."""
    ref, port = btp_setup['ref'], btp_setup['port']
    msg = np.random.default_rng(6).uniform(-1, 1, N // 2)
    x = ref.encrypt(ref.encode(msg, 0))
    want, _ = FheTaskTpu(btp_setup['custom'], mode='eager', custom_executors={
        'negate': lambda xp, eng, ins, attrs: eng.neg(xp, ins[0])}).run(ref, {'x': x})
    outs = {}
    for mode in ('eager', 'partitioned'):
        task = FheTask(btp_setup['custom'], mode=mode, device='cpu',
                       custom_executors={'negate': lambda eng, ins, attrs: eng.neg(ins[0])})
        outs[mode], _ = task.run(port, {'x': to_port(x)})
        assert same(outs[mode]['z'], want['z']), mode
    assert [k for k, _ in task._segments()] == ['custom', 'btp']
    assert np.abs(port.decrypt_decode(outs['partitioned']['z']).real + msg).max() < 5e-3


# ---------------------------------------------------------------------------
# argument checks, offline inputs, custom executors, refusals
# ---------------------------------------------------------------------------

def error_of(fn):
    with pytest.raises(RuntimeError) as info:
        fn()
    return str(info.value)


def test_signature_error_messages(setup):
    """The strings of tests/test_runtime.py:152-172, plus the missing
    argument, size and parameter mismatches: the port's equal the
    reference's word for word."""
    ref, port = setup['ref'], setup['port']
    ref_task = FheTaskTpu(setup['mult_relin'], mode='eager')
    task = FheTask(setup['mult_relin'], mode='eager', device='cpu')
    rng = np.random.default_rng(8)
    m = rng.integers(0, T_MOD, N)
    good = ref.encrypt(ref.encode(m, LEVEL))
    base = {f'{v}{k}': good for k in range(8) for v in 'xy'}
    cases = {
        'For argument x0, expected level is 3, but input level is 2.':
            {**base, 'x0': ref.encrypt(ref.encode(m, 2))},
        'For argument x0, expected type is ct, but input type is pt.':
            {**base, 'x0': ref.encode(m, LEVEL)},
        'Missing input argument "y3".': {k: v for k, v in base.items() if k != 'y3'},
        'For argument x1, expected size is 1, but input size is 2.':
            {**base, 'x1': [good, good]},
    }
    for msg, args in cases.items():
        assert error_of(lambda: ref_task.run(ref, args)) == msg
        port_args = {k: to_port(v) for k, v in args.items()}
        assert error_of(lambda: task.run(port, port_args)) == msg
    # parameter mismatches: another t, another q chain
    q, p = chain(setup['word'])
    for t2, q2, msg in ((257, q, f'BFV parameter t mismatch: expected {T_MOD}, got 257'),
                        (T_MOD, q[:-1], f'BFV parameter Q count mismatch: expected {len(q)}, '
                                        f'got {len(q) - 1}')):
        other_ref = RefContext.create_random_context(
            RefBfvParams.create_custom(N, t2, q2, p, word_bits=setup['word']), seed=1)
        other = BfvContext.create_random_context(
            BfvParams.create_custom(N, t2, q2, p, word_bits=setup['word']), seed=1, device='cpu')
        assert error_of(lambda: ref_task.check(other_ref, base)) == msg
        port_base = {k: to_port(v) for k, v in base.items()}
        assert error_of(lambda: task.check(other, port_base)) == msg


def test_offline_input_and_preload(setup):
    """An offline pt_mul preloaded once serves several online runs; without
    it the run refuses with the reference's message."""
    port = setup['port']
    q, p = chain(setup['word'])

    def build():
        x = ct.BfvCiphertextNode('x', 1)
        w = ct.BfvPlaintextMulNode('w', 1)
        return [ct.Argument('x', x)], [ct.Argument('z', ct.mult(x, w, 'z'))], [ct.Argument('w', w)]

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        gen_task(setup['fe'], build, d)
        rng = np.random.default_rng(9)
        wv = rng.integers(0, T_MOD, N)
        task = FheTask(d, mode='jit', device='cpu')
        task.preload(port, {'w': port.encode_mul(wv, 1)})
        for _ in range(2):
            m = rng.integers(0, T_MOD, N)
            out, _ = task.run(port, {'x': port.encrypt(port.encode(m, 1))})
            assert np.array_equal(port.decrypt_decode(out['z']), (m * wv) % T_MOD)
        fresh = FheTask(d, mode='eager', device='cpu')
        assert error_of(lambda: fresh.run(port, {'x': port.encrypt(port.encode(wv, 1))})) == \
            'Missing input argument "w".'


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_custom_executor(setup, mode, tmp_path):
    port = setup['port']

    def build():
        x = ct.BfvCiphertextNode('x', 1)
        y = ct.BfvCiphertextNode('y', 1)
        ct.custom_compute([x], y, type='double_it', attributes={'factor': 2})
        return [ct.Argument('x', x)], [ct.Argument('y', y)], []

    def double_it(engine, inputs, attrs):
        assert attrs['factor'] == 2
        return engine.add(inputs[0], inputs[0])

    d = gen_task(setup['fe'], build, tmp_path)
    with pytest.raises(ValueError, match='no executor bound for custom compute type'):
        FheTask(d, mode=mode, device='cpu')
    task = FheTask(d, mode=mode, device='cpu', custom_executors={'double_it': double_it})
    m = np.random.default_rng(10).integers(0, T_MOD, N)
    out, _ = task.run(port, {'x': port.encrypt(port.encode(m, 1))})
    assert np.array_equal(port.decrypt_decode(out['y']), (2 * m) % T_MOD)


def test_refusals(setup, tmp_path, monkeypatch):
    """A coefficient mesh axis the ring cannot split (n not divisible by D²) is
    refused; so is a context on
    another device, and drop_level on BFV (as the reference); under
    LATTISENSE_DEV the memory monitor writes its CSV. Partitioned mode runs the fused plan cut at its barriers
    (here none: one span), equal to eager; a CKKS task loads onto the CKKS
    engine, and a bootstrap node binds."""
    d = setup['mult_relin']
    port = setup['port']
    args = {f'{v}{k}': port.encrypt(port.encode(np.arange(N) % T_MOD, LEVEL))
            for k in range(8) for v in 'xy'}
    part = FheTask(d, mode='partitioned', device='cpu')
    assert part._segments() == [('span', [0, 1])]
    got, _ = part.run(port, args)
    want, _ = FheTask(d, mode='eager', device='cpu').run(port, args)
    assert all(torch.equal(got[f'z{k}'].data, want[f'z{k}'].data) for k in range(8))
    with pytest.raises(ValueError, match=r'not divisible by D\^2=1024'):
        FheTask(d, device='cpu', mesh=SimpleNamespace(shape={'op': 1, 'limb': 1, 'coeff': 32},
                                                      device=torch.device('cpu')))
    with pytest.raises(ValueError, match='mode must be'):
        FheTask(d, mode='fast', device='cpu')
    # a CKKS task from the frontend
    big = ref_primes(64, 60, 2)
    fe = ct.CkksParam.create_custom_param(n=64, q=[big[0]] + ref_primes(64, 40, 2), p=[big[1]],
                                          slots=32, scale=float(1 << 40))

    def build():
        x = ct.CkksCiphertextNode('x', 2)
        return [ct.Argument('x', x)], [ct.Argument('z', ct.rescale(ct.mult_relin(x, x)))], []
    ckks = gen_task(fe, build, tmp_path / 'ckks')
    assert isinstance(FheTask(ckks, device='cpu').engine, CkksEngine)
    # a bootstrap node
    btp = tmp_path / 'btp'
    btp.mkdir()
    with open(os.path.join(ckks, 'mega_ag.json')) as f:
        mag = json.load(f)
    next(iter(mag['compute'].values()))['type'] = 'bootstrap'
    with open(btp / 'mega_ag.json', 'w') as f:
        json.dump(mag, f)
    with open(os.path.join(ckks, 'task_signature.json')) as f, \
            open(btp / 'task_signature.json', 'w') as g:
        g.write(f.read())
    btp_task = FheTask(str(btp), mode='partitioned', device='cpu')
    assert [k for k, _ in btp_task._segments()] == ['btp', 'span']
    # drop_level on BFV is the reference's ValueError
    bfv_drop = tmp_path / 'drop'
    bfv_drop.mkdir()
    with open(os.path.join(d, 'mega_ag.json')) as f:
        mag = json.load(f)
    next(c for c in mag['compute'].values() if c['type'] == 'mult')['type'] = 'drop_level'
    with open(bfv_drop / 'mega_ag.json', 'w') as f:
        json.dump(mag, f)
    with open(os.path.join(d, 'task_signature.json')) as f, \
            open(bfv_drop / 'task_signature.json', 'w') as g:
        g.write(f.read())
    with pytest.raises(ValueError, match='DROP_LEVEL only supported for CKKS scheme'):
        FheTask(str(bfv_drop), mode='eager', device='cpu')
    # the memory monitor writes its CSV and changes no output; a context
    # on another device
    task = FheTask(d, mode='eager', device='cpu')
    plain, _ = task.run(port, args)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('LATTISENSE_DEV', '1')
    monitored, _ = task.run(port, args)
    monkeypatch.delenv('LATTISENSE_DEV')
    assert all(torch.equal(monitored[k].data, v.data) for k, v in plain.items())
    with open(tmp_path / 'mem_usage_gpu_0.csv') as f:
        assert f.readline().strip() == 'time_s,vmrss_kb,vmhwm_kb,anon_huge_kb'
        assert len(f.readlines()) >= 2
    task.device = torch.device('meta')
    with pytest.raises(RuntimeError, match='the context is on cpu, the task on meta'):
        task.run(port, args)


def test_task_defaults_to_the_card():
    from lattisense_torch import resolve_device
    d = fixtures.task_dir(fixtures.MULT_RELIN)
    if torch.cuda.is_available():
        assert FheTask(d).device == resolve_device()
        return
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        FheTask(d)


if __name__ == '__main__':
    for fixture in committed_fixtures():
        out = fixtures.task_dir(fixture)
        os.makedirs(out, exist_ok=True)
        write_fixture(fixture, out)
        print('wrote', out)
