"""lattisense_torch's CKKS bootstrapping held bit for bit against lattisense_tpu.

On the CPU the port runs its plain twins. Each context pair comes from one
seed, so the port's keys are the JAX package's (both secrets, the switching
keys and every Galois key); the port is fed the reference's ciphertexts as
arrays. At the JAX package's own n = 256 fixtures (``tests/test_bootstrap.py``):
the u64 chain (seed 71) at every segment boundary, the complex message, the
sparse slots and the 32-bit composite chain with the arcsine; then the
modules under the bootstrap: ``special_fft``, ``linear_transform``,
``poly_eval`` (sine, ReLU, step, staged equal to fused), ``mod_raise`` on
both words, the BSGS split and the profiles' rotations against the frontend,
and the switching keys through ``utils/serialize.py``.
"""

import numpy as np
import pytest
import torch

from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.frontend import bootstrap_params as ref_bp
from lattisense_tpu.frontend import custom_task as fct
from lattisense_tpu.params import CkksParams as RefParams
from lattisense_tpu.runtime import CkksBtpContext as RefBtpContext
from lattisense_tpu.runtime import CkksContext as RefContext
from lattisense_tpu.schemes import linear_transform as ref_lt
from lattisense_tpu.schemes import poly_eval as ref_pe
from lattisense_tpu.schemes import special_fft as ref_fft
from lattisense_tpu.schemes.bootstrap import BootstrapConfig as RefConfig

from lattisense_torch.params import CkksParams
from lattisense_torch.runtime import CkksBtpContext, CkksContext, FheContext
from lattisense_torch.schemes import bootstrap_params as bp
from lattisense_torch.schemes import linear_transform as lt_mod
from lattisense_torch.schemes import poly_eval as pe
from lattisense_torch.schemes import special_fft
from lattisense_torch.schemes.bootstrap import BootstrapConfig
from lattisense_torch.schemes.types import Ciphertext

N = 256


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


def U(a):
    """Residues as uint64, from a reference array or a port tensor."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy().view(np.uint64)
    return np.asarray(a).astype(np.uint64)


def port_ct(ct):
    return Ciphertext(data=torch.from_numpy(U(ct.data).astype(np.int64)), level=ct.level,
                      is_ntt=ct.is_ntt, scale=ct.scale)


def same(port, ref) -> bool:
    return (np.array_equal(U(port.data), U(ref.data)) and port.level == ref.level
            and port.scale == ref.scale)


def same_key(a, b) -> bool:
    return np.array_equal(U(a.key_q), U(b.key_q)) and np.array_equal(U(a.key_p), U(b.key_p))


def pair(params_args, seed, h, cfg, word=64, slots=None):
    """(reference, port) bootstrapping contexts of one seed."""
    n, q, p, scale = params_args
    ref = RefBtpContext.create_random_context(
        RefParams.create_custom(n, q, p, slots=slots, scale=scale, word_bits=word), seed=seed,
        h=h, btp_config=RefConfig(**cfg))
    port = CkksBtpContext.create_random_context(
        CkksParams.create_custom(n, q, p, slots=slots, scale=scale, word_bits=word), seed=seed,
        h=h, btp_config=BootstrapConfig(**cfg), device='cpu')
    return ref, port


def u64_chain():
    q0 = gen_ntt_primes(N, 61, 1)
    qs = gen_ntt_primes(N, 60, 22)
    p = gen_ntt_primes(N, 61, 3, exclude=tuple(q0))
    return N, q0 + qs, p[1:], float(1 << 45)


U64_CFG = dict(cts_depth=3, stc_depth=3, k=16, sine_deg=30, double_angle=3)


@pytest.fixture(scope='module')
def u64():
    return pair(u64_chain(), 71, 32, U64_CFG)


@pytest.fixture(scope='module')
def w32():
    """The 32-bit composite chain of tests/test_bootstrap.py:255-293 with the
    arcsine at ratio 8."""
    qs = gen_ntt_primes(N, 31, 46)
    p = gen_ntt_primes(N, 31, 3, exclude=tuple(qs))
    return pair((N, qs, p, float(1 << 30)), 7, 32,
                dict(U64_CFG, message_ratio=8.0, arcsine=True), word=32)


def walk(ctx, ct, port: bool):
    """The bootstrap of ``ct`` segment by segment: [(name, boundary)]."""
    btp = ctx.engine.bootstrapper
    base = btp.step - 1
    eng = ctx.engine
    if ct.level != base:
        ct = eng.drop_level(ct, ct.level - base) if port else eng.drop_level(np, ct,
                                                                              ct.level - base)
    cts, out = (ct,), []
    swk = (ctx.swk.get('swk_dts'), ctx.swk.get('swk_std'))
    for name, fn in btp.segments(ct.scale, *swk):
        cts = fn(cts, ctx.rlk, ctx.glk.keys) if port else fn(np, cts, ctx.rlk, ctx.glk.keys)
        out.append((name, cts))
    return out


def check_walk(ref, port, ct):
    """Every segment boundary equal (data, level, scale); → the output."""
    want, got = walk(ref, ct, False), walk(port, port_ct(ct), True)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert len(g) == len(w) and all(same(a, b) for a, b in zip(g, w)), name
    return got[-1][1][0]


# ---------------------------------------------------------------------------
# keys and the whole bootstrap
# ---------------------------------------------------------------------------

def test_same_seed_same_keys(u64, w32):
    """sk, sk_sparse, pk, rlk, both switching keys and every Galois key."""
    for ref, port in (u64, w32):
        assert np.array_equal(ref.sk.coeffs, port.sk.coeffs)
        assert np.array_equal(ref.sk_sparse.coeffs, port.sk_sparse.coeffs)
        assert np.count_nonzero(port.sk_sparse.coeffs) == 32
        assert np.array_equal(U(ref.pk.data), U(port.pk.data))
        assert same_key(ref.rlk, port.rlk)
        assert set(port.swk) == {'swk_dts', 'swk_std'}
        assert all(same_key(ref.swk[k], port.swk[k]) for k in ref.swk)
        assert sorted(ref.glk.keys) == sorted(port.glk.keys)
        assert all(same_key(ref.glk.keys[e], port.glk.keys[e]) for e in ref.glk.keys)
        assert port.engine.bootstrapper.galois_elements() == \
            ref.engine.bootstrapper.galois_elements()


def test_u64_bootstrap_segments_match_reference(u64):
    """The u64 fixture: every segment boundary equals the reference's, and
    the port's ``ctx.bootstrap`` equals the fold; it decodes within the
    reference's bound and leaves its levels."""
    ref, port = u64
    msg = np.random.default_rng(0).uniform(-1, 1, ref.params.slots)
    ct = ref.encrypt(ref.encode(msg, 0))
    folded = check_walk(ref, port, ct)
    out = port.bootstrap(port_ct(ct))
    assert torch.equal(out.data, folded.data) and out.scale == folded.scale
    assert out.level >= 2
    assert np.abs(port.decrypt_decode(out).real - msg).max() < 5e-3


def test_u64_bootstrap_complex_message(u64):
    ref, port = u64
    rng = np.random.default_rng(1)
    msg = rng.uniform(-1, 1, ref.params.slots) + 1j * rng.uniform(-1, 1, ref.params.slots)
    ct = ref.encrypt(ref.encode(msg, 0))
    got = port.bootstrap(port_ct(ct))
    assert same(got, ref.bootstrap(ct))
    assert np.abs(port.decrypt_decode(got) - msg).max() < 5e-3


def test_sparse_slots_bootstrap():
    """slots = n/8: the SubSum projection and size-s transforms."""
    n, q, p, scale = u64_chain()
    ref, port = pair((n, q, p, scale), 73, 32, dict(U64_CFG, cts_depth=2, stc_depth=2),
                     slots=N // 8)
    msg = np.random.default_rng(2).uniform(-1, 1, ref.params.slots)
    ct = ref.encrypt(ref.encode(msg, 0))
    got = port.bootstrap(port_ct(ct))
    assert same(got, ref.bootstrap(ct))
    assert np.abs(port.decrypt_decode(got).real - msg).max() < 5e-3


def test_w32_composite_arcsine_bootstrap(w32):
    """Two limbs a level, ModRaise from q0·q1, the arcsine stage: every
    segment boundary equal, the output within the reference's bound."""
    ref, port = w32
    assert port.engine.bootstrapper.step == 2
    msg = np.random.default_rng(0).uniform(-1, 1, ref.params.slots)
    ct = ref.encrypt(ref.encode(msg, 1))
    out = check_walk(ref, port, ct)
    assert out.level >= 7
    assert np.abs(port.decrypt_decode(out).real - msg).max() < 2e-5


def test_evalmod_pair_equals_halves(u64):
    """The two EvalMod halves run as one call on a batch of two; each half
    equals its own run."""
    _, port = u64
    btp = port.engine.bootstrapper
    segs = dict(btp.segments(port.params.scale))
    msg = np.random.default_rng(3).uniform(-1, 1, port.params.slots)
    ct = port.encrypt(port.encode(msg, port.params.max_level))
    lv = port.params.max_level - btp.cfg.cts_depth
    a, b = (port.engine.drop_level(c, ct.level - lv) for c in (ct, port.conjugate(ct)))
    a.scale = b.scale = btp.em_entry_scale
    both = segs['evalmod_da']((a, b), port.rlk, port.glk.keys)
    for one, c in zip(both, (a, b)):
        alone = btp._double_angle(btp._double_angle(btp._double_angle(c, port.rlk), port.rlk),
                                  port.rlk)
        assert torch.equal(one.data, alone.data) and one.scale == alone.scale


def test_engine_bootstrap_needs_a_bootstrapper(u64):
    """Without a bootstrapper the engine and the context raise the
    reference's errors."""
    ref, port = u64
    ctx = CkksContext.from_arrays(port.params, port.sk.coeffs, port.pk.data, port.rlk.key_q,
                                  port.rlk.key_p, device='cpu')
    plain = RefContext(ref.params)
    ct = port.encrypt(port.encode(np.zeros(4), 0))
    with pytest.raises(RuntimeError, match='engine has no bootstrapper; use CkksBtpContext'):
        ctx.engine.bootstrap(ct, {'rlk': ctx.rlk, 'glk': {}})
    with pytest.raises(RuntimeError, match=r'call create_bootstrapper\(\) first'):
        ctx.bootstrap(ct)
    with pytest.raises(RuntimeError, match=r'call create_bootstrapper\(\) first'):
        plain.bootstrap(None)


def test_switching_keys_round_trip_serialize(u64):
    """serialize_advanced carries both switching keys byte for byte as the
    reference does, and a deserialized context holds them."""
    ref, port = u64
    blob = port.serialize_advanced()
    assert blob == ref.serialize_advanced()
    back = FheContext.deserialize_advanced(blob, device='cpu')
    assert set(back.swk) == {'swk_dts', 'swk_std'}
    assert all(same_key(back.swk[k], port.swk[k]) for k in port.swk)


# ---------------------------------------------------------------------------
# the modules under the bootstrap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('s,depth', [(8, 2), (128, 3), (64, 4)])
def test_special_fft_matrices_match_reference(s, depth):
    for port_fn, ref_fn in ((special_fft.cts_matrices, ref_fft.cts_matrices),
                            (special_fft.stc_matrices, ref_fft.stc_matrices)):
        got, want = port_fn(s, depth, post_scale=0.37), ref_fn(s, depth, post_scale=0.37)
        assert [sorted(g) for g in got] == [sorted(w) for w in want]
        assert all(np.array_equal(g[o], w[o]) for g, w in zip(got, want) for o in w)


@pytest.fixture(scope='module')
def lt_ctx():
    """The n=64 context of tests/test_linear_transform.py, both sides."""
    n = 64
    big = gen_ntt_primes(n, 60, 2)
    mids = gen_ntt_primes(n, 40, 3)
    args = (n, [big[0]] + mids, [big[1]])
    ref = RefContext.create_random_context(RefParams.create_custom(*args, scale=float(1 << 40)),
                                           seed=41)
    port = CkksContext.create_random_context(CkksParams.create_custom(*args,
                                                                      scale=float(1 << 40)),
                                             seed=41, device='cpu')
    return ref, port


@pytest.mark.parametrize('kind', ['dense', 'sparse'])
def test_linear_transform_matches_reference(lt_ctx, kind):
    """A dense complex matrix and the three-diagonal special-FFT shape:
    equal output bit for bit, and the matrix-vector product on decoding."""
    ref, port = lt_ctx
    rng = np.random.default_rng(0 if kind == 'dense' else 1)
    s = ref.params.slots
    if kind == 'dense':
        mat = rng.uniform(-1, 1, (s, s)) + 1j * rng.uniform(-1, 1, (s, s))
    else:
        mat = np.zeros((s, s), dtype=np.complex128)
        idx = np.arange(s)
        for d in (0, 4, s - 4):
            mat[idx, (idx + d) % s] = rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)
    diags = lt_mod.matrix_diagonals(mat)
    assert sorted(diags) == sorted(ref_lt.matrix_diagonals(mat))
    n1 = lt_mod.bsgs_split(diags.keys(), s)
    assert n1 == ref_lt.bsgs_split(diags.keys(), s)
    lt_p = lt_mod.EncodedLinearTransform(port.engine, diags, level=2, n1=n1)
    lt_r = ref_lt.EncodedLinearTransform(ref.engine, diags, level=2, n1=n1)
    assert lt_p.galois_elements() == lt_r.galois_elements()
    ref.gen_galois_keys_for_elements(lt_r.galois_elements())
    port.gen_galois_keys_for_elements(lt_p.galois_elements())
    v = rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)
    ct = ref.encrypt(ref.encode(v, 2))
    got = lt_p(port_ct(ct), port.glk.keys)
    assert same(got, lt_r(np, ct, ref.glk.keys))
    np.testing.assert_allclose(port.decrypt_decode(port.rescale(got)), mat @ v, atol=1e-3)


@pytest.fixture(scope='module')
def pe_ctx():
    """The n=64 context of tests/test_poly_eval.py, both sides."""
    n = 64
    big = gen_ntt_primes(n, 60, 2)
    mids = gen_ntt_primes(n, 45, 8)
    args = (n, [big[0]] + mids, [big[1]])
    ref = RefContext.create_random_context(RefParams.create_custom(*args, scale=float(1 << 45)),
                                           seed=43)
    port = CkksContext.create_random_context(CkksParams.create_custom(*args,
                                                                      scale=float(1 << 45)),
                                             seed=43, device='cpu')
    return ref, port


def test_poly_eval_helpers_match_reference():
    rng = np.random.default_rng(0)
    for d, g in ((7, 4), (30, 16)):
        c = rng.uniform(-1, 1, d + 1)
        for a, b in zip(pe.cheb_divmod(c, g), ref_pe.cheb_divmod(c, g)):
            assert np.array_equal(a, b)
    assert np.array_equal(pe.chebyshev_interpolate(np.sin, -3, 3, 23),
                          ref_pe.chebyshev_interpolate(np.sin, -3, 3, 23))


@pytest.mark.parametrize('fn', ['sine', 'relu', 'step', 'staged'])
def test_poly_eval_matches_reference(pe_ctx, fn):
    """Degree-23 sine on [-3, 3], the context's ReLU and step activations,
    and the deg-39 staged evaluation, whose fold equals the fused one: each
    bit for bit against the reference, with its level and scale."""
    ref, port = pe_ctx
    rng = np.random.default_rng({'sine': 2, 'relu': 3, 'step': 3, 'staged': 4}[fn])
    level = ref.params.max_level
    lo = -3.0 if fn == 'sine' else -1.0
    v = rng.uniform(lo, -lo, ref.params.slots)
    ct = ref.encrypt(ref.encode(v, level))
    pc = port_ct(ct)
    if fn == 'sine':
        coeffs = pe.chebyshev_interpolate(np.sin, -3, 3, 23)
        got = pe.ChebyshevEvaluator(port.engine, coeffs, -3, 3)(pc, port.rlk)
        want = ref_pe.ChebyshevEvaluator(ref.engine, coeffs, -3, 3)(np, ct, ref.rlk)
        np.testing.assert_allclose(port.decrypt_decode(got).real, np.sin(v), atol=1e-3)
    elif fn == 'relu':
        got = port.poly_eval_relu_function(pc)
        want = ref.poly_eval_relu_function(ct)
        assert np.max(np.abs(port.decrypt_decode(got).real - np.maximum(v, 0))) < 0.15
    elif fn == 'step':
        got = port.poly_eval_step_function(pc)
        want = ref.poly_eval_step_function(ct)
    else:
        coeffs = pe.chebyshev_interpolate(np.sin, -1, 1, 39)
        ev = pe.ChebyshevEvaluator(port.engine, coeffs, -1, 1)
        assert max(ev._all_keys()) == 32
        fused = ev(pc, port.rlk, anchor=pc.scale)
        cts, names = [port_ct(ct)], []
        for name, stage in ev.stages(pc.scale):
            cts = stage(cts, port.rlk)
            names.append(name)
        assert names == ['b', 'g', 'l', 'e']
        got = cts[0]
        assert torch.equal(got.data, fused.data) and (got.level, got.scale) == (fused.level,
                                                                                fused.scale)
        want = ref_pe.ChebyshevEvaluator(ref.engine, coeffs, -1, 1)(np, ct, ref.rlk,
                                                                     anchor=ct.scale)
    assert same(got, want)


@pytest.mark.parametrize('word', ['u64', 'w32'])
def test_mod_raise_matches_reference(u64, w32, word):
    """ModRaise from the base level (q0, or the composite q0·q1 on the
    32-bit word, whose CRT runs in 64-bit Montgomery arithmetic) to the full
    chain, on a batch of two as well."""
    ref, port = u64 if word == 'u64' else w32
    rb, pb = ref.engine.bootstrapper, port.engine.bootstrapper
    msg = np.random.default_rng(5).uniform(-1, 1, ref.params.slots)
    ct = ref.encrypt(ref.encode(msg, rb.step - 1))
    want = rb.mod_raise(np, ct)
    got = pb.mod_raise(port_ct(ct))
    assert same(got, want) and got.level == ref.params.max_level
    two = Ciphertext(data=torch.stack([port_ct(ct).data] * 2), level=ct.level, is_ntt=True,
                     scale=ct.scale)
    both = pb.mod_raise(two)
    assert torch.equal(both.data[0], got.data) and torch.equal(both.data[1], got.data)


# ---------------------------------------------------------------------------
# the profiles and the BSGS split against the frontend (no keys)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [8192, 1 << 16])
def test_profiles_match_frontend(n):
    """The toy (n=8192) and full (n=2^16) profiles: the chain, the scale,
    the depths, and the rotations the frontend predicts, equal."""
    mine = bp.toy_profile() if n == 8192 else bp.full_profile()
    fe = (fct.CkksBtpParam.create_toy_param() if n == 8192
          else fct.CkksBtpParam.create_default_param())
    assert (mine.n, list(mine.q), list(mine.p), mine.scale, mine.slots) == \
        (fe.n, fe.q, fe.p, fe.scale, fe.slots)
    assert (mine.cts_params.depth(), mine.stc_params.depth()) == \
        (fe.cts_params.depth(), fe.stc_params.depth())
    assert mine.eval_mod_params.depth() == fe.eval_mod_params.depth()
    assert sorted(mine.rotations_for_bootstrapping()) == sorted(fe.rotations_for_bootstrapping())


@pytest.mark.parametrize('s,depth', [(4096, 4), (4096, 3), (32768, 3)])
def test_bsgs_split_matches_frontend(s, depth):
    """The split of every CoeffsToSlots and SlotsToCoeffs group at the
    profiles' slot counts, and of the frontend's own DFT index maps."""
    groups = special_fft.cts_matrices(s, depth) + special_fft.stc_matrices(s, depth)
    for g in groups:
        diag = {o: True for o in g}
        assert bp.find_best_bsgs_split(diag, s, 2.0) == ref_bp.find_best_bsgs_split(diag, s, 2.0)
    for kind in ('CoeffsToSlots', 'SlotsToCoeffs'):
        args = dict(repack_imag_2_real=True, level_start=depth, bit_reversed=False,
                    bsgs_ratio=2.0, scaling_factor=[[1]] * depth,
                    log_n=s.bit_length(), log_slots=s.bit_length() - 1)
        mine = bp.EncodingMatrixParams(linear_transform_type=bp.LinearTransformType[kind],
                                       **args)
        theirs = ref_bp.EncodingMatrixParams(
            linear_transform_type=ref_bp.LinearTransformType[kind], **args)
        assert mine.dft_index_map() == theirs.dft_index_map()
        assert mine.rotations() == theirs.rotations()


@pytest.mark.parametrize('name', ['toy', 'full', 'w32'])
def test_reference_run_matches_jax_run(name):
    """``bootstrap_params.reference_run`` holds the JAX package's runs of
    tests/test_bootstrap.py: the chain, scale and word of its parameters,
    and its configuration field by field (the toy and full profiles' fields
    with k=20, sine_deg=39; ``create_tpu_btp_param``'s chain with the
    arcsine at ratio 8), h=192, seed 77, and its input level and scale."""
    run = bp.reference_run(name)
    if name == 'w32':
        rp = RefParams.create_tpu_btp_param(1 << 16)
        cfg = RefConfig(cts_depth=3, stc_depth=3, k=20, sine_deg=39, double_angle=3,
                        message_ratio=8.0, arcsine=True)
        level, scale = 1, float(1 << 40)
    else:
        fe = (fct.CkksBtpParam.create_toy_param() if name == 'toy'
              else fct.CkksBtpParam.create_default_param())
        rp = RefParams.create_custom(fe.n, fe.q, fe.p, slots=fe.slots, scale=float(fe.scale))
        cfg = RefConfig(cts_depth=fe.cts_params.depth(), stc_depth=fe.stc_params.depth(), k=20,
                        sine_deg=39, double_angle=fe.eval_mod_params.double_angle,
                        em_scale=float(fe.eval_mod_params.scaling_factor),
                        message_ratio=fe.eval_mod_params.message_ratio)
        level, scale = 0, float(fe.scale)
    got = run['params']
    assert (got.n, tuple(got.q), tuple(got.p), got.slots, got.scale, got.word_bits) == \
        (rp.n, tuple(rp.q), tuple(rp.p), rp.slots, rp.scale, rp.word_bits)
    assert vars(run['config']) == vars(cfg)
    assert (run['h'], run['seed'], run['msg_seed'], run['level'], run['scale']) == \
        (192, 77, 7, level, scale)
