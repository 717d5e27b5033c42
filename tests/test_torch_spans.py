"""The program's spans and counters (``lattisense_torch/utils/observability.py``).

On the CPU at n = 2^10, through the benchmark cells' entry
(``parallel/batch.py`` ``make_batched_step``) under a CPU-only
``torch.profiler`` session: the span tree of BFV ``mult_relin`` and
``rotate_col`` on the 32-bit word and of CKKS ``mult_relin_rescale`` on the
64-bit word (names, parents, one step id a call, host and self times),
outputs bit for bit those of an untraced call, nothing recorded and no
profiler call made with the profiler off, no table or kernel built by a
step after warm-up, the registry's counters, and the benchmark's readers of
the new spans. On the card (marked ``card``, skipped here): a span records a
CUDA event pair and the launches inside it, and none while the stream
captures a CUDA graph. The file imports no JAX:
``python -m pytest --noconftest tests/test_torch_spans.py`` runs on the card.
"""

import gc
import socket

import numpy as np
import pytest
import torch

from lattisense_torch.core.modring import gen_ntt_primes
from lattisense_torch.ops import (bconv_cuda, behz_cuda, cuda_build, ksw64_cuda, ksw_cuda,
                                  ntt64_cuda, ntt_cuda, ntt_mxu, tensor_cuda)
from lattisense_torch.params import BfvParams, CkksParams
from lattisense_torch.parallel.batch import (bfv_mult_relin, ckks_mult_relin_rescale, key_tree,
                                             make_batched_step, make_rotate_step)
from lattisense_torch.runtime import BfvContext, CkksContext
from lattisense_torch.schemes.galois import galois_elt_col
from lattisense_torch.utils import observability as obs

N = 1 << 10
LEVEL = 4
BATCH = 2


@pytest.fixture(scope='module', autouse=True)
def one_intraop_thread():
    """One torch intra-op thread: the suite's parallel workers, each with a
    thread per core, would oversubscribe the host (``tests/test_torch_task.py``)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def empty_registry():
    obs.reset()
    yield
    obs.reset()


def bfv_context():
    primes = gen_ntt_primes(N, 31, 8)
    params = BfvParams.create_custom(N, 65537, primes[:5], primes[5:], word_bits=32)
    return BfvContext.create_random_context(params, seed=5, device='cpu')


def ckks_context():
    big = gen_ntt_primes(N, 60, 2)
    params = CkksParams.create_custom(N, [big[0]] + gen_ntt_primes(N, 40, 4), [big[1]],
                                      slots=N // 2, scale=float(1 << 40), word_bits=64)
    return CkksContext.create_random_context(params, seed=5, device='cpu')


def bfv_inputs(ctx, k, seed):
    rng = np.random.default_rng(seed)
    return [torch.stack([ctx.encrypt(ctx.encode_coeffs(rng.integers(0, 65537, N), LEVEL)).data
                         for _ in range(BATCH)]) for _ in range(k)]


@pytest.fixture(scope='module')
def cells():
    """Each cell's entry and inputs: (step, args)."""
    bfv = bfv_context()
    elt = galois_elt_col(1, N)
    bfv.gen_galois_keys_for_elements([elt])
    a, b = bfv_inputs(bfv, 2, 1)
    ckks = ckks_context()
    rng = np.random.default_rng(2)
    slots = ckks.params.slots
    ca, cb = [torch.stack([ckks.encrypt(ckks.encode(rng.uniform(-1, 1, slots), LEVEL)).data
                           for _ in range(BATCH)]) for _ in range(2)]
    return {
        'bfv_mult_relin': (make_batched_step(bfv.engine, bfv_mult_relin, LEVEL),
                           (a, b, key_tree(bfv))),
        'bfv_rotate': (make_batched_step(bfv.engine, make_rotate_step(elt), LEVEL, n_inputs=1),
                       (a, key_tree(bfv, galois_elts=[elt]))),
        'ckks_mult_relin_rescale': (make_batched_step(ckks.engine, ckks_mult_relin_rescale, LEVEL,
                                                      is_ntt=True),
                                    (ca, cb, key_tree(ckks))),
    }


# each cell's spans of one call: (name, its parent's name), in the order they open
KSW64 = [(s, 'ksw.switch') for s in ('ksw.modup', 'ksw.ntt', 'ksw.inner', 'ksw.intt',
                                     'ksw.moddown', 'ksw.output_ntt')]
TREES = {
    'bfv_mult_relin': [('step', None), ('bfv.mult', 'step'), ('bfv.behz_prep', 'bfv.mult'),
                       ('bfv.tensor_product', 'bfv.mult'), ('bfv.behz_finish', 'bfv.mult'),
                       ('bfv.relinearize', 'step'), ('ksw.switch', 'bfv.relinearize')],
    'bfv_rotate': [('step', None), ('bfv.apply_galois', 'step'),
                   ('galois.automorphism', 'bfv.apply_galois'),
                   ('ksw.switch', 'bfv.apply_galois')],
    'ckks_mult_relin_rescale': [('step', None), ('ckks.mult', 'step'),
                                ('ckks.relinearize', 'step'), ('ksw.switch', 'ckks.relinearize'),
                                *KSW64, ('ckks.rescale', 'step'),
                                ('ckks.divround', 'ckks.rescale')],
}
SWITCH = {'bfv_mult_relin': (32, 'plain'), 'bfv_rotate': (32, 'plain'),
          'ckks_mult_relin_rescale': (64, 'staged')}
READERS = {'bfv_mult_relin': ['tensor_ms.bfv'], 'bfv_rotate': ['automorphism_ms.bfv'],
           'ckks_mult_relin_rescale': ['rescale_ms.ckks', 'moddown_ms.ckks']}


def profiled(fn, calls=1):
    """``calls`` calls of ``fn`` in a CPU-only torch.profiler session; → the
    last output."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(calls):
            out = fn()
    return out


@pytest.mark.parametrize('cell', list(TREES))
def test_span_tree(cells, cell):
    step, args = cells[cell]
    profiled(lambda: step(*args), calls=2)
    spans = obs.spans()
    tree = TREES[cell]
    assert len(spans) == 2 * len(tree) and len(tree) <= (13 if 'ckks' in cell else 7)
    for call in range(2):
        got = spans[call * len(tree):(call + 1) * len(tree)]
        assert [(s['name'], spans[s['parent']]['name'] if s['parent'] is not None else None)
                for s in got] == tree
        assert {s['step'] for s in got} == {got[0]['step']}
    assert spans[0]['step'] != spans[len(tree)]['step']
    assert spans[0]['attrs'] == {'B': BATCH, 'level': LEVEL}
    switch = next(s for s in spans if s['name'] == 'ksw.switch')
    word, route = SWITCH[cell]
    assert switch['attrs'] == {'word': word, 'route': route, 'L': LEVEL + 1,
                               'alpha': 1 if word == 64 else 3, 'beta': 5 if word == 64 else 2,
                               'G': BATCH}
    for s in spans:
        assert s['host_self_ms'] >= 0 and s['launches'] == 0           # no kernel on the CPU
        if not torch.cuda.is_initialized():
            assert s['device_ms'] == s['host_ms']                      # the host is the device
        if s['parent'] is not None:
            parent = spans[s['parent']]
            assert parent['start_ns'] <= s['start_ns'] <= s['end_ns'] <= parent['end_ns']
            assert s['host_ms'] <= parent['host_ms']
    totals = obs.totals()
    assert set(totals) == {name for name, _ in tree}
    assert totals['step']['calls'] == 2 and all(t['steps'] == 2 for t in totals.values())
    assert totals['ksw.switch']['host_self_ms'] <= totals['ksw.switch']['host_ms']


@pytest.mark.parametrize('cell', list(TREES))
def test_outputs_equal_with_the_profiler_on_and_off(cells, cell):
    step, args = cells[cell]
    off = step(*args)
    assert obs.spans() == []
    assert torch.equal(profiled(lambda: step(*args)), off)
    assert obs.spans()


def test_off_span_calls_no_profiler(cells, monkeypatch):
    """With no profiler session a span is the shared no-op: no record, no
    range opened, no event."""
    def refuse(*args, **kwargs):
        raise AssertionError('a profiler range was opened with the profiler off')

    monkeypatch.setattr(torch._C._profiler, '_RecordFunctionFast', refuse)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.cuda, 'Event', refuse)
    assert obs.span('bfv.mult') is obs.span('step', B=1) is obs.OFF
    with obs.span('step') as sp:
        assert sp is None
    for step, args in cells.values():
        step(*args)
    assert obs.spans() == [] and obs.totals() == {}


@pytest.mark.parametrize('cell', list(TREES))
def test_a_warm_step_builds_no_table_or_kernel(cells, cell):
    step, args = cells[cell]
    step(*args)
    before = obs.counters()
    profiled(lambda: step(*args))
    after = obs.counters()
    assert after['tables_built'] == before['tables_built']
    assert after['cuda_build'] == before['cuda_build']


def test_a_new_level_builds_its_tables():
    """The counters count cache misses: a context's first step builds its
    level's tables, a second one nothing."""
    ctx = bfv_context()
    a, b = bfv_inputs(ctx, 2, 9)
    step = make_batched_step(ctx.engine, bfv_mult_relin, LEVEL)
    before = obs.counters()['tables_built']
    step(a, b, key_tree(ctx))
    built = obs.counters()['tables_built']
    for table in ('BfvEngine.behz', 'KeySwitcher._level_pre'):
        assert built.get(table, 0) == before.get(table, 0) + 1, table
    step(a, b, key_tree(ctx))
    assert obs.counters()['tables_built'] == built


def test_the_registry_holds_the_programs_counters():
    """The kernel wrappers' ``launches`` dicts are registered as they are
    (the same objects, read unchanged), beside the table and library
    counts."""
    wrappers = {'ntt_cuda': ntt_cuda, 'behz_cuda': behz_cuda, 'ksw_cuda': ksw_cuda,
                'ntt64_cuda': ntt64_cuda, 'bconv_cuda': bconv_cuda, 'ksw64_cuda': ksw64_cuda,
                'ntt_mxu': ntt_mxu, 'tensor_cuda': tensor_cuda}
    counts = obs.counters()
    for name, mod in wrappers.items():
        assert obs._counters[name] is mod.launches and counts[name] == mod.launches
    assert obs._counters['cuda_build'] is cuda_build.kernels
    assert set(counts['cuda_build']) == {'kernels_loaded', 'kernels_built'}
    assert 'get_rns_ring' in counts['tables_built']


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def test_the_registry_reads_the_newest_mesh():
    import torch.distributed as dist

    from lattisense_torch.parallel.mesh import make_mesh
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{free_port()}', world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(device='cpu')
        assert obs.counters()['collectives'] == mesh.stats == {'staged_bytes': 0}
        mesh.stats['psum'] = {'calls': 2, 'bytes': 64}
        assert obs.counters()['collectives']['psum'] == {'calls': 2, 'bytes': 64}
        mesh.reset_stats()
        assert obs.counters()['collectives'] == {'staged_bytes': 0}
        del mesh
        gc.collect()
        assert obs.counters()['collectives'] == {}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('cell', list(TREES))
def test_the_benchmarks_readers(cells, cell):
    """Each reader of a new span gives its device ms a step from a recorded
    window, and None from an empty registry."""
    from portbench import run as harness
    step, args = cells[cell]
    profiled(lambda: step(*args), calls=2)
    totals = obs.totals()
    for name in READERS[cell]:
        span = {'tensor_ms': 'bfv.tensor_product', 'automorphism_ms': 'galois.automorphism',
                'rescale_ms': 'ckks.rescale', 'moddown_ms': 'ksw.moddown'}[name.split('.')[0]]
        got = harness.reader(name).read({})
        assert got == pytest.approx(totals[span]['device_ms'] / 2) and got >= 0
    obs.reset()
    for name in READERS[cell]:
        assert harness.reader(name).read({}) is None


def test_totals_of_nested_spans():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs.span('outer', k=1) as outer:
            with obs.span('inner'):
                torch.ones(8).sum()
            with obs.span('inner'):
                pass
        with obs.span('step'):
            pass
    assert isinstance(outer, obs.Span) and outer.attrs == {'k': 1}
    spans = obs.spans()
    assert [(s['name'], s['parent'], s['step']) for s in spans] == [
        ('outer', None, spans[0]['step']), ('inner', 0, spans[0]['step']),
        ('inner', 0, spans[0]['step']), ('step', None, spans[3]['step'])]
    assert spans[3]['step'] != spans[0]['step']
    t = obs.totals()
    assert t['inner']['calls'] == 2 and t['step']['steps'] == 1
    assert t['outer']['host_self_ms'] == pytest.approx(
        t['outer']['host_ms'] - t['inner']['host_ms'])


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', torch.cuda.current_device())


@pytest.mark.card
def test_card_events_launches_and_graph_capture(card):
    """On the card a span records a CUDA event pair and the kernel launches
    inside it (B1 here); a span inside a CUDA-graph capture records no event
    and no device time, and the graph replays the captured work."""
    from lattisense_torch.core import ntt as ntt_mod
    from lattisense_torch.core.modring import get_rns_ring
    ring = get_rns_ring(gen_ntt_primes(N, 31, 3), N, card, 32)
    x = torch.randint(0, ring.moduli[0], (2, 3, N), dtype=torch.int64, device=card)
    want = ntt_mod.ntt(x, ring)                          # builds and loads B1 before the window
    static = torch.empty_like(x)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs.span('eager'):
            got = ntt_mod.ntt(x, ring)
        with torch.cuda.stream(side):
            with torch.cuda.graph(graph, stream=side):
                with obs.span('captured'):
                    static.copy_(ntt_mod.ntt(x, ring))
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(static, want)
    eager, captured = obs.spans()
    assert eager['name'] == 'eager' and eager['launches'] == 1
    assert eager['device_ms'] is not None and eager['device_ms'] >= 0
    assert captured['name'] == 'captured' and captured['device_ms'] is None
    assert captured['launches'] == 1
