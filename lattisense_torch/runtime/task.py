"""Compiled-task runtime: ``mega_ag.json`` → the port's BFV or CKKS engine on one device.

Port of ``lattisense_tpu/runtime/task.py``, after the reference
SDK's ``FheTaskGpu`` (cxx_sdk_v2/cxx_fhe_task.h:132). A task directory holds
the graph (``mega_ag.json``) and its argument signature
(``task_signature.json``); ``FheTaskGpu(task_dir).run(context, inputs)``
checks the arguments against the signature, runs the graph and returns
``(outputs, duration_ns)``.

The graph is ordered once at load time into topological waves, and every
compute node is bound to an executor closure over the engine then. Two modes:

- ``mode='eager'`` runs one executor per compute node, in order;
- ``mode='jit'`` runs the fused plan: structurally identical nodes of one
  wave (the same op, attributes and input metadata) become one engine call
  on their stacked inputs, as ``parallel/batch.py`` stacks a batch. On a
  CUDA device the fused plan is captured once per (input shapes and dtypes,
  key tensors) as one ``torch.cuda.CUDAGraph``, after a warm-up run on a
  side stream, and each run replays it: the counterpart of the reference's
  one jitted XLA program per task. The CPU has no CUDA graph, so there the
  fused plan runs eagerly.

CKKS scales are host metadata: each run seeds the input carriers with its
arguments' scales (the parameter set's scale where an argument has none),
the engine propagates them through the plan, and the outputs carry the
scales the plan gave them for that combination of input scales. A captured
graph cannot see a changed scale, so the input scales select the graph
along with the shapes and the keys (``check_sig`` fixes each input's level,
and the shapes carry it).

- ``mode='partitioned'`` cuts the fused plan at custom and bootstrap nodes
  (the reference's partitioning at custom-op barriers): each span of
  ordinary steps, and each segment of a bootstrap node
  (``CkksBootstrapper.segments``), is captured on the card as a CUDA graph of
  its own and replayed; custom executors run eagerly between them. On the
  CPU every segment runs eagerly. Eager, jit and partitioned runs of one
  task give the same outputs bit for bit.

A bootstrap node runs the context's bootstrapper (``CkksBtpContext``) at the
parameter set's scale and hands its output back at the input's scale, as the
reference's executor does.

The kernels are the engine's: the task runtime launches nothing itself, and
lets every error of a kernel propagate.

``mesh`` (``parallel/mesh.py``, one process a rank, see
``parallel/launch.py``): the members of an iso-op group are split over the
``op`` ranks in contiguous blocks (the last block padded with copies of the
last member), and each group's outputs are all-gathered over ``op``, so that
every rank holds whole values after each step and ``run`` returns whole
outputs on every rank, as the JAX task does. With a ``limb`` or a ``coeff``
axis the task's engine is the sharded view of ``parallel/sharded_engine.py``
(``make_sharded_engine``, every limb on every rank): its key switches
(relinearizations, rotations, hoisted rotations) split their digits over
``limb`` (``ShardedKeySwitcher``), and over ``coeff`` a run cuts its input
ciphertexts to the rank's coefficients, every step computes on coefficient
shards (each fused group's members over ``op``, their key switches' digits
over ``limb``, the polynomials over ``coeff``, as the JAX task's ``_place``
constrains them; plaintext operands are cut at op entry), and the outputs
are all-gathered over ``coeff`` at the end; custom executors then receive
the view, ciphertext shards and whole plaintexts. A bootstrap node on a mesh runs the
context's bootstrapper on a view of the same axes: over ``coeff`` on the
coefficient view, over ``limb`` on the limb view (``parallel/limb_engine.py``,
the input's limbs taken on entry and gathered on exit), over both on the limb
× coefficient view; over ``op`` alone every rank runs the whole bootstrap, as
the JAX task runs the node unplaced. On the card a captured run
(``mode='jit'``, and each span and bootstrap segment of
``mode='partitioned'``) is cut at every collective: the spans between
collectives are CUDA graphs, and the collectives run between their replays,
one design for gloo and NCCL (gloo's collectives cannot be captured).

Under ``LATTISENSE_DEV`` (not empty, not ``0``) each run samples the host's
memory, and on the card the device's, every 100 ms into
``mem_usage_gpu_<i>.csv`` in the working directory
(``utils/observability.py`` ``MemoryMonitor``, as the reference's
``LATTISENSE_DEV`` monitor). The monitor starts after the checks and after
any graph capture of ``mode='jit'``, and stops when the run ends.
"""

import dataclasses
import gc
import json
import logging
import os
import time

import torch

from .. import resolve_device
from ..parallel.limb_engine import make_limb_sharded_engine
from ..parallel.sharded_engine import make_sharded_bootstrapper, make_sharded_engine
from ..params import params_from_task_json
from ..schemes.bfv import BfvEngine
from ..schemes.ckks import CkksEngine
from ..schemes.types import (Ciphertext, DecomposedCiphertext, KeySwitchKey, Plaintext,
                             PlaintextMul, PlaintextRingt)
from ..utils.observability import MemoryMonitor, dev_mode_enabled
from . import check_sig

_KEY_TYPES = ('rlk', 'glk', 'swk')
_log = logging.getLogger(__name__)


class _Node:
    __slots__ = ('index', 'id', 'type', 'level', 'degree', 'is_ntt', 'is_mform',
                 'sp_level', 'galois_element', 'is_custom', 'attributes',
                 'sp_decomped', 'is_compressed')

    def __init__(self, index: int, d: dict):
        self.index = index
        self.id = d['id']
        self.type = d['type']
        self.level = d.get('level', -1)
        self.degree = d.get('degree', -1)
        self.is_ntt = d.get('is_ntt', False)
        self.is_mform = d.get('is_mform', False)
        self.sp_level = d.get('sp_level')
        self.galois_element = d.get('galois_element')
        self.is_custom = d.get('is_custom', False)
        self.attributes = d.get('attributes', {})
        self.sp_decomped = d.get('poly1_rns_sp_decomped', False)
        self.is_compressed = d.get('is_compressed', False)


def _wrap_input(node: _Node, data, scale: float):
    """Tensor → typed carrier from the data node's static metadata and the
    run's scale for it."""
    if node.is_custom:
        return data             # custom payloads pass through untyped
    t = node.type
    if t in ('ct', 'ct3'):
        return Ciphertext(data=data, level=node.level, is_ntt=node.is_ntt,
                          is_mform=node.is_mform, scale=scale)
    if t == 'pt':
        return Plaintext(data=data, level=node.level, is_ntt=node.is_ntt, scale=scale)
    if t == 'pt_ringt':
        return PlaintextRingt(data=data, scale=scale)
    if t == 'pt_mul':
        return PlaintextMul(data=data, level=node.level, scale=scale)
    raise ValueError(f'cannot wrap input of type {t}')


def _same(ct):
    return ct


def _tensor_fields(v) -> tuple[str, ...]:
    return ('c0', 'digits') if isinstance(v, DecomposedCiphertext) else ('data',)


def _meta(v):
    """What members of a fused group must share to be stacked: the carrier
    type, its static fields, and each tensor's shape and dtype."""
    tensors = _tensor_fields(v)
    static = tuple((f.name, getattr(v, f.name)) for f in dataclasses.fields(v)
                   if f.name not in tensors)
    return (type(v), static, tuple((tuple(getattr(v, f).shape), getattr(v, f).dtype)
                                   for f in tensors))


def _stack(vals):
    return dataclasses.replace(vals[0], **{f: torch.stack([getattr(v, f) for v in vals])
                                           for f in _tensor_fields(vals[0])})


def _member(v, k: int):
    return dataclasses.replace(v, **{f: getattr(v, f)[k] for f in _tensor_fields(v)})


def _value_meta(v):
    """The metadata a captured segment holds for one value: ``_meta`` of a
    carrier, the shape and dtype of a bare tensor (a custom payload)."""
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), v.dtype)
    return _meta(v)


def _flatten(vals):
    """Values (carriers or bare tensors) → (their tensors, a function that
    rebuilds values of the same metadata from such tensors)."""
    tensors, spans = [], []
    for v in vals:
        fields = None if isinstance(v, torch.Tensor) else _tensor_fields(v)
        spans.append((v, fields))
        tensors += [v] if fields is None else [getattr(v, f) for f in fields]

    def rebuild(ts):
        out, k = [], 0
        for v, fields in spans:
            if fields is None:
                out.append(ts[k])
                k += 1
            else:
                out.append(dataclasses.replace(v, **dict(zip(fields, ts[k:k + len(fields)]))))
                k += len(fields)
        return out
    return tensors, rebuild


class _Graph:
    """One captured replay of ``fn`` (input tensors → output tensors, the
    fused plan or one segment of it): static input buffers, the graph, and
    its static outputs (cloned on every run). ``fn`` runs once more before
    the capture, on a side stream, for its first-call work; ``keep`` (the key
    tensors the graph reads in place) stays alive with it.

    With a ``mesh`` the capture is cut at each collective: ``program`` is the
    graphs of the spans between collectives (one memory pool), and between
    them the collectives, each from a static input to a static output, which
    a replay runs eagerly."""

    def __init__(self, fn, arrays, dev, keep, mesh=None):
        self.inputs = [a.clone() for a in arrays]
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                # first-call work (kernel builds and loads, table caches,
                # occupancy queries, encoded constants) happens here,
                # outside the capture
                fn(self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            # a dead reference cycle that holds another task's graph or
            # tensors, freed by the collector in mid-capture, would free
            # device memory there and invalidate the capture: collect now,
            # and not during the capture
            gc.collect()
            was_enabled = gc.isenabled()
            gc.disable()
            try:
                if mesh is None:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        self.outputs = fn(self.inputs)
                    self.program = [graph]
                else:
                    self.outputs = self._capture_spans(fn, mesh, dev)
            finally:
                if was_enabled:
                    gc.enable()
        self.keep = keep

    def _capture_spans(self, fn, mesh, dev):
        pool = torch.cuda.graph_pool_handle()
        program, cur = [], []

        def begin():
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=pool)
            cur.append(g)

        def end():
            g = cur.pop()
            g.capture_end()
            program.append(g)

        def collective(do, x, out_shape):
            end()
            out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
            program.append((do, x, out))
            begin()
            return out
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            mesh._recorder = collective
            begin()
            try:
                outputs = fn(self.inputs)
            finally:
                mesh._recorder = None
                end()
        self.program = program
        return outputs

    @property
    def graphs(self) -> int:
        return sum(isinstance(p, torch.cuda.CUDAGraph) for p in self.program)

    def __call__(self, arrays):
        for buf, a in zip(self.inputs, arrays):
            buf.copy_(a)
        for step in self.program:
            if isinstance(step, torch.cuda.CUDAGraph):
                step.replay()
            else:
                do, x, out = step
                out.copy_(do(x))
        return [o.clone() for o in self.outputs]


def _op_block(v, lo: int, k: int, m: int):
    """Members lo .. lo+k-1 of a stacked carrier of m members, the ones past
    the end repeating member m-1."""
    def take(t):
        idx = torch.arange(lo, lo + k, device=t.device).clamp_(max=m - 1)
        return t.index_select(0, idx)
    return dataclasses.replace(v, **{f: take(getattr(v, f)) for f in _tensor_fields(v)})


class FheTaskGpu:
    """Loads a compiled task directory and runs it on one device.

    API after the reference SDK's FheTaskGpu (cxx_sdk_v2/cxx_fhe_task.h:132):
    construct from the task directory, then ``run(context, inputs)`` →
    (outputs, duration_ns). ``device`` defaults to the card (``resolve_device``);
    the context must live on the same device. Custom compute nodes run
    ``custom_executors[type](engine, inputs, attrs)``; in ``mode='jit'`` on
    the card they are captured into the graph with the rest, so they must
    run on the card without reading values back to the host.
    """

    def __init__(self, task_dir: str, mode: str = 'jit', batch_fuse: bool = True,
                 custom_executors: dict | None = None, device=None, mesh=None):
        if mode not in ('jit', 'eager', 'partitioned'):
            raise ValueError(f"mode must be 'jit', 'eager' or 'partitioned', got {mode!r}")
        with open(os.path.join(task_dir, 'mega_ag.json')) as f:
            self.mag = json.load(f)
        with open(os.path.join(task_dir, 'task_signature.json')) as f:
            self.signature = json.load(f)
        self.algo = self.mag['algorithm']
        self.mode = mode
        self.batch_fuse = batch_fuse
        self.custom_executors = custom_executors or {}
        self.mesh = mesh
        self.device = resolve_device(mesh.device if device is None and mesh is not None
                                     else device)
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f'the task runs on {self.device}, its mesh on {mesh.device}')
        self._offline: dict = {}
        self.data = {int(k): _Node(int(k), v) for k, v in self.mag['data'].items()}
        self.inputs = list(self.mag['inputs'])
        self.outputs = list(self.mag['outputs'])
        self._bind(params_from_task_json(self.mag['parameter']))

    def _bind(self, params):
        """(Re)build the engine on ``params``' word, the plan, and drop the
        captured graphs."""
        self.params = params
        self.engine = (BfvEngine if self.algo == 'BFV' else CkksEngine)(params, self.device)
        self._coeff = self.mesh is not None and self.mesh.shape['coeff'] > 1
        if self._coeff or (self.mesh is not None and self.mesh.shape['limb'] > 1):
            self.engine = make_sharded_engine(self.engine, self.mesh)
        self._btp = None
        self._sharded_btp: dict = {}
        self._build_plan()
        self._graphs: dict = {}
        self._out_scales: dict = {}

    # ------------------------------------------------------------------
    # Plan construction (load-time executor binding)
    # ------------------------------------------------------------------
    def _build_plan(self):
        computes = {int(k): v for k, v in self.mag['compute'].items()}
        # topo order over compute nodes (Kahn on data availability); the
        # ready waves double as layers for the iso-op batching pass
        available = set(self.inputs)
        pending = dict(computes)
        order, layers = [], []
        while pending:
            ready = [idx for idx, c in pending.items()
                     if all(i in available for i in c['inputs'])]
            if not ready:
                raise ValueError('mega_ag graph contains a cycle or missing input')
            wave = []
            for idx in sorted(ready):
                c = pending.pop(idx)
                order.append(c)
                wave.append(c)
                for o in computes[idx]['outputs']:
                    available.add(o)
            layers.append(wave)
        self.plan_meta = []
        if self.batch_fuse and self.mode in ('jit', 'partitioned'):
            self.plan = self._build_batched_plan(layers)
        else:
            self.plan = [self._bind_executor(c) for c in order]
            self.plan_meta = [self._step_meta([c]) for c in order]

    # Iso-op batching: structurally identical nodes of one topo wave (the
    # reference's benchmark graphs carry many parallel mult_relins) become
    # one engine call on stacked inputs.
    def _node_sig(self, i: int):
        nd = self.data[i]
        return (nd.type, nd.level, nd.degree, nd.is_ntt, nd.is_mform,
                nd.sp_level, nd.galois_element, nd.is_compressed,
                nd.sp_decomped)

    def _compute_sig(self, c: dict):
        static = {k: v for k, v in c.items()
                  if k not in ('id', 'inputs', 'outputs')}
        return (json.dumps(static, sort_keys=True),
                tuple(self._node_sig(i) for i in c['inputs']))

    def _build_batched_plan(self, layers):
        plan = []
        for wave in layers:
            groups: dict = {}
            for c in wave:
                groups.setdefault(self._compute_sig(c), []).append(c)
            for members in groups.values():
                if (len(members) == 1 or members[0].get('is_custom')
                        or members[0]['type'] == 'bootstrap'):
                    plan += [self._bind_executor(c) for c in members]
                    self.plan_meta += [self._step_meta([c]) for c in members]
                else:
                    plan.append(self._bind_group_executor(members))
                    self.plan_meta.append(self._step_meta(members))
        return plan

    @staticmethod
    def _step_meta(members):
        """What a plan step reads and writes, and whether it is a custom or a
        bootstrap node (the partitioned mode's barriers)."""
        ins, outs = set(), set()
        for c in members:
            ins.update(c['inputs'])
            outs.update(c['outputs'])
        return {'inputs': ins, 'outputs': outs, 'custom': bool(members[0].get('is_custom')),
                'op': members[0]['type']}

    def _bind_group_executor(self, members):
        """One step for a fused group: ``torch.stack`` of each input position
        over the members, one engine call on the stacked carriers (every
        engine op takes leading batch dimensions), then per-member views of
        the result. Members whose inputs differ in metadata run per op,
        with a warning; nothing here catches an error of the engine."""
        template = members[0]
        run_one = self._bind_executor(template)
        in_tmpl = list(template['inputs'])
        data_pos = [k for k, i in enumerate(in_tmpl)
                    if self.data[i].type not in _KEY_TYPES]
        out_tmpl = template['outputs'][0]
        member_ins = [[c['inputs'][k] for k in data_pos] for c in members]
        member_outs = [c['outputs'][0] for c in members]
        per_op = []

        def run(env, keys):
            cols = [[env[ins[k]] for ins in member_ins] for k in range(len(data_pos))]
            if any(len({_meta(v) for v in col}) > 1 for col in cols):
                # loud on purpose: losing iso-op batching silently would drop
                # the runtime's main parallelism mechanism
                _log.warning('iso-op batching fell back to per-op execution for %d %r ops '
                             '(their inputs differ in metadata); throughput will degrade',
                             len(members), template.get('type'))
                if not per_op:
                    per_op.extend(self._bind_executor(c) for c in members)
                for step in per_op:
                    step(env, keys)
                return
            sub = {in_tmpl[k]: _stack(col) for k, col in zip(data_pos, cols)}
            ops = 1 if self.mesh is None else self.mesh.shape['op']
            if ops > 1:
                # this rank's block of members, then every rank's outputs
                m = len(members)
                k = -(-m // ops)
                sub = {i: _op_block(v, self.mesh.index('op') * k, k, m) for i, v in sub.items()}
            run_one(sub, keys)
            out = sub[out_tmpl]
            if ops > 1:
                out = dataclasses.replace(out, **{
                    f: self.mesh.all_gather(getattr(out, f), 'op', 0)[:len(members)]
                    for f in _tensor_fields(out)})
            for k, o in enumerate(member_outs):
                env[o] = _member(out, k)
        return run

    def _classify_inputs(self, c: dict):
        """Split compute inputs into (cts, ct3s, pts, key_nodes) preserving
        order — the executor-selection rule of CPU_EXECUTOR_SETUP
        (mega_ag_executors_cpu.cpp:33)."""
        cts, ct3s, pts, keys = [], [], [], []
        for i in c['inputs']:
            node = self.data[i]
            if node.type == 'ct':
                cts.append(node)
            elif node.type == 'ct3':
                ct3s.append(node)
            elif node.type in ('pt', 'pt_ringt', 'pt_mul'):
                pts.append(node)
            elif node.type in _KEY_TYPES:
                keys.append(node)
            else:
                raise ValueError(f'unknown input datum type {node.type}')
        return cts, ct3s, pts, keys

    def _bind_executor(self, c: dict):
        """One compute node → closure(env, keys). Dispatch mirrors
        bind_cpu_{add,sub,...} (mega_ag_executors_cpu.cpp:96-505)."""
        op = c['type']
        eng = self.engine
        out_idx = c['outputs'][0] if c['outputs'] else None

        if c.get('is_custom'):
            fn = self.custom_executors.get(op)
            if fn is None:
                raise ValueError(f'no executor bound for custom compute type '
                                 f'"{op}"; pass custom_executors={{...}}')
            in_nodes = [self.data[i] for i in c['inputs']]
            attrs = c.get('attributes', {})

            def run(env, keys):
                env[out_idx] = fn(eng, [env[n.index] for n in in_nodes], attrs)
            return run

        cts, ct3s, pts, keynodes = self._classify_inputs(c)

        def ctv(env, k=0):
            return env[cts[k].index]

        def ringt_block(env, pi, block):
            # one block of compressed pt_ringt storage (..., blocks, n)
            return PlaintextRingt(data=env[pi].data[..., block, :])

        if op in ('add', 'sub'):
            f = eng.add if op == 'add' else eng.sub
            if len(c['inputs']) == 1:
                def run(env, keys):
                    env[out_idx] = f(ctv(env), ctv(env))
            elif pts:
                pi = pts[0].index

                def run(env, keys):
                    env[out_idx] = f(ctv(env), env[pi])
            else:
                def run(env, keys):
                    env[out_idx] = f(ctv(env), env[cts[1].index])
            return run

        if op == 'neg':
            def run(env, keys):
                env[out_idx] = eng.neg(ctv(env))
            return run

        if op == 'mult':
            if len(c['inputs']) == 1:
                def run(env, keys):
                    env[out_idx] = eng.mult(ctv(env), ctv(env))
            elif pts and pts[0].is_compressed:
                # compressed pt_ringt storage: the op consumes one block,
                # selected by the node's compressed_block_info
                pi = pts[0].index
                block = int(c['compressed_block_info'][0])

                def run(env, keys):
                    env[out_idx] = eng.mult(ctv(env), ringt_block(env, pi, block))
            elif pts:
                pi = pts[0].index

                def run(env, keys):
                    env[out_idx] = eng.mult(ctv(env), env[pi])
            else:
                def run(env, keys):
                    env[out_idx] = eng.mult(ctv(env), env[cts[1].index])
            return run

        if op == 'relin':
            src = ct3s[0].index

            def run(env, keys):
                env[out_idx] = eng.relinearize(env[src], keys['rlk'])
            return run

        if op == 'rescale':
            def run(env, keys):
                env[out_idx] = eng.rescale(ctv(env))
            return run

        if op == 'drop_level':
            if self.algo == 'BFV':
                raise ValueError('DROP_LEVEL only supported for CKKS scheme')

            def run(env, keys):
                env[out_idx] = eng.drop_level(ctv(env), 1)
            return run

        if op in ('rotate_col', 'rotate_row'):
            elt = keynodes[0].galois_element
            out_node = self.data[out_idx]
            o_ntt, o_mf = out_node.is_ntt, out_node.is_mform
            if cts[0].sp_decomped:
                def run(env, keys):
                    env[out_idx] = eng.apply_galois_decomposed(
                        env[cts[0].index], elt, keys['glk'][elt], out_ntt=o_ntt, out_mform=o_mf)
                return run
            if self.algo != 'BFV':
                # CKKS ciphertexts stay in the NTT domain
                def run(env, keys):
                    env[out_idx] = eng.apply_galois(ctv(env), elt, keys['glk'][elt])
                return run

            def run(env, keys):
                env[out_idx] = eng.apply_galois(ctv(env), elt, keys['glk'][elt],
                                                out_ntt=o_ntt, out_mform=o_mf)
            return run

        if op in ('cmp_sum', 'cmpac_sum'):
            n = c['sum_cnt']
            ct_nodes = cts[:n]
            acc_node = cts[n] if op == 'cmpac_sum' else None
            if pts and pts[0].is_compressed:
                pi = pts[0].index
                blocks = [int(b) for b in c['compressed_block_info']]

                def get_pt(env, i):
                    return ringt_block(env, pi, blocks[i])
            else:
                pt_nodes = pts[:n]

                def get_pt(env, i):
                    return env[pt_nodes[i].index]

            def run(env, keys):
                total = None
                for i, ci in enumerate(ct_nodes):
                    prod = eng.mult(env[ci.index], get_pt(env, i))
                    total = prod if total is None else eng.add(total, prod)
                if acc_node is not None:
                    total = eng.add(total, env[acc_node.index])
                env[out_idx] = total
            return run

        if op == 'bootstrap':
            # at the parameter set's scale, the output handed back at the
            # input's (mega_ag_executors_cpu.cpp:460-463)
            def run(env, keys):
                ct = env[cts[0].index]
                bs, enter, leave = self._bootstrapper()
                swk = keys['swk']
                out = leave(bs(enter(Ciphertext(data=ct.data, level=ct.level, is_ntt=ct.is_ntt,
                                                scale=self.params.scale)),
                               keys['rlk'], keys['glk'], swk_dts=swk.get('swk_dts'),
                               swk_std=swk.get('swk_std')))
                out.scale = ct.scale
                env[out_idx] = out
            return run

        if op in ('to_ntt', 'to_inv_ntt', 'to_mf', 'to_mul', 'rns_sp_decomp'):
            meth = getattr(eng, op)

            def run(env, keys):
                env[out_idx] = meth(ctv(env))
            return run

        raise ValueError(f'unknown operation type "{op}"')

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------
    def _key_signature_order(self):
        """The serializer appends key nodes to mega_ag.inputs after the data
        args: rlk, then glk (col then row, dict order), then btp swks
        (frontend/custom_task.py process_custom_task)."""
        return [i for i in self.inputs if self.data[i].type in _KEY_TYPES]

    def _data_input_nodes(self):
        return [self.data[i] for i in self.inputs
                if self.data[i].type not in _KEY_TYPES]

    def _flatten_args(self, input_values: dict):
        """Positional binding: signature row order × row-major flattening,
        exactly like CArgument marshaling (cpu_task_utils.h:235)."""
        flat = []
        rows = [r for r in self.signature['online'] if r['phase'] == 'in']
        rows += self.signature.get('offline', [])
        for row in rows:
            flat += check_sig.flatten(input_values[row['id']])
        return flat

    def _build_keys(self, key_tree):
        """key tree → typed KeySwitchKey env (shared by both modes)."""
        keys = {'rlk': None, 'glk': {}, 'swk': {}}
        for i in self._key_signature_order():
            node = self.data[i]
            if node.type == 'rlk':
                kq, kp = key_tree['rlk']
                keys['rlk'] = KeySwitchKey(key_q=kq, key_p=kp, level=node.level,
                                           sp_level=node.sp_level)
            elif node.type == 'glk':
                kq, kp = key_tree['glk'][node.galois_element]
                keys['glk'][node.galois_element] = KeySwitchKey(
                    key_q=kq, key_p=kp, level=node.level, sp_level=node.sp_level)
            elif node.type == 'swk':
                kq, kp = key_tree['swk'][node.id]
                keys['swk'][node.id] = KeySwitchKey(
                    key_q=kq, key_p=kp, level=node.level, sp_level=node.sp_level)
        return keys

    def _seed_env(self, input_arrays, scales) -> dict:
        """The inputs as carriers; on a coefficient mesh, this rank's
        coefficients of each."""
        env = {node.index: _wrap_input(node, arr, sc)
               for node, arr, sc in zip(self._data_input_nodes(), input_arrays, scales)}
        if self._coeff:
            for i, v in env.items():
                if isinstance(v, Ciphertext):
                    env[i] = dataclasses.replace(v, data=self.engine._sh_local(v.data))
        return env

    def _finish(self, env, scales):
        """The output tensors of a run (all-gathered over ``coeff`` on a
        coefficient mesh); the output scales the plan gave are recorded for
        this combination of input ``scales``."""
        self._out_scales[tuple(scales)] = [getattr(env[o], 'scale', 1.0) for o in self.outputs]
        out = [env[o].data for o in self.outputs]
        if self._coeff:
            out = [self.mesh.all_gather(t, 'coeff', t.dim() - 1) for t in out]
        return out

    def _bootstrapper(self):
        """(bootstrapper, enter, leave) for a bootstrap node: the context's
        bootstrapper, on a view of the mesh's limb and coefficient axes when
        it has them; ``enter`` takes a ciphertext's limbs of this rank,
        ``leave`` gathers them (identities without a limb axis)."""
        btp = self._btp
        if btp is None:
            raise RuntimeError('engine has no bootstrapper; use CkksBtpContext')
        mesh = self.mesh
        if mesh is None or (mesh.shape['limb'] == 1 and not self._coeff):
            return btp, _same, _same
        hit = self._sharded_btp.get(id(btp))
        if hit is None or hit[0] is not btp:
            if mesh.shape['limb'] > 1:
                base = getattr(self.engine, '_sh_base', self.engine)
                view = make_limb_sharded_engine(base, mesh)
                rows = view._sh_rows

                def enter(ct):
                    return dataclasses.replace(ct, data=rows.take(ct.data, ct.level + 1))

                def leave(ct):
                    return dataclasses.replace(ct, data=rows.gather(ct.data, ct.level + 1))
            else:
                view, enter, leave = self.engine, _same, _same
            hit = self._sharded_btp[id(btp)] = (btp, make_sharded_bootstrapper(btp, view),
                                                enter, leave)
        return hit[1:]

    def _trace(self, input_arrays, key_tree, scales, progress=None):
        """Run the plan on input tensors at the input ``scales``; → the output
        tensors."""
        env = self._seed_env(input_arrays, scales)
        keys = self._build_keys(key_tree)
        for i, step in enumerate(self.plan):
            step(env, keys)
            if progress is not None:
                progress(i + 1)
        return self._finish(env, scales)

    # ------------------------------------------------------------------
    # Partitioned execution: the plan cut at custom and bootstrap steps
    # (the reference's partitioning at custom-op barriers,
    # frontend/custom_task.py:2039-2184); a bootstrap node runs segment by
    # segment (CkksBootstrapper.segments). On the card each span and each
    # bootstrap segment is a CUDA graph of its own.
    # ------------------------------------------------------------------
    def _segments(self):
        """[(kind, plan step indices)], kind 'span', 'custom' or 'btp'."""
        segs, cur = [], []
        for i, meta in enumerate(self.plan_meta):
            if meta['custom'] or meta['op'] == 'bootstrap':
                if cur:
                    segs.append(('span', cur))
                    cur = []
                segs.append(('custom' if meta['custom'] else 'btp', [i]))
            else:
                cur.append(i)
        if cur:
            segs.append(('span', cur))
        return segs

    def _run_partitioned(self, input_arrays, key_tree, scales, progress=None):
        env = self._seed_env(input_arrays, scales)
        keys = self._build_keys(key_tree)
        done = 0
        for si, (kind, idxs) in enumerate(self._segments()):
            meta = self.plan_meta[idxs[0]]
            if kind == 'custom':
                self.plan[idxs[0]](env, keys)
            elif kind == 'btp':
                self._run_btp_segments(si, env, keys, key_tree, meta)
            else:
                steps = [self.plan[k] for k in idxs]
                in_ids = sorted({i for k in idxs for i in self.plan_meta[k]['inputs']
                                 if i in env})
                out_ids = sorted({o for k in idxs for o in self.plan_meta[k]['outputs']})

                def body(sub, steps=steps, out_ids=out_ids):
                    e = dict(sub)
                    for step in steps:
                        step(e, keys)
                    return {o: e[o] for o in out_ids}
                env.update(self._segment_call(('span', si, tuple(scales)),
                                              {i: env[i] for i in in_ids}, body, key_tree))
            done += len(idxs)
            if progress is not None:
                progress(done)
        return self._finish(env, scales)

    def _run_btp_segments(self, si, env, keys, key_tree, meta):
        """One bootstrap node, segment by segment, as the eager executor
        runs it (at the parameter set's scale, handed back at the input's)."""
        bs, enter, leave = self._bootstrapper()
        ct = next(env[i] for i in meta['inputs'] if i in env)
        out_id = next(iter(meta['outputs']))
        caller = self.params.scale
        cts = (bs.prepare(enter(Ciphertext(data=ct.data, level=ct.level, is_ntt=ct.is_ntt,
                                           scale=caller))),)
        swk = keys['swk']
        for k, (_name, fn) in enumerate(bs.segments(caller, swk.get('swk_dts'),
                                                    swk.get('swk_std'))):
            def body(sub, fn=fn):
                return dict(enumerate(fn(tuple(sub[j] for j in range(len(sub))), keys['rlk'],
                                         keys['glk'])))
            out = self._segment_call(('btp', si, k), dict(enumerate(cts)), body, key_tree)
            cts = tuple(out[j] for j in range(len(out)))
        out = leave(cts[0])
        out.scale = ct.scale
        env[out_id] = out

    def _segment_call(self, tag, values: dict, body, key_tree) -> dict:
        """``body(values)`` → {id: value}: eagerly on the CPU; on the card
        through a CUDA graph captured once per (``tag``, the values'
        metadata and shapes, the key tensors), whose outputs are re-wrapped
        with the metadata of its capture run."""
        if self.device.type != 'cuda':
            return body(values)
        ids = sorted(values)
        tensors, rebuild = _flatten([values[i] for i in ids])
        gk = (tag, tuple(_value_meta(values[i]) for i in ids),
              self._graph_key([], key_tree, ())[1])
        g = self._graphs.get(gk)
        if g is None:
            made = {}

            def fn(ins):
                out = body(dict(zip(ids, rebuild(ins))))
                made['ids'] = sorted(out)
                flat, made['rebuild'] = _flatten([out[i] for i in made['ids']])
                return flat
            g = self._graphs[gk] = _Graph(fn, tensors, self.device, key_tree, self.mesh)
            g.out_ids, g.rebuild = made['ids'], made['rebuild']
        return dict(zip(g.out_ids, g.rebuild(g(tensors))))

    def _context_key_tree(self, context):
        tree = {'rlk': None, 'glk': {}, 'swk': {}}
        for i in self._key_signature_order():
            node = self.data[i]
            if node.type == 'rlk':
                tree['rlk'] = (context.rlk.key_q, context.rlk.key_p)
            elif node.type == 'glk':
                k = context.glk.keys[node.galois_element]
                tree['glk'][node.galois_element] = (k.key_q, k.key_p)
            elif node.type == 'swk':
                k = context.swk[node.id]
                tree['swk'][node.id] = (k.key_q, k.key_p)
        return tree

    @staticmethod
    def _graph_key(arrays, key_tree, scales):
        """A captured graph reads its keys in place and holds the scales of
        its capture as constants: the key tensors' addresses and shapes, the
        inputs' shapes and dtypes and their scales select it. The levels
        need no place here: ``check_sig`` pins each input's level to the
        signature's, and the shapes carry it."""
        keys = [key_tree['rlk']] + list(key_tree['glk'].values()) + list(key_tree['swk'].values())
        return (tuple((tuple(a.shape), a.dtype) for a in arrays),
                tuple((t.data_ptr(), tuple(t.shape)) for pair in keys if pair is not None
                      for t in pair), scales)

    def _graph_for(self, arrays, key_tree, scales):
        gk = self._graph_key(arrays, key_tree, scales)
        g = self._graphs.get(gk)
        if g is None:
            g = self._graphs[gk] = _Graph(
                lambda ins: self._trace(ins, key_tree, scales), arrays, self.device, key_tree,
                self.mesh)
        return g

    def _replays(self) -> bool:
        return self.mode == 'jit' and self.device.type == 'cuda'

    def preload(self, context, offline_values: dict):
        """Stage the offline-input phase once (reference offline_inputs:
        constant data preloaded before many online runs,
        frontend/custom_task.py:2190-2205). Later run() calls need only the
        online arguments."""
        for row in self.signature.get('offline', []):
            if row['id'] not in offline_values:
                raise RuntimeError(f"Missing input argument \"{row['id']}\".")
            check_sig.check_with_sig(row['id'], offline_values[row['id']], row)
        self._offline = dict(offline_values)

    def _adopt_context_word(self, context):
        """Re-bind the task engine onto the caller context's RNS word.

        The serialized parameter blob is word-agnostic (the same primes
        either way); a context on the 32-bit word runs the 32-bit kernels,
        so the engine, the plan and the captured graphs are rebuilt once on
        a change of word."""
        wb = getattr(context.params, 'word_bits', 64)
        if wb != self.params.word_bits:
            self._bind(params_from_task_json(self.mag['parameter'], word_bits=wb))

    def check(self, context, input_values: dict):
        self._adopt_context_word(context)
        check_sig.check_signatures(context, self.signature, input_values,
                                   [r for r in self.signature['online']
                                    if r['phase'] == 'out'])
        check_sig.check_parameter(context, self.mag['parameter'])

    def _prepare(self, context, input_values: dict):
        """Check the arguments and the context; → (input tensors, key tree,
        input scales)."""
        if self._offline:
            input_values = {**self._offline, **input_values}
        self.check(context, input_values)
        ctx_dev = torch.device(getattr(context, 'device', 'cpu'))
        if ctx_dev != self.device:
            raise RuntimeError(f'the context is on {ctx_dev}, the task on {self.device}')
        # the bootstrap precompute lives on the caller's context engine
        btp = getattr(context.engine, 'bootstrapper', None)
        if btp is not None:
            self._btp = btp
        flat = self._flatten_args(input_values)
        arrays = [torch.as_tensor(v.data, dtype=torch.int64, device=self.device) for v in flat]
        default = getattr(self.params, 'scale', 1.0)
        scales = tuple(float(getattr(v, 'scale', default)) for v in flat)
        return arrays, self._context_key_tree(context), scales

    def run(self, context, input_values: dict, progress_cb=None):
        """Validate, execute, return ({output_id: value}, duration_ns).

        The ns return mirrors FheTaskCpu::run (cxx_fhe_task_cpu.cpp:104):
        it covers execution only, and on the card the clock stops after
        ``torch.cuda.synchronize``. In ``mode='jit'`` a graph's warm-up and
        capture on first use (or in ``compile``) are outside it; in
        ``mode='partitioned'`` the segments' graphs are captured in the first
        run (or in ``compile``). ``progress_cb(completed, total)`` is called
        per op, throttled to 100 ms, in eager mode, per segment in
        partitioned mode, and at 0 and at the end in jit mode."""
        arrays, key_tree, scales = self._prepare(context, input_values)
        total = len(self.plan)
        graph = self._graph_for(arrays, key_tree, scales) if self._replays() else None
        monitor = None
        if dev_mode_enabled():
            monitor = MemoryMonitor(100, with_device=self.device.type == 'cuda')
            monitor.start(MemoryMonitor.next_csv_path('mem_usage_gpu'))
        try:
            out_arrays, duration_ns = self._execute(arrays, key_tree, scales, graph, total,
                                                    progress_cb)
        finally:
            if monitor is not None:
                monitor.stop()

        # re-wrap outputs per graph metadata and the scales the plan gave
        # them for these input scales, grouped by signature rows
        flat_out = []
        for node, arr, sc in zip((self.data[i] for i in self.outputs), out_arrays,
                                 self._out_scales[scales]):
            v = _wrap_input(node, arr, sc)
            if isinstance(v, Ciphertext):
                v.level = arr.shape[-2] - 1   # shape is ground truth
            flat_out.append(v)
        outputs = {}
        pos = 0
        for row in (r for r in self.signature['online'] if r['phase'] == 'out'):
            cnt = 1
            for s in row['size']:
                cnt *= s
            vals = flat_out[pos:pos + cnt]
            pos += cnt
            outputs[row['id']] = vals[0] if row['size'] == [1] else _reshape(vals, row['size'])
        return outputs, duration_ns

    def _execute(self, arrays, key_tree, scales, graph, total, progress_cb):
        """One run of the plan (eager, partitioned, or the graph's replay);
        → (output tensors, ns until the card has finished)."""
        start = time.perf_counter_ns()
        if self.mode == 'eager' and progress_cb is not None:
            last = [0.0]

            def wrapped_cb(done):
                now = time.monotonic()
                if done >= total or now - last[0] >= 0.1:   # 100 ms throttle
                    last[0] = now
                    progress_cb(done, total)
            out_arrays = self._trace(arrays, key_tree, scales, progress=wrapped_cb)
        elif self.mode == 'partitioned':
            out_arrays = self._run_partitioned(
                arrays, key_tree, scales,
                progress=None if progress_cb is None else (lambda done: progress_cb(done, total)))
        else:
            if progress_cb is not None:
                progress_cb(0, total)
            out_arrays = (graph(arrays) if graph is not None
                          else self._trace(arrays, key_tree, scales))
            if progress_cb is not None:
                progress_cb(total, total)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return out_arrays, time.perf_counter_ns() - start

    def compile(self, context, input_values: dict):
        """The warm-up and capture of the graphs for these arguments: on the
        card, the fused plan's graph without running it (``mode='jit'``), or
        one partitioned run, which captures every segment's graph
        (``mode='partitioned'``); otherwise only the checks."""
        arrays, key_tree, scales = self._prepare(context, input_values)
        if self._replays():
            self._graph_for(arrays, key_tree, scales)
        elif self.mode == 'partitioned' and self.device.type == 'cuda':
            self._run_partitioned(arrays, key_tree, scales)


def _reshape(flat: list, shape: list):
    if len(shape) <= 1:
        return flat
    step = len(flat) // shape[0]
    return [_reshape(flat[i * step:(i + 1) * step], shape[1:]) for i in range(shape[0])]


# the reference SDK's entry-point name
FheTask = FheTaskGpu
