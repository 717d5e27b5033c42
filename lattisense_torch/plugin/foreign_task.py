"""ForeignTask: the task runtime over foreign raw-RNS C structs.

Port of ``lattisense_tpu/plugin/foreign_task.py``, after the reference SEAL
plug-in's FheTaskGpu::run contract (plug-in/SEAL/acc/runner.{h,cpp}): the
caller owns only C ABI structs (CCiphertext / CPlaintext / CRelinKey /
CGaloisKey of ``abi.py``) and never touches this package's types.
``ForeignTask``

1. loads the compiled task directory (task_signature.json + mega_ag.json)
   into the port's ``FheTask`` (``mode='jit'``: one CUDA graph a task on
   the card),
2. checks the foreign arguments against the signature with the reference
   plug-in's error strings word for word (plug-in/SEAL/acc/check_sig.h:38-96),
3. checks the key signature levels (check_key_signatures, :76-96),
4. imports the structs into tensors on the task's device, runs the task,
   and exports the outputs as fresh CCiphertext structs over host buffers.

Montgomery form follows ``mf_nbits`` (cxx_abi_bridge_executors.h:70): 0
exchanges plain NTT-domain keys, which re-enter Montgomery form on import;
any other value takes the keys as the engine's word stores them.
``word_bits`` is the RNS word the task runs on (a task directory is
word-agnostic): 64 by default, as in the JAX package.

The imported keys are copied into key tensors the task keeps from one run
to the next whenever their shapes repeat, so a run with new key buffers
replays the graph captured for the old ones instead of capturing another.
"""

import json
import os
import time

from .. import abi
from ..core.modring import get_rns_ring
from ..params import BfvParams, params_from_task_json
from ..runtime.context import BfvContext, CkksContext
from ..runtime.task import FheTask
from ..schemes.types import GaloisKeys, KeySwitchKey

_TYPE_OF_STRUCT = {
    abi.CCiphertext: 'ct',
    abi.CPlaintext: 'pt',
}
# the reference plug-in collapses pt variants onto PLAINTEXT
# (str_seal_argument_type_map, plug-in/SEAL/acc/check_sig.h:32)
_COMPATIBLE = {'ct': {'ct'}, 'pt': {'pt', 'pt_ringt'}}


def _flatten(nested):
    if isinstance(nested, (list, tuple)):
        out = []
        for x in nested:
            out += _flatten(x)
        return out
    return [nested]


class ForeignVectorArgument:
    """(arg_id, nested C structs) with flat homogeneous-type and level
    checks — the SealVectorArgument analog (plug-in/SEAL/acc/argument.h)."""

    def __init__(self, arg_id: str, structs):
        self.arg_id = arg_id
        self.flat = _flatten(structs)
        if not self.flat:
            raise ValueError(f'argument {arg_id} is empty')
        kinds = {type(s) for s in self.flat}
        if len(kinds) > 1:
            raise TypeError(f'argument {arg_id} mixes struct types: {kinds}')
        kind = kinds.pop()
        if kind not in _TYPE_OF_STRUCT:
            raise TypeError(f'argument {arg_id}: unsupported struct {kind}')
        self.type = _TYPE_OF_STRUCT[kind]
        levels = {int(s.level) for s in self.flat}
        if len(levels) > 1:
            raise ValueError(f'argument {arg_id} mixes levels: {levels}')
        self.level = levels.pop()


class ForeignTask:
    """Run a compiled task on foreign buffers (the reference FheTaskGpu's
    shape) on ``device`` (the card unless ``device='cpu'``)."""

    def __init__(self, task_dir: str, mode: str = 'jit', device=None, word_bits: int = 64):
        self.task = FheTask(task_dir, mode=mode, device=device)
        self.device = self.task.device
        with open(os.path.join(task_dir, 'task_signature.json')) as f:
            self.signature = json.load(f)
        with open(os.path.join(task_dir, 'mega_ag.json')) as f:
            self.param_json = json.load(f)['parameter']
        self.params = params_from_task_json(self.param_json, word_bits)
        self._qp_ring = get_rns_ring(tuple(self.params.q) + tuple(self.params.p),
                                     self.params.n, self.device, word_bits)
        cls = BfvContext if isinstance(self.params, BfvParams) else CkksContext
        self._ctx = cls.create_empty_context(self.params, device=self.device)
        self.timing: dict = {}     # the last run's import / run / export seconds

    # ---- signature checks (the reference plug-in's error strings) ---------
    def _check_with_sig(self, arg: ForeignVectorArgument, row: dict):
        if arg.arg_id != row['id']:
            raise RuntimeError(
                f'For argument {arg.arg_id}, expected id is {row["id"]}, '
                f'but input id is {arg.arg_id}.')
        if row['type'] not in _COMPATIBLE[arg.type]:
            raise RuntimeError(
                f'For argument {arg.arg_id}, expected type is {row["type"]}, '
                f'but input type is {arg.type}.')
        expected_size = 1
        for x in row['size']:
            expected_size *= x
        if len(arg.flat) != expected_size:
            raise RuntimeError(
                f'For argument {arg.arg_id}, expected size is {expected_size}, '
                f'but input size is {len(arg.flat)}.')
        if arg.level != row['level']:
            raise RuntimeError(
                f'For argument {arg.arg_id}, expected level is {row["level"]}, '
                f'but input level is {arg.level}.')

    def _key_level(self, ksk) -> int:
        return ksk.public_keys[0].polys[0].n_component - len(self.params.p) - 1

    def _check_key_signatures(self, rlk, glk):
        key_sig = self.signature.get('key', {})
        rlk_level_sig = key_sig.get('rlk', -1)
        if rlk_level_sig >= 0 and (rlk is None or rlk_level_sig > self._key_level(rlk)):
            raise RuntimeError('Level of relin key is smaller than the expected level.')
        glk_sig = key_sig.get('glk', {})
        if glk_sig:
            present = {}
            if glk is not None:
                for i in range(glk.n_key_switch_key):
                    present[int(glk.galois_elements[i])] = self._key_level(
                        glk.key_switch_keys[i])
            for elt_str, lvl in glk_sig.items():
                elt = int(elt_str)
                if elt not in present or lvl > present[elt]:
                    raise RuntimeError('Level of Galois key is smaller than the expected '
                                       'level.')

    # ---- run ---------------------------------------------------------------
    def run(self, rlk=None, glk=None, args=(), mf_nbits: int = 0):
        """args: ForeignVectorArgument list, positional per the signature's
        input rows. → ({output_id: CCiphertext _Exported (a list for a
        vector output)}, ns); ``timing`` then holds the import, run and
        export seconds."""
        # reference semantics (plug-in/SEAL/acc/check_sig.h:209-211 and
        # cxx_sdk_v2/check_sig.h:244-246): a non-empty offline signature
        # replaces the online one for argument checking
        offline = self.signature.get('offline', [])
        rows = offline if offline else self.signature['online']
        in_rows = [r for r in rows if r['phase'] in ('in', 'offline')]
        if len(args) != len(in_rows):
            raise RuntimeError(f'expected {len(in_rows)} arguments, '
                               f'got {len(args)}.')
        for arg, row in zip(args, in_rows):
            self._check_with_sig(arg, row)
        self._check_key_signatures(rlk, glk)

        t0 = time.perf_counter()
        ctx = self._import_context(rlk, glk, mf_nbits)
        input_values = {}
        is_ckks = self.signature.get('algorithm') == 'CKKS'
        for arg, row in zip(args, in_rows):
            vals = [self._import_one(s, arg.type, is_ckks) for s in arg.flat]
            input_values[row['id']] = self._reshape(vals, row['size'])
        t1 = time.perf_counter()
        outputs, ns = self.task.run(ctx, input_values)
        t2 = time.perf_counter()
        exported = {}
        for oid, val in outputs.items():
            exp = [abi.export_ciphertext(v) for v in _flatten(val)]
            exported[oid] = exp[0] if len(exp) == 1 else exp
        self.timing = {'import_s': t1 - t0, 'run_s': t2 - t1,
                       'export_s': time.perf_counter() - t2}
        return exported, ns

    # ---- helpers -----------------------------------------------------------
    def _install(self, old, new: KeySwitchKey) -> KeySwitchKey:
        """``new``'s values in ``old``'s tensors when the shapes agree (a
        captured graph reads the keys in place), else ``new``."""
        if old is not None and old.key_q.shape == new.key_q.shape \
                and old.key_p.shape == new.key_p.shape:
            old.key_q.copy_(new.key_q)
            old.key_p.copy_(new.key_p)
            return old
        return new

    def _import_context(self, rlk, glk, mf_nbits):
        ctx = self._ctx
        level = self.params.max_level
        sp_level = len(self.params.p) - 1
        if rlk is not None:
            ctx.rlk = self._install(ctx.rlk, abi.import_keyswitch_key(
                rlk, level, sp_level, mf_nbits, self._qp_ring))
        if glk is not None:
            keys = abi.import_galois_keys(glk, level, sp_level, mf_nbits, self._qp_ring)
            ctx.glk = GaloisKeys({e: self._install(ctx.glk.keys.get(e), k)
                                  for e, k in keys.items()})
        return ctx

    def _import_one(self, struct, kind, is_ckks):
        scale = float(self.param_json.get('scale', 1.0))
        if kind == 'ct':
            return abi.import_ciphertext(struct, is_ntt=is_ckks, scale=scale,
                                         device=self.device)
        return abi.import_plaintext(struct, is_ntt=is_ckks, scale=scale, device=self.device)

    @staticmethod
    def _reshape(vals, size):
        if size == [1]:
            return vals[0]
        out = vals
        for dim in reversed(size[1:]):
            out = [out[i:i + dim] for i in range(0, len(out), dim)]
        return out
