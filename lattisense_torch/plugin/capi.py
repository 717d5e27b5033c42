"""Python side of the C ABI plug-in boundary (``csrc/plugin/lattisense_plugin.cpp``).

Port of ``lattisense_tpu/plugin/capi.py``. The embedded-CPython shim
forwards raw struct pointers (uintptr_t) from a foreign binary; this module
casts them with ctypes against the ``abi.py`` layout (= abi/c_types.h), runs
the compiled task through ``ForeignTask`` (the reference plug-in's run
contract, its signature-error strings included) and exports the outputs as
fresh C structs, kept alive in a per-task registry until ``release_task``.

Keys arrive as TYPE_RELIN_KEY / TYPE_GALOIS_KEY arguments after the data
arguments (the reference's marshaling order, cxx_sdk_v2/cxx_argument.h:178-256).

``LATTISENSE_PLUGIN_PLATFORM`` picks the device of the tasks a foreign
process creates: ``cpu`` runs them on the CPU; unset (or ``cuda``) on the
card, which must be present.
"""

import ctypes
import os

from .. import abi
from .foreign_task import ForeignTask, ForeignVectorArgument

# c_argument.h DataType values
TYPE_PLAINTEXT = 0
TYPE_CIPHERTEXT = 1
TYPE_RELIN_KEY = 2
TYPE_GALOIS_KEY = 3
TYPE_SWITCH_KEY = 4
TYPE_CUSTOM = 5

_STRUCT_OF_TYPE = {
    TYPE_PLAINTEXT: abi.CPlaintext,
    TYPE_CIPHERTEXT: abi.CCiphertext,
    TYPE_RELIN_KEY: abi.CKeySwitchKey,
    TYPE_GALOIS_KEY: abi.CGaloisKey,
    TYPE_SWITCH_KEY: abi.CKeySwitchKey,
}

_REGISTRY: dict = {}
_NEXT_ID = [0]


def plugin_device():
    """The device named by ``LATTISENSE_PLUGIN_PLATFORM`` (None: the card)."""
    platform = os.environ.get('LATTISENSE_PLUGIN_PLATFORM', '').strip().lower()
    if platform in ('', 'cuda', 'gpu'):
        return None
    if platform == 'cpu':
        return 'cpu'
    raise ValueError(f'LATTISENSE_PLUGIN_PLATFORM must be cpu or cuda, got {platform!r}')


def create_task(task_dir: str) -> int:
    task = ForeignTask(task_dir, mode='jit', device=plugin_device())
    tid = _NEXT_ID[0]
    _NEXT_ID[0] += 1
    _REGISTRY[tid] = {'task': task, 'keep': []}
    return tid


def release_task(tid: int) -> int:
    _REGISTRY.pop(tid, None)
    return 0


def _cast(addr: int, typ):
    return ctypes.cast(addr, ctypes.POINTER(typ)).contents


def run_task(tid: int, in_rows, out_ids, mf_nbits: int):
    """in_rows: [(id, type_enum, [elem_addr...], level)], out_ids: [str].
    Returns [(elem_ptr_array_addr, size, level)] per output id; the element
    structs and pointer arrays live in the registry."""
    ent = _REGISTRY[tid]
    rlk = glk = None
    args = []
    for arg_id, typ, addrs, _level in in_rows:
        if typ == TYPE_RELIN_KEY:
            rlk = _cast(addrs[0], abi.CKeySwitchKey)
        elif typ == TYPE_GALOIS_KEY:
            glk = _cast(addrs[0], abi.CGaloisKey)
        elif typ in (TYPE_CIPHERTEXT, TYPE_PLAINTEXT):
            args.append(ForeignVectorArgument(arg_id, [_cast(a, _STRUCT_OF_TYPE[typ])
                                                       for a in addrs]))
        else:
            raise RuntimeError(f'unsupported argument type {typ}')

    outputs, _ns = ent['task'].run(rlk=rlk, glk=glk, args=args, mf_nbits=mf_nbits)

    rows = []
    for oid in out_ids:
        val = outputs[oid]
        exported = val if isinstance(val, list) else [val]
        ptrs = (ctypes.c_void_p * len(exported))()
        for k, e in enumerate(exported):
            ent['keep'].append(e)               # owns the buffers and the struct
            ptrs[k] = ctypes.cast(ctypes.byref(e.struct), ctypes.c_void_p)
        ent['keep'].append(ptrs)
        rows.append((ctypes.addressof(ptrs), len(exported), int(exported[0].struct.level)))
    return rows
