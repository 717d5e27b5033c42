"""Erg (Encrypted pRocess Graph) frontend: graph eDSL + task serializer.

The port's own copy of ``lattisense_tpu/frontend/custom_task.py``, which the
port does not import. API- and file-format-compatible with the reference
frontend (frontend/custom_task.py): user scripts build a DAG of typed
data/compute nodes and `process_custom_task` emits `mega_ag.json` +
`task_signature.json` with the same schema, so reference task-generation
scripts run unchanged; for the same graph and the same ``random.seed`` both
packages write the same bytes. The port's runtime (``runtime/task.py``)
runs the graphs on the card.

The bootstrap profiles and their rotation math are the port's
``schemes/bootstrap_params.py`` (one copy: the bootstrapper splits its
transforms with the same ``find_best_bsgs_split``).

Implementation is original (ordered-DAG in frontend/graph.py, no networkx);
only the public surface and JSON contract mirror the reference.
"""

import json
import math
import os
import random
import string
from enum import Enum
from typing import List, Optional

from ..schemes.bootstrap_params import (BTP_P, BTP_Q, EncodingMatrixParams, EvalModParams,
                                        LinearTransformType, SineType, _profile,
                                        bootstrap_rotations)
from .graph import Digraph

DEFAULT_LEVEL = -1
GALOIS_GEN = 5
SEAL_GALOIS_GEN = 3

_TABLE_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           'parameter.json')


class Algo(Enum):
    BFV = 'BFV'
    CKKS = 'CKKS'


class DataType(Enum):
    Plaintext = 'pt'
    PlaintextRingt = 'pt_ringt'
    PlaintextMul = 'pt_mul'
    Ciphertext = 'ct'
    Ciphertext3 = 'ct3'
    SwitchKey = 'swk'
    RelinKey = 'rlk'
    GaloisKey = 'glk'


class OperationType(Enum):
    Add = 'add'
    Sub = 'sub'
    Neg = 'neg'
    Mult = 'mult'
    Relin = 'relin'
    Rescale = 'rescale'
    DropLevel = 'drop_level'
    RnsSpDecomp = 'rns_sp_decomp'
    RotateCol = 'rotate_col'
    RotateRow = 'rotate_row'
    ToNtt = 'to_ntt'
    ToMForm = 'to_mf'
    ToMul = 'to_mul'
    ToInvNtt = 'to_inv_ntt'
    CmpacSum = 'cmpac_sum'
    CmpSum = 'cmp_sum'
    Bootstrap = 'bootstrap'
    FpgaKernel = 'fpga_kernel'


class Lib(Enum):
    Lattigo = 'lattigo'
    SEAL = 'seal'


# ---------------------------------------------------------------------------
# Global graph state (cleared by process_custom_task)
# ---------------------------------------------------------------------------

g_dag = Digraph()
g_swk_node_dict: dict = {}
g_param = None
_data_node_count = 0
_compute_node_count = 0
_used_random_ids: set = set()


def _next_data_index() -> int:
    global _data_node_count
    _data_node_count += 1
    return _data_node_count - 1


def _next_compute_index() -> int:
    global _compute_node_count
    _compute_node_count += 1
    return _compute_node_count - 1


def random_id() -> str:
    while True:
        rid = ''.join(random.choices(string.ascii_lowercase, k=12))
        if rid not in _used_random_ids:
            _used_random_ids.add(rid)
            return rid


# ---------------------------------------------------------------------------
# Galois helpers
# ---------------------------------------------------------------------------

def naf_decompose(x: int):
    """Signed-binary (NAF) decomposition: x = Σ 2^i (i∈pos) − Σ 2^i (i∈neg),
    exponents descending (matches reference get_glk_col ordering)."""
    pos, neg = [], []
    i = 0
    while x != 0:
        if x & 1:
            if (x & 3) == 1:
                pos.append(i)
                x -= 1
            else:
                neg.append(i)
                x += 1
        x >>= 1
        i += 1
    return sorted(pos, reverse=True), sorted(neg, reverse=True)


def get_glk_col(steps: int, poly_degree: int):
    """NAF split of a column rotation into power-of-two sub-rotations."""
    mask = (poly_degree >> 1) - 1
    pos, neg = naf_decompose(steps)
    pos = [i for i in pos if (2 ** i & mask) != 0]
    return pos, neg


def get_galois_element_for_column_rotation_by(rot: int, poly_degree: int,
                                              galois_gen: int = GALOIS_GEN) -> int:
    mask = (poly_degree << 1) - 1
    return pow(galois_gen, rot & mask, poly_degree << 1)


def get_galois_element_for_row_rotation(poly_degree: int) -> int:
    return (poly_degree << 1) - 1


# ---------------------------------------------------------------------------
# Parameters (frontend view)
# ---------------------------------------------------------------------------

class Param:
    def __init__(self, algo: Algo, n: int = 8192):
        self.algo = algo
        self.n = n
        self.p: list = []
        self.q: list = []
        self.max_level = -1

    def get_max_sp_level(self) -> int:
        return len(self.p) - 1

    def _table_entry(self) -> dict:
        with open(_TABLE_PATH) as f:
            table = json.load(f)
        if self.algo.value not in table:
            raise ValueError(f'Unsupported algorithm type: {self.algo.value}')
        entries = table[self.algo.value]
        if str(self.n) not in entries:
            raise ValueError(f'Unsupported n value for algorithm {self.algo.value}: {self.n}')
        return entries[str(self.n)]

    # Convenience factories used by examples/docs
    @staticmethod
    def create_bfv_default_param(n: int) -> 'BfvParam':
        return BfvParam.create_default_param(n)

    @staticmethod
    def create_ckks_default_param(n: int) -> 'CkksParam':
        return CkksParam.create_default_param(n)


class BfvParam(Param):
    def __init__(self, n: int = 8192):
        super().__init__(Algo.BFV, n)
        self.t = -1

    @classmethod
    def create_default_param(cls, n: int) -> 'BfvParam':
        inst = cls(n)
        e = inst._table_entry()
        inst.q, inst.p, inst.t = list(e['q']), list(e['p']), e['t']
        inst.max_level = e['max_level']
        return inst

    @classmethod
    def create_custom_param(cls, n: int, q: List[int], p: List[int], t: int) -> 'BfvParam':
        inst = cls(n)
        inst.q, inst.p, inst.t = list(q), list(p), t
        inst.max_level = len(q) - 1
        return inst

    @classmethod
    def create_fpga_param(cls, t: int = 0x1B4001) -> 'BfvParam':
        inst = cls(8192)
        inst.q = [0x7F4E0001, 0x7FB40001, 0x7FD20001, 0x7FEA0001, 0x7FF80001, 0x7FFE0001]
        inst.p = [0xFF5A0001]
        inst.t = t
        inst.max_level = len(inst.q) - 1
        return inst


class CkksParam(Param):
    def __init__(self, n: int = 8192, slots: int = 0, scale: float = 0.0):
        super().__init__(Algo.CKKS, n)
        if slots == 0:
            self.slots = n // 2
        else:
            self._validate_slots(slots)
            self.slots = slots
        self.scale = scale

    def _validate_slots(self, slots: int):
        if slots % 2 != 0:
            raise ValueError(f'slots must be a multiple of 2, got {slots}')
        if slots <= 0 or slots > self.n // 2:
            raise ValueError(f'slots must be in range (0, {self.n // 2}], got {slots}')

    def set_slots(self, slots: int):
        self._validate_slots(slots)
        self.slots = slots

    def set_scale(self, scale: float):
        self.scale = scale

    @classmethod
    def create_default_param(cls, n: int) -> 'CkksParam':
        inst = cls(n)
        e = inst._table_entry()
        inst.q, inst.p = list(e['q']), list(e['p'])
        inst.max_level = e['max_level']
        inst.slots = e['slots']
        inst.scale = e['scale']
        return inst

    @classmethod
    def create_custom_param(cls, n: int, q: List[int], p: List[int],
                            slots: int = 0, scale: float = 0.0) -> 'CkksParam':
        inst = cls(n, slots, scale)
        inst.q, inst.p = list(q), list(p)
        inst.max_level = len(q) - 1
        return inst

    @classmethod
    def create_fpga_param(cls) -> 'CkksParam':
        inst = cls(8192)
        inst.q = [0x7F4E0001, 0x7FB40001, 0x7FD20001, 0x7FEA0001, 0x7FF80001, 0x7FFE0001]
        inst.p = [0xFF5A0001]
        inst.max_level = len(inst.q) - 1
        inst.scale = 1 << 31
        return inst


class CkksBtpParam(CkksParam):
    """CKKS bootstrap parameters (toy n=8192 and full n=2^16 profiles)."""

    def __init__(self, n: int = 1 << 16):
        super().__init__(n)
        self.cts_params: EncodingMatrixParams | None = None
        self.stc_params: EncodingMatrixParams | None = None
        self.eval_mod_params: EvalModParams | None = None
        self.btp_output_level = -1

    @classmethod
    def _build(cls, n: int) -> 'CkksBtpParam':
        prof = _profile(n)          # the standard chain (schemes/bootstrap_params.py)
        inst = cls(n)
        inst.q = list(BTP_Q)
        inst.p = list(BTP_P)
        inst.max_level = len(inst.q) - 1
        inst.scale = 1 << 40
        inst.stc_params = prof.stc_params
        inst.eval_mod_params = prof.eval_mod_params
        inst.cts_params = prof.cts_params
        inst.btp_output_level = prof.btp_output_level
        return inst

    @classmethod
    def create_custom_param(cls, n: int, q: List[int], p: List[int],
                            slots: int = 0, scale: float = 0.0,
                            cts_depth: int = 3, stc_depth: int = 3,
                            eval_mod_k: int = 16, sine_deg: int = 30,
                            double_angle: int = 3,
                            btp_output_level: int = -1) -> 'CkksBtpParam':
        """Bootstrap parameters over a caller-supplied chain (toy/test
        configs beyond the canonical table profiles)."""
        inst = cls(n)
        inst.q = [int(x) for x in q]
        inst.p = [int(x) for x in p]
        inst.max_level = len(inst.q) - 1
        if slots:
            inst.set_slots(slots)
        inst.scale = float(scale) if scale else float(q[-1])
        inst.cts_params = EncodingMatrixParams(
            linear_transform_type=LinearTransformType.CoeffsToSlots,
            repack_imag_2_real=True, level_start=inst.max_level,
            bsgs_ratio=2.0, bit_reversed=False,
            scaling_factor=[[1]] * cts_depth)
        inst.stc_params = EncodingMatrixParams(
            linear_transform_type=LinearTransformType.SlotsToCoeffs,
            repack_imag_2_real=True, level_start=stc_depth,
            bsgs_ratio=2.0, bit_reversed=False,
            scaling_factor=[[1]] * stc_depth)
        inst.eval_mod_params = EvalModParams(
            q=inst.q[0], level_start=inst.max_level - cts_depth - 1,
            sine_type=SineType.Cos1, message_ratio=inst.q[0] / inst.scale,
            k=eval_mod_k, sine_deg=sine_deg, double_angle=double_angle,
            arcsine_deg=0, scaling_factor=float(q[1]))
        inst.btp_output_level = btp_output_level
        return inst

    @classmethod
    def create_toy_param(cls) -> 'CkksBtpParam':
        return cls._build(8192)

    @classmethod
    def create_default_param(cls) -> 'CkksBtpParam':
        return cls._build(1 << 16)

    def rotations_for_bootstrapping(self) -> list[int]:
        return bootstrap_rotations(self.n, self.slots, self.cts_params, self.stc_params)


def set_fhe_param(param: Param) -> None:
    """Set the global FHE parameters (must precede any graph construction)."""
    global g_param
    g_param = param


# ---------------------------------------------------------------------------
# Data nodes
# ---------------------------------------------------------------------------

class DataNode:
    def __init__(self, type, id='') -> None:
        self.type = type
        self.id = id if id else random_id()
        self.index = _next_data_index()

    def __repr__(self):
        return self.id


class FheDataNode(DataNode):
    def __init__(self, type: DataType, id='', degree=-1, level=DEFAULT_LEVEL) -> None:
        super().__init__(type=type, id=id)
        self.level = level
        self.degree = degree
        self.is_ntt = False
        self.is_mform = False
        self.sp_level: int | None = None

    def to_json_dict(self) -> dict:
        d = {
            'id': self.id,
            'type': self.type.value,
            'level': self.level,
            'degree': self.degree,
            'is_ntt': self.is_ntt,
            'is_mform': self.is_mform,
        }
        if self.sp_level is not None:
            d['sp_level'] = self.sp_level
        if isinstance(self, BfvCompressedPlaintextRingtNode):
            d['is_compressed'] = self.is_compressed
        if isinstance(self, CiphertextNode):
            d['poly1_rns_sp_decomped'] = self.poly1_rns_sp_decomped
        if isinstance(self, GaloisKeyNode):
            d['galois_element'] = self.galois_element
        return d


class CustomDataNode(DataNode):
    def __init__(self, type: str, id='', attributes: dict | None = None) -> None:
        super().__init__(type=type, id=id)
        self.attributes = attributes or {}

    def __repr__(self):
        return f'(custom_{self.type}, {self.id})'

    def to_json_dict(self) -> dict:
        d = {'id': self.id, 'type': self.type, 'is_custom': True}
        if self.attributes:
            d['attributes'] = self.attributes
        return d


class PlaintextNode(FheDataNode):
    def __init__(self, type, id='', level=DEFAULT_LEVEL) -> None:
        super().__init__(type, id, 0, level)


class BfvPlaintextNode(PlaintextNode):
    def __init__(self, id='', level=DEFAULT_LEVEL) -> None:
        super().__init__(DataType.Plaintext, id, level)


class BfvPlaintextRingtNode(PlaintextNode):
    def __init__(self, id='') -> None:
        super().__init__(DataType.PlaintextRingt, id, 0)


class BfvCompressedPlaintextRingtNode(BfvPlaintextRingtNode):
    def __init__(self, id='', compressed_block_info: list | None = None) -> None:
        super().__init__(id)
        assert compressed_block_info is not None
        self.compressed_block_info = compressed_block_info
        self.is_compressed = True


class BfvPlaintextMulNode(PlaintextNode):
    def __init__(self, id='', level=DEFAULT_LEVEL) -> None:
        super().__init__(DataType.PlaintextMul, id, level)
        self.is_ntt = True
        self.is_mform = True


class CkksPlaintextNode(PlaintextNode):
    def __init__(self, id='', level=DEFAULT_LEVEL) -> None:
        super().__init__(DataType.Plaintext, id, level)
        self.is_ntt = True


class CkksPlaintextRingtNode(PlaintextNode):
    def __init__(self, id='') -> None:
        super().__init__(DataType.PlaintextRingt, id, 0)


class CkksPlaintextMulNode(PlaintextNode):
    def __init__(self, id='', level=DEFAULT_LEVEL) -> None:
        super().__init__(DataType.PlaintextMul, id, level)
        self.is_ntt = True
        self.is_mform = True


class CiphertextNode(FheDataNode):
    def __init__(self, type=DataType.Ciphertext, id='', degree=1, level=DEFAULT_LEVEL) -> None:
        super().__init__(type, id, degree, level)
        self.poly1_rns_sp_decomped = False


class BfvCiphertextNode(CiphertextNode):
    def __init__(self, id='', level=DEFAULT_LEVEL) -> None:
        super().__init__(DataType.Ciphertext, id, 1, level)


class BfvCiphertext3Node(CiphertextNode):
    def __init__(self, id='', level=DEFAULT_LEVEL) -> None:
        super().__init__(DataType.Ciphertext3, id, 2, level)


class CkksCiphertextNode(CiphertextNode):
    def __init__(self, id='', level=DEFAULT_LEVEL) -> None:
        super().__init__(DataType.Ciphertext, id, 1, level)
        self.is_ntt = True


class CkksCiphertext3Node(CiphertextNode):
    def __init__(self, id='', level=DEFAULT_LEVEL) -> None:
        super().__init__(DataType.Ciphertext3, id, 2, level)
        self.is_ntt = True


class SwitchKeyNode(FheDataNode):
    def __init__(self, id='', level=DEFAULT_LEVEL, sp_level=DEFAULT_LEVEL,
                 type=DataType.SwitchKey) -> None:
        super().__init__(type=type, id=id, degree=1, level=level)
        self.is_ntt = True
        self.is_mform = True
        self.sp_level = sp_level


class RelinKeyNode(SwitchKeyNode):
    def __init__(self, level=DEFAULT_LEVEL) -> None:
        assert g_param is not None
        super().__init__(id='rlk_ntt', level=level,
                         sp_level=g_param.get_max_sp_level(), type=DataType.RelinKey)


class GaloisKeyNode(SwitchKeyNode):
    def __init__(self, id, level=DEFAULT_LEVEL) -> None:
        assert g_param is not None
        super().__init__(id=id, level=level,
                         sp_level=g_param.get_max_sp_level(), type=DataType.GaloisKey)
        self.galois_element = (int(self.id.split('_')[-1]) if 'col' in self.id
                               else get_galois_element_for_row_rotation(g_param.n))


# ---------------------------------------------------------------------------
# Compute nodes
# ---------------------------------------------------------------------------

class ComputeNode:
    def __init__(self, type) -> None:
        self.type = type
        self.id = random_id()
        self.index = _next_compute_index()

    def __repr__(self):
        return f'({self.type}, {self.id})'


class FheComputeNode(ComputeNode):
    def __init__(self, type: OperationType) -> None:
        super().__init__(type=type)
        self.compressed_block_info: list | None = None

    def __repr__(self):
        return f'({self.type.value}, {self.id})'

    def to_json_dict(self, dag: Digraph) -> dict:
        d = {
            'id': self.id,
            'type': self.type.value,
            'inputs': [p.index for p in dag.predecessors(self)],
            'outputs': [s.index for s in dag.successors(self)],
        }
        if isinstance(self, RotateColUnitNode):
            d['step'] = self.step
            if self.lib != Lib.Lattigo:
                d['lib'] = self.lib.value
        elif isinstance(self, RotateRowUnitNode):
            if self.lib != Lib.Lattigo:
                d['lib'] = self.lib.value
        elif isinstance(self, (CmpSumComputeNode, CmpacSumComputeNode)):
            d['sum_cnt'] = self.sum_cnt
            d['pt_type'] = self.pt_type.value if isinstance(self.pt_type, DataType) else self.pt_type
        if self.compressed_block_info is not None:
            d['compressed_block_info'] = self.compressed_block_info
        return d


class CustomComputeNode(ComputeNode):
    def __init__(self, type: str, attributes: dict | None = None) -> None:
        super().__init__(type=type)
        self.attributes = attributes or {}

    def __repr__(self):
        return f'(custom_{self.type}, {self.id})'

    def to_json_dict(self, dag: Digraph) -> dict:
        d = {
            'id': self.id,
            'type': self.type,
            'is_custom': True,
            'inputs': [p.index for p in dag.predecessors(self)],
            'outputs': [s.index for s in dag.successors(self)],
        }
        if self.attributes:
            d['attributes'] = self.attributes
        return d


class CmpSumComputeNode(FheComputeNode):
    def __init__(self, sum_cnt) -> None:
        super().__init__(type=OperationType.CmpSum)
        self.sum_cnt = sum_cnt
        self.pt_type: DataType | str = ''


class CmpacSumComputeNode(FheComputeNode):
    def __init__(self, sum_cnt) -> None:
        super().__init__(type=OperationType.CmpacSum)
        self.sum_cnt = sum_cnt
        self.pt_type: DataType | str = ''


class RotateColUnitNode(FheComputeNode):
    def __init__(self, step: int, lib=Lib.Lattigo) -> None:
        super().__init__(type=OperationType.RotateCol)
        self.step = step
        self.lib = lib


class RotateRowUnitNode(FheComputeNode):
    def __init__(self, lib=Lib.Lattigo) -> None:
        super().__init__(type=OperationType.RotateRow)
        self.lib = lib


class FpgaKernelNode(FheComputeNode):
    def __init__(self) -> None:
        super().__init__(type=OperationType.FpgaKernel)


# ---------------------------------------------------------------------------
# eDSL op builders
# ---------------------------------------------------------------------------

_BFV_OPERAND = (BfvCiphertextNode, BfvPlaintextNode, BfvPlaintextRingtNode, BfvPlaintextMulNode)
_CKKS_OPERAND = (CkksCiphertextNode, CkksPlaintextNode, CkksPlaintextRingtNode, CkksPlaintextMulNode)


def _burn_data_index():
    """Keep data-node index layout identical to the reference, which
    allocates a placeholder CiphertextNode before each typed output node —
    so generated mega_ag.json files diff clean against reference output."""
    _next_data_index()


def _new_ct_like(x, output_id: Optional[str], level: int):
    _burn_data_index()
    if isinstance(x, _BFV_OPERAND):
        return BfvCiphertextNode(id=output_id if output_id is not None else random_id(), level=level)
    if isinstance(x, _CKKS_OPERAND):
        return CkksCiphertextNode(id=output_id if output_id is not None else random_id(), level=level)
    raise ValueError()


def add(x, y, output_id: Optional[str] = None):
    """ct+ct, ct+pt, pt+ct addition (ciphertext-first edge order)."""
    ringt = (BfvPlaintextRingtNode, CkksPlaintextRingtNode)
    if not isinstance(x, ringt) and not isinstance(y, ringt):
        assert x.level == y.level and x.is_ntt == y.is_ntt

    op = FheComputeNode(OperationType.Add)
    pts = [DataType.Plaintext, DataType.PlaintextRingt]
    if x.type == DataType.Ciphertext and y.type == DataType.Ciphertext:
        g_dag.add_edges_from([(x, op)] if x.id == y.id else [(x, op), (y, op)])
    elif x.type == DataType.Ciphertext and y.type in pts:
        g_dag.add_edges_from([(x, op), (y, op)])
    elif x.type in pts and y.type == DataType.Ciphertext:
        g_dag.add_edges_from([(y, op), (x, op)])
    else:
        raise ValueError(f'Unsupported input types "{x.type.value}" and "{y.type.value}" for addition.')

    z = _new_ct_like(x, output_id, x.level)
    z.is_ntt = x.is_ntt
    g_dag.add_edge(op, z)
    return z


def sub(x, y, output_id: Optional[str] = None):
    """ct-ct, ct-pt subtraction."""
    if not isinstance(y, (BfvPlaintextRingtNode, CkksPlaintextRingtNode)):
        assert x.level == y.level and x.is_ntt == y.is_ntt
    if x.type != DataType.Ciphertext or y.type not in (
            DataType.Ciphertext, DataType.Plaintext, DataType.PlaintextRingt):
        raise ValueError(f'Unsupported input types "{x.type.value}" and "{y.type.value}" for addition.')
    op = FheComputeNode(OperationType.Sub)
    g_dag.add_edges_from([(x, op), (y, op)])
    z = _new_ct_like(x, output_id, x.level)
    z.is_ntt = x.is_ntt
    g_dag.add_edge(op, z)
    return z


def neg(x, output_id: Optional[str] = None):
    op = FheComputeNode(OperationType.Neg)
    g_dag.add_edges_from([(x, op)])
    z = _new_ct_like(x, output_id, x.level)
    z.is_ntt = x.is_ntt
    g_dag.add_edge(op, z)
    return z


def to_mul(x: BfvCiphertextNode, output_id: Optional[str] = None) -> BfvCiphertextNode:
    assert x.level >= 0 and not x.is_ntt and not x.is_mform
    op = FheComputeNode(OperationType.ToMul)
    g_dag.add_edges_from([(x, op)])
    z = BfvCiphertextNode(id=output_id if output_id is not None else random_id(), level=x.level)
    z.is_ntt = True
    z.is_mform = True
    g_dag.add_edge(op, z)
    return z


def to_ntt(x: BfvCiphertextNode, output_id: Optional[str] = None) -> BfvCiphertextNode:
    assert x.level >= 0 and not x.is_ntt
    op = FheComputeNode(OperationType.ToNtt)
    g_dag.add_edges_from([(x, op)])
    z = BfvCiphertextNode(id=output_id if output_id is not None else random_id(), level=x.level)
    z.is_ntt = True
    g_dag.add_edge(op, z)
    return z


def to_mform(x: BfvCiphertextNode, output_id: Optional[str] = None) -> BfvCiphertextNode:
    assert x.level >= 0 and not x.is_mform
    op = FheComputeNode(OperationType.ToMForm)
    g_dag.add_edges_from([(x, op)])
    z = BfvCiphertextNode(id=output_id if output_id is not None else random_id(), level=x.level)
    z.is_ntt = x.is_ntt
    z.is_mform = True
    g_dag.add_edge(op, z)
    return z


def to_inv_ntt(x: BfvCiphertextNode, output_id: Optional[str] = None) -> BfvCiphertextNode:
    assert x.level >= 0 and x.is_ntt
    op = FheComputeNode(OperationType.ToInvNtt)
    g_dag.add_edges_from([(x, op)])
    z = BfvCiphertextNode(id=output_id if output_id is not None else random_id(), level=x.level)
    g_dag.add_edge(op, z)
    return z


def mult(x, y, output_id: Optional[str] = None, start_block_idx: int | None = None):
    """ct*ct (→ ct3), ct*pt / pt*ct (any plaintext format)."""
    op = FheComputeNode(OperationType.Mult)
    pts = [DataType.Plaintext, DataType.PlaintextRingt, DataType.PlaintextMul]

    if x.type == DataType.Ciphertext and y.type == DataType.Ciphertext:
        assert x.level == y.level
        assert x.degree == y.degree == 1
        assert x.is_ntt == y.is_ntt
        z_degree, z_ntt = 2, x.is_ntt
        g_dag.add_edges_from([(x, op)] if x.id == y.id else [(x, op), (y, op)])
    elif x.type == DataType.Ciphertext and y.type in pts:
        assert x.level == y.level or y.level == 0
        assert x.degree == 1
        z_degree, z_ntt = 1, x.is_ntt
        g_dag.add_edges_from([(x, op), (y, op)])
        if isinstance(y, BfvCompressedPlaintextRingtNode):
            assert start_block_idx is not None
            op.compressed_block_info = [y.compressed_block_info[start_block_idx]]
    elif x.type in pts and y.type == DataType.Ciphertext:
        assert x.level == y.level or x.level == 0
        assert y.degree == 1
        z_degree, z_ntt = 1, y.is_ntt
        g_dag.add_edges_from([(y, op), (x, op)])
        if isinstance(x, BfvCompressedPlaintextRingtNode):
            assert start_block_idx is not None
            op.compressed_block_info = [x.compressed_block_info[start_block_idx]]
    else:
        raise ValueError(f'Unsupported input types "{x.type.value}" and "{y.type.value}" for multiplication.')

    _burn_data_index()
    oid = output_id if output_id is not None else random_id()
    if isinstance(x, _BFV_OPERAND):
        z = BfvCiphertextNode(id=oid, level=x.level) if z_degree == 1 else \
            BfvCiphertext3Node(id=oid, level=x.level)
    elif isinstance(x, _CKKS_OPERAND):
        z = CkksCiphertextNode(id=oid, level=x.level) if z_degree == 1 else \
            CkksCiphertext3Node(id=oid, level=x.level)
    else:
        raise ValueError()
    z.is_ntt = z_ntt
    g_dag.add_edge(op, z)
    return z


def relin(x, output_id: Optional[str] = None):
    if x.type != DataType.Ciphertext3:
        raise ValueError(f'Unsupported input type "{x.type.value}" for relinerization.')
    if 'rlk_ntt' not in g_swk_node_dict:
        g_swk_node_dict['rlk_ntt'] = RelinKeyNode(level=x.level)
    elif x.level > g_swk_node_dict['rlk_ntt'].level:
        g_swk_node_dict['rlk_ntt'].level = x.level
    op = FheComputeNode(OperationType.Relin)
    g_dag.add_edges_from([(x, op), (g_swk_node_dict['rlk_ntt'], op)])

    _burn_data_index()
    oid = output_id if output_id is not None else random_id()
    if isinstance(x, BfvCiphertext3Node):
        z = BfvCiphertextNode(id=oid, level=x.level)
    elif isinstance(x, CkksCiphertext3Node):
        z = CkksCiphertextNode(id=oid, level=x.level)
    else:
        raise ValueError()
    z.is_ntt = x.is_ntt
    g_dag.add_edge(op, z)
    return z


def mult_relin(x, y, output_id=None):
    ct3 = mult(x, y, f'{output_id}_ct3' if output_id is not None else None)
    assert isinstance(ct3, (BfvCiphertext3Node, CkksCiphertext3Node))
    return relin(ct3, output_id)


def rescale(x, output_id: Optional[str] = None):
    if x.type != DataType.Ciphertext:
        raise ValueError(f'Unsupported input type "{x.type.value}" for rescale.')
    op = FheComputeNode(OperationType.Rescale)
    g_dag.add_edges_from([(x, op)])
    z = _new_ct_like(x, output_id, x.level - 1)
    z.is_ntt = x.is_ntt
    g_dag.add_edge(op, z)
    return z


def drop_level(x: CkksCiphertextNode, drop_level: int = 1, output_id: Optional[str] = None):
    if x.type != DataType.Ciphertext:
        raise ValueError(f'Unsupported input type "{x.type.value}" for drop level.')
    if x.level < drop_level:
        raise ValueError('Dropped levels must not be larger than input level.')
    cur = x
    z = None
    for lv in range(drop_level):
        op = FheComputeNode(OperationType.DropLevel)
        g_dag.add_edge(cur, op)
        last = lv == drop_level - 1
        z = CkksCiphertextNode(id=output_id if (last and output_id is not None) else random_id(),
                               level=cur.level - 1)
        g_dag.add_edge(op, z)
        cur = z
    assert z is not None
    return z


def rns_sp_decomp(x: CiphertextNode, output_id: Optional[str] = None) -> CiphertextNode:
    op = FheComputeNode(OperationType.RnsSpDecomp)
    g_dag.add_edges_from([(x, op)])
    y = CiphertextNode(id=output_id if output_id is not None else random_id(), level=x.level)
    y.is_ntt = x.is_ntt
    y.poly1_rns_sp_decomped = True
    g_dag.add_edge(op, y)
    return y


def _register_glk(name: str, level: int):
    if name not in g_swk_node_dict:
        g_swk_node_dict[name] = GaloisKeyNode(id=name, level=level)
    elif level > g_swk_node_dict[name].level:
        g_swk_node_dict[name].level = level


def _rotate_chain(x, steps, output_id, lib: Lib, galois_gen: int):
    """NAF-composite column rotation chain shared by the lattigo/seal variants."""
    if g_param is None:
        raise RuntimeError('Please call set_fhe_param() before using rotation operations.')
    if x.type != DataType.Ciphertext:
        raise ValueError(f'Unsupported input type "{x.type.value}" for rotate.')
    if isinstance(steps, int):
        steps = [steps]

    output = []
    rotated: dict = {0: x}
    for step in steps:
        pos, negs = get_glk_col(step, g_param.n)
        sub_steps = [2 ** i for i in pos] + [-(2 ** i) for i in negs]
        total = 0
        for ss in sub_steps:
            if lib == Lib.Lattigo and math.fabs(ss) % (g_param.n / 2) == 0:
                continue
            if total + ss not in rotated:
                gal = get_galois_element_for_column_rotation_by(ss, g_param.n, galois_gen)
                glk = f'glk_ntt_col_{gal}'
                _register_glk(glk, x.level)
                op = RotateColUnitNode(ss, lib=lib)
                g_dag.add_edges_from([(rotated[total], op), (g_swk_node_dict[glk], op)])
                if ss != sub_steps[-1]:
                    z = _new_ct_like(x, None, x.level)
                else:
                    z = _new_ct_like(x, f'{output_id}_step{step}' if output_id is not None else None,
                                     x.level)
                z.is_ntt = x.is_ntt
                g_dag.add_edge(op, z)
                rotated[total + ss] = z
            total += ss
        output.append(rotated[total])
    return output


def rotate_cols(x, steps, output_id: Optional[str] = None):
    """Composite (NAF) column rotation; registers power-of-two Galois keys."""
    return _rotate_chain(x, steps, output_id, Lib.Lattigo, GALOIS_GEN)


def seal_rotate_cols(x, steps, output_id: Optional[str] = None):
    return _rotate_chain(x, steps, output_id, Lib.SEAL, SEAL_GALOIS_GEN)


def _advanced_rotate(x, steps, output_id, lib: Lib, galois_gen: int, out_ct_type='ct',
                     rot_type='hybrid'):
    if g_param is None:
        raise RuntimeError('Please call set_fhe_param() before using rotation operations.')
    assert rot_type in ['hybrid', 'hoisted']
    if x.type != DataType.Ciphertext:
        raise ValueError(f'Unsupported input type "{x.type.value}" for rotate.')
    if isinstance(steps, int):
        steps = [steps]
    # hoisted: one shared rns_sp_decomp node feeds every rotation
    # (reference keeps this switch internal, custom_task.py:1516)
    y = rns_sp_decomp(x, f'decomped_{x.id}') if rot_type == 'hoisted' else x
    output = []
    for step in steps:
        gal = get_galois_element_for_column_rotation_by(step, g_param.n, galois_gen)
        glk = f'glk_ntt_col_{gal}'
        _register_glk(glk, x.level)
        op = RotateColUnitNode(step, lib=lib)
        g_dag.add_edges_from([(y, op), (g_swk_node_dict[glk], op)])
        z = _new_ct_like(x, f'{output_id}_step{step}' if output_id is not None else None, x.level)
        if isinstance(x, BfvCiphertextNode) and lib == Lib.Lattigo:
            z.is_ntt = 'ntt' in out_ct_type
        else:
            z.is_ntt = x.is_ntt
        z.is_mform = 'mf' in out_ct_type
        g_dag.add_edge(op, z)
        output.append(z)
    return output


def advanced_rotate_cols(x, steps, output_id: Optional[str] = None, out_ct_type: str = 'ct',
                         rot_type: str = 'hybrid'):
    """Direct-key rotation (one Galois key per step); ``rot_type='hoisted'``
    shares one rns_sp_decomp across all steps."""
    assert out_ct_type in ['ct', 'ct-ntt', 'ct-ntt-mf']
    return _advanced_rotate(x, steps, output_id, Lib.Lattigo, GALOIS_GEN, out_ct_type,
                            rot_type)


def seal_advanced_rotate_cols(x, steps, output_id: Optional[str] = None):
    return _advanced_rotate(x, steps, output_id, Lib.SEAL, SEAL_GALOIS_GEN)


def _rotate_rows_impl(x, output_id, lib: Lib):
    if x.type != DataType.Ciphertext:
        raise ValueError(f'Unsupported input type "{x.type.value}" for rotate.')
    _register_glk('glk_ntt_row', x.level)
    op = RotateRowUnitNode(lib=lib)
    g_dag.add_edges_from([(x, op), (g_swk_node_dict['glk_ntt_row'], op)])
    z = _new_ct_like(x, output_id, x.level)
    z.is_ntt = x.is_ntt
    g_dag.add_edge(op, z)
    return z


def rotate_rows(x, output_id: Optional[str] = None):
    return _rotate_rows_impl(x, output_id, Lib.Lattigo)


def seal_rotate_rows(x, output_id: Optional[str] = None):
    return _rotate_rows_impl(x, output_id, Lib.SEAL)


def _cmp_sum_impl(x: list, y: list, output_id, accumulate_ct: bool):
    """Shared builder for cmp_sum (Σ ct_i·pt_i) and cmpac_sum (… + ct_extra)."""
    sum_cnt = len(x) - 1 if accumulate_ct else len(x)
    assert sum_cnt in [1, 2, 4, 8, 16]
    level = x[0].level
    op = CmpacSumComputeNode(sum_cnt) if accumulate_ct else CmpSumComputeNode(sum_cnt)
    y_compressed = isinstance(y[0], tuple)

    for xi in x:
        assert xi.type == DataType.Ciphertext and xi.level == level
    for yi in y:
        if not y_compressed:
            if isinstance(yi, (BfvPlaintextRingtNode, CkksPlaintextRingtNode)):
                op.pt_type = DataType.PlaintextRingt
            elif isinstance(yi, (BfvPlaintextNode, CkksPlaintextNode)):
                op.pt_type = DataType.Plaintext
        else:
            assert isinstance(yi[0], BfvCompressedPlaintextRingtNode) and isinstance(yi[1], int)
            assert yi[0].type == DataType.PlaintextRingt and yi[0].level == 0 and yi[0].is_compressed

    if y_compressed:
        op.compressed_block_info = [yi[0].compressed_block_info[yi[1]] for yi in y]
    for xi in x:
        g_dag.add_edge(xi, op)
    if not y_compressed:
        for yi in y:
            g_dag.add_edge(yi, op)
    else:
        g_dag.add_edge(y[0][0], op)

    z = _new_ct_like(x[0], output_id, level)
    z.is_ntt = x[0].is_ntt
    g_dag.add_edge(op, z)
    return z


def ct_pt_mult_accumulate_add_ct_slice(x: list, y: list, output_id: Optional[str] = None):
    """cmpac_sum: Σ_{i<k} ct_i·pt_i + ct_k (the trailing ct is the accumulator)."""
    assert len(x) == len(y) + 1
    return _cmp_sum_impl(x, y, output_id, accumulate_ct=True)


def ct_pt_mult_accumulate_slice(x: list, y: list, output_id: Optional[str] = None):
    """cmp_sum: Σ ct_i·pt_i."""
    assert len(x) == len(y)
    return _cmp_sum_impl(x, y, output_id, accumulate_ct=False)


def ct_pt_mult_accumulate(x: list, y, output_mform: bool | None = None):
    """Ciphertext–plaintext dot product, greedily tiled into {16,8,4,2,1} slices."""
    y_compressed = isinstance(y, BfvCompressedPlaintextRingtNode)
    if y_compressed:
        assert len(x) == len(y.compressed_block_info)

    def yslice(i):
        return y[i] if not y_compressed else (y, i)

    n_input = len(x)
    if n_input >= 16:
        first = 16
    elif n_input >= 8:
        first = 8
    else:
        first = 1
    if first > 1:
        partial = ct_pt_mult_accumulate_slice(x[:first], [yslice(i) for i in range(first)])
    else:
        partial = mult(x[0], y[0]) if not y_compressed else mult(x[0], y, start_block_idx=0)
    done = first

    while done < n_input:
        size = next(s for s in [16, 8, 4, 2, 1] if n_input - done >= s)
        cts = [x[done + i] for i in range(size)] + [partial]
        partial = ct_pt_mult_accumulate_add_ct_slice(cts, [yslice(done + i) for i in range(size)])
        done += size

    if output_mform is True or (output_mform is None and x[0].is_mform):
        assert isinstance(partial, BfvCiphertextNode)
        partial = to_mform(partial)
    return partial


def ct_pt_mult_accumulate_1(x: list, y: list):
    """Dot product variant: independent cmp_sum slices combined with adds."""
    partial = None
    done = 0
    while done < len(x):
        size = next(s for s in [8, 4, 2, 1] if len(x) - done >= s)
        cc = ct_pt_mult_accumulate_slice(x[done:done + size], y[done:done + size])
        partial = cc if partial is None else add(partial, cc)
        done += size
    if x[0].is_mform:
        assert isinstance(partial, BfvCiphertextNode)
        partial = to_mform(partial)
    assert partial is not None
    return partial


def bootstrap(x: CkksCiphertextNode, output_id: Optional[str] = None) -> CkksCiphertextNode:
    """CKKS bootstrap node; auto-registers rlk, all DFT Galois keys, the row
    key, and the dense↔sparse switching keys at max level."""
    if g_param is None:
        raise RuntimeError('Please call set_fhe_param() before using bootstrap operation.')
    if x.type != DataType.Ciphertext:
        raise ValueError(f'Unsupported input type "{x.type.value}" for bootstrap.')
    if x.level != 0:
        raise ValueError(f'Unsupported input level "{x.level}" for bootstrap.')

    op = FheComputeNode(OperationType.Bootstrap)
    g_dag.add_edge(x, op)

    if 'rlk_ntt' not in g_swk_node_dict:
        g_swk_node_dict['rlk_ntt'] = RelinKeyNode(level=g_param.max_level)
    else:
        g_swk_node_dict['rlk_ntt'].level = g_param.max_level
    g_dag.add_edge(g_swk_node_dict['rlk_ntt'], op)

    for rot in g_param.rotations_for_bootstrapping():
        gal = get_galois_element_for_column_rotation_by(rot, g_param.n)
        glk = f'glk_ntt_col_{gal}'
        if glk not in g_swk_node_dict:
            g_swk_node_dict[glk] = GaloisKeyNode(id=glk, level=g_param.max_level)
        else:
            g_swk_node_dict[glk].level = g_param.max_level
        g_dag.add_edge(g_swk_node_dict[glk], op)

    if 'glk_ntt_row' not in g_swk_node_dict:
        g_swk_node_dict['glk_ntt_row'] = GaloisKeyNode(id='glk_ntt_row', level=g_param.max_level)
    else:
        g_swk_node_dict['glk_ntt_row'].level = g_param.max_level
    g_dag.add_edge(g_swk_node_dict['glk_ntt_row'], op)

    if 'swk_dts' not in g_swk_node_dict:
        g_swk_node_dict['swk_dts'] = SwitchKeyNode(id='swk_dts', level=0,
                                                   sp_level=g_param.get_max_sp_level())
    if 'swk_std' not in g_swk_node_dict:
        g_swk_node_dict['swk_std'] = SwitchKeyNode(id='swk_std', level=g_param.max_level,
                                                   sp_level=g_param.get_max_sp_level())
    g_dag.add_edges_from([(g_swk_node_dict['swk_dts'], op), (g_swk_node_dict['swk_std'], op)])

    z = CkksCiphertextNode(id=output_id if output_id is not None else random_id())
    z.is_ntt = x.is_ntt
    assert isinstance(g_param, CkksBtpParam)
    z.level = g_param.btp_output_level
    g_dag.add_edge(op, z)
    return z


def custom_compute(inputs: list, output, type: str, attributes: dict | None = None):
    """User-defined compute node bound to a user executor at runtime."""
    if not inputs:
        raise ValueError('At least one input data node is required for custom compute.')
    if output is None:
        raise ValueError('Output data node is required for custom compute.')
    op = CustomComputeNode(type=type, attributes=attributes)
    for node in inputs:
        g_dag.add_edge(node, op)
    g_dag.add_edge(op, output)


# ---------------------------------------------------------------------------
# Task serialization
# ---------------------------------------------------------------------------

class Argument:
    """Named (possibly nested-list) group of data nodes forming one task
    argument (reference: frontend/custom_task.py:505)."""

    def __init__(self, arg_id: str, data) -> None:
        if not isinstance(arg_id, str):
            raise ValueError(f'Argument id should be str. Please check your argument-id "{arg_id}".')
        self.id = arg_id
        if not data:
            raise ValueError('Argument data can not be none. Please check your argument-id.')
        self.data = [data] if isinstance(data, DataNode) else list(data)


def _flatten(x):
    if isinstance(x, (list, tuple)):
        out = []
        for a in x:
            out += _flatten(a)
        return out
    return [x]


def _shape(x):
    if not isinstance(x, (list, tuple)):
        return []
    sub = _shape(x[0]) if x else []
    return [len(x)] + sub


def _parameter_blob(param) -> dict:
    parameter = {'n': param.n, 'max_level': param.max_level, 'q': param.q, 'p': param.p}
    if param.algo == Algo.BFV:
        parameter['t'] = param.t
    if isinstance(param, CkksParam):
        parameter['slots'] = param.slots
        parameter['scale'] = param.scale
    if isinstance(param, CkksBtpParam):
        em, cts, stc = param.eval_mod_params, param.cts_params, param.stc_params
        parameter.update({
            'btp_cts_start_level': cts.level_start,
            'btp_cts_depth': cts.depth(),
            'btp_cts_bsgs_ratio': cts.bsgs_ratio,
            'btp_eval_mod_q': em.q,
            'btp_eval_mod_start_level': em.level_start,
            'btp_eval_mod_scaling_factor': em.scaling_factor,
            'btp_eval_mod_sine_type': em.sine_type.name,
            'btp_eval_mod_message_ratio': em.message_ratio,
            'btp_eval_mod_k': em.k,
            'btp_eval_mod_sine_deg': em.sine_deg,
            'btp_eval_mod_double_angle': em.double_angle,
            'btp_eval_mod_arcsine_deg': em.arcsine_deg,
            'btp_stc_start_level': stc.level_start,
            'btp_stc_depth': stc.depth(),
            'btp_stc_bsgs_ratio': stc.bsgs_ratio,
            'btp_output_level': param.btp_output_level,
        })
    return parameter


def process_custom_task(input_args: list | None = None,
                        output_args: list | None = None,
                        offline_input_args: list | None = None,
                        output_instruction_path: str | None = None,
                        fpga_acc: bool = False) -> dict:
    """Validate the global Erg and emit mega_ag.json + task_signature.json
    (schema parity: reference frontend/custom_task.py:2187-2445). Clears the
    global graph state afterwards."""
    global g_param
    if g_param is None:
        raise RuntimeError('Please call set_fhe_param() before calling process_custom_task().')
    if fpga_acc:
        raise NotImplementedError(
            'FPGA acceleration is not part of lattisense-tpu; TPU lowering '
            'partitions the graph at runtime. Pass fpga_acc=False.')

    used_ids: list = []

    def process_args(args, phase: str):
        nodes, sig = [], []
        for arg in (args or []):
            flat = _flatten(arg.data)
            if not flat:
                raise ValueError(f'No data for arg id "{arg.id}".')
            if arg.id in used_ids:
                raise ValueError(f'Same id "{arg.id}" for different Arguments.')
            used_ids.append(arg.id)
            row = {
                'id': arg.id,
                'type': flat[0].type.value if isinstance(flat[0].type, DataType) else flat[0].type,
                'size': _shape(arg.data),
            }
            if isinstance(flat[0], FheDataNode):
                row['level'] = flat[0].level
            row['phase'] = phase
            nodes += flat
            sig.append(row)
        return nodes, sig

    all_inputs, in_sig = process_args(input_args, 'in')
    all_outputs, out_sig = process_args(output_args, 'out')
    all_offline, off_sig = process_args(offline_input_args, 'offline')
    all_inputs += all_offline

    rlk_level = g_swk_node_dict['rlk_ntt'].level if 'rlk_ntt' in g_swk_node_dict else -1
    if rlk_level != -1:
        all_inputs.append(g_swk_node_dict['rlk_ntt'])
    glk_signature = {}
    for name, node in g_swk_node_dict.items():
        if 'col' in name:
            glk_signature[int(name.split('_')[-1])] = node.level
            all_inputs.append(node)
        elif 'row' in name:
            glk_signature[get_galois_element_for_row_rotation(g_param.n)] = node.level
            all_inputs.append(node)
    btp_swk_signature = {}
    for name, node in g_swk_node_dict.items():
        if 'swk' in name:
            btp_swk_signature[name] = (node.level, node.sp_level)
            all_inputs.append(node)

    signature = {
        'algorithm': g_param.algo.value,
        'key': {'rlk': rlk_level, 'glk': glk_signature},
        'online': in_sig + out_sig,
        'offline': off_sig,
    }
    if btp_swk_signature:
        signature['key']['ckks_btp_swk'] = btp_swk_signature

    for node in all_inputs:
        if node not in g_dag:
            raise RuntimeError(
                f'Input data node "{node.id}" is not in the computation graph. '
                f'This usually happens when you reuse data nodes from a previous '
                f'process_custom_task() call — the graph is cleared after each '
                f'call; create new data nodes for each task.')
        if not g_dag.successors(node):
            raise ValueError(f'Input data node "{node.id}" is not used for any computation.')

    data, compute = {}, {}
    for node in g_dag.nodes():
        if isinstance(node, (FheComputeNode, CustomComputeNode)):
            if node.index in compute:
                raise ValueError(f'Same index "{node.index}" for different computation nodes.')
            compute[node.index] = node.to_json_dict(g_dag)
        elif isinstance(node, (FheDataNode, CustomDataNode)):
            if node.index in data:
                raise ValueError(f'Same index "{node.index}" for different data nodes.')
            if not g_dag.successors(node) and node not in all_outputs:
                raise ValueError(
                    f'Data node "{node.index}" is not used for any computation, '
                    f'nor is it an output data node.')
            data[node.index] = node.to_json_dict()

    mag = {
        'name': 'Acc task',
        'algorithm': g_param.algo.value,
        'data': data,
        'compute': compute,
        'inputs': [x.index for x in all_inputs],
        'outputs': [x.index for x in all_outputs],
        'offline_inputs': [x.index for x in all_offline],
        'parameter': _parameter_blob(g_param),
    }

    assert output_instruction_path is not None, 'output_instruction_path must be provided'
    os.makedirs(output_instruction_path, exist_ok=True)
    with open(os.path.join(output_instruction_path, 'task_signature.json'), 'w',
              encoding='utf-8') as f:
        json.dump(signature, f, indent=4)
    with open(os.path.join(output_instruction_path, 'mega_ag.json'), 'w',
              encoding='utf-8') as f:
        json.dump(mag, f, indent=4)

    # reset global state
    global _data_node_count, _compute_node_count, _used_random_ids
    g_swk_node_dict.clear()
    g_dag.clear()
    _data_node_count = 0
    _compute_node_count = 0
    _used_random_ids = set()
    return mag
