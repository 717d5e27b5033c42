"""Encrypted matrix–vector product y = A·x (CKKS, BSGS diagonal method).

Halevi–Shoup diagonal decomposition with a baby-step/giant-step split:
with d = g·n1 + j,

    y = Σ_g rot_{g·n1}( Σ_j [rot_{-g·n1}(diag_{g·n1+j})] ⊙ rot_j(x) )

- baby rotations rot_j(x) share ONE hoisted key-switch decomposition
  (`advanced_rotate_cols(..., rot_type='hoisted')` — the reference's
  rns_sp_decomp hoisting, frontend/custom_task.py:1360);
- each giant step's inner sum is a fused ct×pt MAC
  (`ct_pt_mult_accumulate_slice` → cmp_sum nodes, the reference's fused
  MAC builders, frontend/custom_task.py:1746);
- giant rotations use direct Galois keys.

Generalizes the model zoo's fixed dot-product workloads to arbitrary
dense (slots × slots) real matrices — the building block of encrypted
linear layers. The same math drives bootstrap's CoeffsToSlots
(schemes/linear_transform.py); this model packages it as a compiled,
offline-preloadable task.

Port of ``lattisense_tpu/models/matvec.py``; the same graph, packing and
decoding, on the port's frontend and runtime.
"""

import math

import numpy as np

from ._base import FheModel


class EncryptedMatVec(FheModel):
    def __init__(self, fe_param, matrix: np.ndarray, level: int = 2,
                 n1: int | None = None):
        super().__init__(fe_param)
        self.matrix = np.asarray(matrix, dtype=float)
        s = self.matrix.shape[0]
        assert self.matrix.shape == (s, s), 'matrix must be square'
        assert s == fe_param.slots, 'matrix size must equal slot count'
        self.slots = s
        self.level = level
        self.n1 = n1 or (1 << max(0, math.isqrt(s).bit_length() - 1))
        self.n2 = -(-s // self.n1)
        # one pass over the matrix: pre-rotated nonzero diagonals
        self._diags = {d: v for d in range(s)
                       if np.any(v := self._diag(d))}
        if not self._diags:
            raise ValueError('matrix has no nonzero diagonals')

    # rotation steps needing direct Galois keys (zero diagonals of banded
    # matrices cost neither rotations nor keys)
    def _nonzero_diags(self):
        return list(self._diags)

    def baby_steps(self):
        return sorted({d % self.n1 for d in self._nonzero_diags()} - {0})

    def giant_steps(self):
        return sorted({(d // self.n1) * self.n1
                       for d in self._nonzero_diags()} - {0})

    def required_galois_elements(self):
        from ..frontend.custom_task import (
            get_galois_element_for_column_rotation_by)
        n = self.fe_param.n
        return [get_galois_element_for_column_rotation_by(st, n)
                for st in self.baby_steps() + self.giant_steps()]

    def _diag(self, d: int) -> np.ndarray:
        """diag_d[k] = A[k, (k+d) mod s], pre-rotated for its giant step."""
        k = np.arange(self.slots)
        v = self.matrix[k, (k + d) % self.slots]
        g = d // self.n1
        return np.roll(v, g * self.n1)     # rot_{-g·n1} of the diagonal

    def _build(self, ct):
        x = ct.CkksCiphertextNode('x', self.level)
        pts = {}
        ins = [ct.Argument('x', x)]
        for d in self._nonzero_diags():
            pts[d] = ct.CkksPlaintextRingtNode(id=f'diag{d}')
            ins.append(ct.Argument(f'diag{d}', pts[d]))

        # hoist only the baby rotations some nonzero diagonal consumes
        used = sorted({d % self.n1 for d in pts} - {0})
        rotated = {0: x}
        if used:
            outs = ct.advanced_rotate_cols(x, used, 'xbaby',
                                           rot_type='hoisted')
            rotated.update(dict(zip(used, outs)))

        y = None
        for g in range(self.n2):
            cts_g, pts_g = [], []
            for j in range(self.n1):
                d = g * self.n1 + j
                if d in pts:
                    cts_g.append(rotated[j])
                    pts_g.append(pts[d])
            if not cts_g:
                continue
            acc = ct.rescale(ct.ct_pt_mult_accumulate_1(cts_g, pts_g),
                             f'acc{g}')
            if g:
                acc = ct.advanced_rotate_cols(acc, [g * self.n1],
                                              f'accrot{g}')[0]
            y = acc if y is None else ct.add(y, acc, f'y{g}')
        return ins, [ct.Argument('y', y)]

    def pack_inputs(self, context, xv):
        out = {'x': context.encrypt(context.encode(xv, self.level))}
        for d, v in self._diags.items():
            out[f'diag{d}'] = context.encode_ringt(v)
        return out

    def decode_output(self, context, outputs):
        return context.decrypt_decode(outputs['y']).real[:self.slots]
