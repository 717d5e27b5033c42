"""Power-DAG polynomial evaluation over BFV (reference
examples/bfv_poly_7_cpu, generalized to any degree): the power ladder
x^1..x^d is built with log-depth mult_relin + rescale level scheduling,
coefficients enter as pt / pt_mul operands.

Port of ``lattisense_tpu/models/polynomial.py``; the same graph, packing and
decoding, on the port's frontend and runtime.
"""

import numpy as np

from ._base import FheModel


class PolynomialEvaluator(FheModel):
    algo = 'BFV'

    def __init__(self, fe_param, degree: int = 7, top_level: int = 4):
        super().__init__(fe_param)
        if degree < 1:
            raise ValueError('degree must be >= 1')
        self.degree = degree
        self.top_level = top_level
        # depth needed: powers up to d need ceil(log2 d) squarings
        need = max(1, (degree).bit_length() - 1) + 1
        if top_level < need:
            raise ValueError(f'top_level {top_level} < required {need}')

    def _build(self, ct):
        d, lv = self.degree, self.top_level
        x = ct.BfvCiphertextNode('x', lv)
        a0 = ct.BfvPlaintextNode('a_0', 1)
        coeffs = [ct.BfvPlaintextMulNode(f'a_{i}', 1)
                  for i in range(1, d + 1)]
        # powers[k] at the level where it is produced; normalize to level 1
        powers = {1: (x, lv)}
        for k in range(2, d + 1):
            h = k // 2
            a, la = powers[h]
            b, lb = powers[k - h]
            tgt = min(la, lb)
            while la > tgt:
                a = ct.rescale(a)
                la -= 1
            while lb > tgt:
                b = ct.rescale(b)
                lb -= 1
            powers[k] = (ct.rescale(ct.mult_relin(a, b)), tgt - 1)
        norm = []
        for k in range(1, d + 1):
            node, l = powers[k]
            while l > 1:
                node = ct.rescale(node)
                l -= 1
            norm.append(node)
        y = a0
        for i in range(d):
            y = ct.add(y, ct.mult(norm[i], coeffs[i]))
        return ([ct.Argument('x', x), ct.Argument('a_0', a0)]
                + [ct.Argument(f'a_{i}', coeffs[i - 1])
                   for i in range(1, d + 1)],
                [ct.Argument('y', y)])

    def pack_inputs(self, context, xv, coeffs):
        """coeffs: [a_0, a_1, ..., a_d] mod t."""
        assert len(coeffs) == self.degree + 1
        ins = {'x': context.encrypt(context.encode(xv, self.top_level)),
               'a_0': context.encode(np.full_like(np.asarray(xv),
                                                  coeffs[0]), 1)}
        for i in range(1, self.degree + 1):
            ins[f'a_{i}'] = context.encode_mul(
                np.full_like(np.asarray(xv), coeffs[i]), 1)
        return ins

    def decode_output(self, context, outputs):
        return context.decrypt_decode(outputs['y'])
