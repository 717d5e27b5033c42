"""Encrypted logistic-regression inference score (reference
examples/ckks_logistic_regression_cpu): packed dot product via
log2(features) rotate-and-add, bias, slot-0 mask.

Port of ``lattisense_tpu/models/logistic.py``; the same graph, packing and
decoding, on the port's frontend and runtime.
"""

import math

import numpy as np

from ._base import FheModel


class LogisticRegressionScore(FheModel):
    def __init__(self, fe_param, n_features: int, level: int = 3):
        super().__init__(fe_param)
        self.n_features = n_features
        self.level = level
        self.n_rotate = max(1, math.ceil(math.log2(n_features)))

    def required_rotations(self):
        return [2 ** i for i in range(self.n_rotate)]

    def _build(self, ct):
        x = ct.CkksCiphertextNode('x', self.level)
        w = ct.CkksPlaintextRingtNode()
        b = ct.CkksPlaintextNode('b', self.level - 1)
        mask = ct.CkksPlaintextRingtNode()
        u = ct.rescale(ct.mult(x, w))
        step = 2 ** self.n_rotate // 2
        for _ in range(self.n_rotate):
            u = ct.add(u, ct.rotate_cols(u, step)[0])
            step //= 2
        y = ct.rescale(ct.mult(ct.add(u, b), mask))
        return ([ct.Argument('x', x), ct.Argument('w', w),
                 ct.Argument('b', b), ct.Argument('mask', mask)],
                [ct.Argument('y', y)])

    def pack_inputs(self, context, features, weights, bias: float):
        p = context.params
        xv = np.zeros(p.slots)
        wv = np.zeros(p.slots)
        xv[:self.n_features] = features
        wv[:self.n_features] = weights
        mask = np.zeros(p.slots)
        mask[0] = 1.0
        u_scale = p.scale * p.scale / p.q[self.level]
        return {
            'x': context.encrypt(context.encode(xv, self.level)),
            'w': context.encode_ringt(wv),
            'b': context.encode(np.full(p.slots, bias), self.level - 1,
                                scale=u_scale),
            'mask': context.encode_ringt(mask),
        }

    @staticmethod
    def decode_output(context, outputs) -> float:
        return float(context.decrypt_decode(outputs['y']).real[0])
