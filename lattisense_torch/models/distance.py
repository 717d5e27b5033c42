"""Packed squared-euclidean distance (reference
examples/ckks_euclidean_distance_cpu): (x - w)^2 per segment,
rotate-and-add over ``pack`` segments, segment mask.

Port of ``lattisense_tpu/models/distance.py``; the same graph, packing and
decoding, on the port's frontend and runtime.
"""

import numpy as np

from ._base import FheModel


class PackedEuclideanDistance(FheModel):
    def __init__(self, fe_param, pack: int, skip: int, level: int = 3):
        super().__init__(fe_param)
        self.pack = pack
        self.skip = skip
        self.level = level

    def required_rotations(self):
        return [self.skip * (j + 1) for j in range(self.pack - 1)]

    def _build(self, ct):
        x = ct.CkksCiphertextNode('x', self.level)
        w = ct.CkksCiphertextNode('w', self.level)
        mask = ct.CkksPlaintextRingtNode(id='mask')
        z = ct.add(x, w, 'z')
        u = ct.rescale(ct.mult_relin(z, z), 'u')
        rots, step = [u], self.skip
        for j in range(self.pack - 1):
            rots.append(ct.rotate_cols(u, step, f'u_rot_{j}')[0])
            step += self.skip
        s = rots[0]
        for k in range(1, len(rots)):
            s = ct.add(s, rots[k], f'sum_{k}')
        d = ct.rescale(ct.mult(s, mask, 'distance'))
        return ([ct.Argument('x_input', x), ct.Argument('w_input_inv', w),
                 ct.Argument('mask', mask)], [ct.Argument('d', d)])

    def pack_inputs(self, context, xv, wv):
        p = context.params
        mask = np.zeros(p.slots)
        mask[:self.skip] = 1.0
        return {
            'x_input': context.encrypt(context.encode(xv, self.level)),
            'w_input_inv': context.encrypt(context.encode(-np.asarray(wv),
                                                          self.level)),
            'mask': context.encode_ringt(mask),
        }

    def decode_output(self, context, outputs):
        return context.decrypt_decode(outputs['d']).real[:self.skip]
