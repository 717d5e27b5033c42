"""Channel-packed CKKS conv2d layer (reference
examples/benchmark_convolution): channels share one ciphertext's slots,
kernel positions are slot rotations, one ct×pt MAC per
(channel, position), cyclic boundary semantics.

Port of ``lattisense_tpu/models/convolution.py``; the same graph, packing and
decoding, on the port's frontend and runtime.
"""

import numpy as np

from ._base import FheModel


class PackedConv2d(FheModel):
    def __init__(self, fe_param, pack: int, input_shape, kernel_shape,
                 level: int = 2):
        super().__init__(fe_param)
        self.pack = pack
        self.h, self.w = input_shape
        self.kh, self.kw = kernel_shape
        self.level = level
        self.ch_stride = self.h * self.w
        self.pad_h, self.pad_w = self.kh // 2, self.kw // 2

    def required_rotations(self):
        steps = set()
        for i in range(1, self.pack):
            steps.add(i * self.ch_stride)
        for i in range(1, self.pad_h + 1):
            steps.update({i * self.w, -i * self.w})
        for i in range(1, self.pad_w + 1):
            steps.update({i, -i})
        return sorted(steps)

    def _rot2(self, ct, x, n_rot, unit):
        if n_rot == 0:
            return [x]
        steps = [-i * unit for i in range(1, n_rot + 1)] + \
                [i * unit for i in range(1, n_rot + 1)]
        r = ct.rotate_cols(x, steps)
        return list(reversed(r[:n_rot])) + [x] + r[n_rot:]

    def _build(self, ct):
        x = ct.CkksCiphertextNode('x', self.level)
        weight_pt = [[ct.CkksPlaintextNode(f'w_{c}_{k}', self.level)
                      for k in range(self.kh * self.kw)]
                     for c in range(self.pack)]
        bias_pt = ct.CkksPlaintextNode('b', self.level - 1)
        chan = [x] + (ct.rotate_cols(
            x, [i * self.ch_stride for i in range(1, self.pack)])
            if self.pack > 1 else [])
        partial = None
        for c, xc in enumerate(chan):
            for i, xr in enumerate(self._rot2(ct, xc, self.pad_h, self.w)):
                for j, xrc in enumerate(self._rot2(ct, xr, self.pad_w, 1)):
                    prod = ct.mult(xrc, weight_pt[c][i * self.kw + j])
                    partial = prod if partial is None else ct.add(partial,
                                                                  prod)
        y = ct.add(ct.rescale(partial), bias_pt)
        return ([ct.Argument('x', x), ct.Argument('w', weight_pt),
                 ct.Argument('b', bias_pt)], [ct.Argument('y', y)])

    def pack_inputs(self, context, image, weights, bias: float):
        p = context.params
        xv = np.zeros(p.slots)
        used = self.pack * self.ch_stride
        xv[:used] = np.asarray(image).reshape(-1)[:used]
        u_scale = p.scale ** 2 / p.q[self.level]
        return {
            'x': context.encrypt(context.encode(xv, self.level)),
            'w': [[context.encode(np.full(p.slots, wv), self.level)
                   for wv in wc] for wc in np.asarray(weights)],
            'b': context.encode(np.full(p.slots, bias), self.level - 1,
                                scale=u_scale),
        }, xv

    def decode_output(self, context, outputs):
        return context.decrypt_decode(outputs['y']).real

    def reference_conv(self, xv, weights, bias: float):
        """Plain oracle with identical cyclic semantics."""
        acc = np.zeros_like(xv)
        for c in range(self.pack):
            xc = np.roll(xv, -c * self.ch_stride)
            for i in range(-self.pad_h, self.pad_h + 1):
                for j in range(-self.pad_w, self.pad_w + 1):
                    idx = (i + self.pad_h) * self.kw + (j + self.pad_w)
                    acc = acc + np.roll(xc, -(i * self.w + j)) * \
                        np.asarray(weights)[c][idx]
        return acc + bias
