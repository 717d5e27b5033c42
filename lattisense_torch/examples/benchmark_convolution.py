"""Packed-channel CKKS conv2d benchmark (port of
``examples/benchmark_convolution/benchmark_convolution.py``; reference
parity: examples/benchmark_convolution — multiple channels packed into one
ciphertext's slots; kernel positions realized as slot rotations; one ct×pt
MAC per (input-channel, kernel-position); cyclic boundary semantics like
the reference).

Runs the layer end-to-end through the compiled-task path and verifies the
decrypted feature map against a plain simulation of the identical packed
computation.

Run: ``python -m lattisense_torch.examples.benchmark_convolution [--toy] [--n N] [--cpu]``.
"""

import tempfile

import numpy as np

from ._common import ckks_params, example_args

LEVEL = 2


class Conv2DPackedLayer:
    """Channel-packed conv2d graph builder (reference Conv2DPackedLayer)."""

    def __init__(self, ct, n_channel, input_shape, kernel_shape, pack):
        self.ct = ct
        self.n_channel = n_channel
        self.h, self.w = input_shape
        self.kh, self.kw = kernel_shape
        self.pack = pack                      # channels per ciphertext
        self.ch_stride = self.h * self.w      # slots per channel
        self.pad_h, self.pad_w = self.kh // 2, self.kw // 2

    def _rotations_2_sides(self, x, n_rot, unit):
        ct = self.ct
        if n_rot == 0:
            return [x]
        steps = [-i * unit for i in range(1, n_rot + 1)] + \
                [i * unit for i in range(1, n_rot + 1)]
        r = ct.rotate_cols(x, steps)
        return list(reversed(r[:n_rot])) + [x] + r[n_rot:]

    def rotation_steps(self):
        """All rotation steps the layer needs (for key generation)."""
        steps = set()
        for i in range(1, self.pack):
            steps.add(i * self.ch_stride)
        for i in range(1, self.pad_h + 1):
            steps.update({i * self.w, -i * self.w})
        for i in range(1, self.pad_w + 1):
            steps.update({i, -i})
        return sorted(steps)

    def build(self, x, weight_pt, bias_pt):
        """x: packed input ct node; weights[pack][kh*kw] pt nodes; bias pt."""
        ct = self.ct
        # channel alignment rotations then spatial rotations per channel
        chan_rots = [x] + (ct.rotate_cols(
            x, [i * self.ch_stride for i in range(1, self.pack)])
            if self.pack > 1 else [])
        partial = None
        for c, xc in enumerate(chan_rots):
            rows = self._rotations_2_sides(xc, self.pad_h, self.w)
            for i, xr in enumerate(rows):
                cols = self._rotations_2_sides(xr, self.pad_w, 1)
                for j, xrc in enumerate(cols):
                    prod = ct.mult(xrc, weight_pt[c][i * self.kw + j])
                    partial = prod if partial is None else ct.add(partial, prod)
        out = ct.add(ct.rescale(partial), bias_pt)
        return out


def plain_packed_conv(xv, weights, bias, layer):
    """Plain simulation with identical cyclic-rotation semantics."""
    acc = np.zeros_like(xv)
    for c in range(layer.pack):
        xc = np.roll(xv, -c * layer.ch_stride)
        for i in range(-layer.pad_h, layer.pad_h + 1):
            for j in range(-layer.pad_w, layer.pad_w + 1):
                idx = (i + layer.pad_h) * layer.kw + (j + layer.pad_w)
                acc = acc + np.roll(xc, -(i * layer.w + j)) * weights[c][idx]
    return acc + bias


def shapes(slots: int, toy: bool):
    """(input shape, kernel shape, channels packed a ciphertext)."""
    input_shape, kernel = ((4, 4), (3, 3)) if toy else ((32, 32), (3, 3))
    pack = max(1, min(4, slots // (input_shape[0] * input_shape[1])))
    return input_shape, kernel, pack


def compile_task(fe_param, task_dir: str, input_shape, kernel, pack):
    """Emit the layer's task; → the layer (its rotation steps)."""
    from ..frontend import custom_task as fct
    fct.set_fhe_param(fe_param)
    layer = Conv2DPackedLayer(fct, pack, input_shape, kernel, pack)
    x = fct.CkksCiphertextNode('x', LEVEL)
    weight_pt = [[fct.CkksPlaintextNode(f'w_{c}_{k}', LEVEL)
                  for k in range(kernel[0] * kernel[1])] for c in range(pack)]
    bias_pt = fct.CkksPlaintextNode('b', LEVEL - 1)
    y = layer.build(x, weight_pt, bias_pt)
    fct.process_custom_task(
        [fct.Argument('x', x), fct.Argument('w', weight_pt), fct.Argument('b', bias_pt)],
        [fct.Argument('y', y)], output_instruction_path=task_dir)
    return layer


def main(argv=None) -> dict:
    args = example_args('packed CKKS conv2d layer', argv)
    from ..runtime import CkksContext, FheTask

    fe_param, rt_params = ckks_params(args.n, args.toy)
    slots = rt_params.slots
    input_shape, kernel, pack = shapes(slots, args.toy)
    with tempfile.TemporaryDirectory(prefix='conv2d_task_') as task_dir:
        layer = compile_task(fe_param, task_dir, input_shape, kernel, pack)
        task = FheTask(task_dir, device=args.device)

    context = CkksContext.create_random_context(rt_params, seed=17, device=args.device)
    context.gen_rotation_keys_for_rotations(layer.rotation_steps())

    rng = np.random.default_rng(0)
    xv = np.zeros(slots)
    used = pack * layer.ch_stride
    xv[:used] = rng.uniform(-1, 1, used)
    weights = rng.uniform(-1, 1, (pack, kernel[0] * kernel[1]))
    bias = rng.uniform(-1, 1)
    u_scale = rt_params.scale ** 2 / rt_params.q[LEVEL]

    inputs = {
        'x': context.encrypt(context.encode(xv, LEVEL)),
        'w': [[context.encode(np.full(slots, wv), LEVEL) for wv in wc]
              for wc in weights],
        'b': context.encode(np.full(slots, bias), LEVEL - 1, scale=u_scale),
    }
    outputs, dur_ns = task.run(context, inputs)
    got = context.decrypt_decode(outputs['y']).real
    expected = plain_packed_conv(xv, weights, bias, layer)
    err = np.max(np.abs(got - expected))
    macs = pack * kernel[0] * kernel[1]
    print(f'conv2d {input_shape[0]}x{input_shape[1]} pack={pack} '
          f'{kernel[0]}x{kernel[1]}: {macs} ct-pt MACs, {dur_ns/1e6:.1f} ms, '
          f'max err {err:.2e}')
    assert err < 1e-2, 'conv mismatch'
    print('OK')
    return {'y': got, 'expected': expected, 'max_err': err, 'ms': dur_ns / 1e6}


if __name__ == '__main__':
    main()
