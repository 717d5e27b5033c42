"""Example: logistic-regression inference score (port of
``examples/ckks_logistic_regression/ckks_logistic_regression.py``; reference
parity: examples/ckks_logistic_regression_cpu — x·w dot product via
log-rotations, bias add, output mask).

Run: ``python -m lattisense_torch.examples.ckks_logistic_regression [--toy] [--n N] [--cpu]``.
"""

import math
import tempfile

import numpy as np

from ._common import ckks_params, example_args

LEVEL = 3


def build(ct, n_input_feature: int, level: int):
    x = ct.CkksCiphertextNode('x', level)
    w = ct.CkksPlaintextRingtNode()
    b = ct.CkksPlaintextNode('b', level - 1)
    mask = ct.CkksPlaintextRingtNode()

    u = ct.rescale(ct.mult(x, w))
    n_rotate = math.ceil(math.log(n_input_feature, 2))
    step = int(math.pow(2, n_rotate) / 2)
    for _ in range(n_rotate):
        u_rot = ct.rotate_cols(u, step)
        u = ct.add(u, u_rot[0])
        step = step // 2
    s = ct.add(u, b)
    y = ct.rescale(ct.mult(s, mask))
    return x, w, b, mask, y


def compile_task(fe_param, task_dir: str, n_feat: int) -> str:
    from ..frontend import custom_task as ct
    ct.set_fhe_param(fe_param)
    x, w, b, mask, y = build(ct, n_feat, LEVEL)
    ct.process_custom_task(
        [ct.Argument('x', x), ct.Argument('w', w), ct.Argument('b', b),
         ct.Argument('mask', mask)],
        [ct.Argument('y', y)], output_instruction_path=task_dir)
    return task_dir


def main(argv=None) -> dict:
    args = example_args('CKKS logistic regression inference', argv)
    from ..runtime import CkksContext, FheTask

    fe_param, rt_params = ckks_params(args.n, args.toy)
    n_feat = min(30, rt_params.slots)
    with tempfile.TemporaryDirectory(prefix='ckks_logreg_task_') as task_dir:
        task = FheTask(compile_task(fe_param, task_dir, n_feat), device=args.device)

    context = CkksContext.create_random_context(rt_params, seed=8, device=args.device)
    n_rotate = math.ceil(math.log(n_feat, 2))
    steps = [2 ** i for i in range(n_rotate)]
    context.gen_rotation_keys_for_rotations(steps)

    rng = np.random.default_rng(0)
    scale = context.params.scale
    xv = np.zeros(rt_params.slots)
    wv = np.zeros(rt_params.slots)
    xv[:n_feat] = rng.uniform(-1, 1, n_feat)
    wv[:n_feat] = rng.uniform(-1, 1, n_feat)
    bias = 0.25
    u_scale = scale * scale / rt_params.q[LEVEL]
    mask_v = np.zeros(rt_params.slots)
    mask_v[0] = 1.0
    inputs = {
        'x': context.encrypt(context.encode(xv, LEVEL)),
        'w': context.encode_ringt(wv),
        'b': context.encode(np.full(rt_params.slots, bias), LEVEL - 1, scale=u_scale),
        'mask': context.encode_ringt(mask_v),
    }
    outputs, dur_ns = task.run(context, inputs)
    got = context.decrypt_decode(outputs['y']).real[0]
    expected = float(xv @ wv) + bias
    assert abs(got - expected) < 1e-2, f'{got} != {expected}'
    print(f'score = {got:.4f} (expected {expected:.4f}, {dur_ns/1e6:.1f} ms) — OK')
    return {'score': got, 'expected': expected, 'ms': dur_ns / 1e6}


if __name__ == '__main__':
    main()
