"""Example: degree-7 polynomial evaluation with the level ladder (port of
``examples/bfv_poly_7/bfv_poly_7.py``; reference parity:
examples/bfv_poly_7_cpu — power DAG x^1..x^7 via mult_relin + rescale,
coefficients as pt / pt_mul).

Run: ``python -m lattisense_torch.examples.bfv_poly_7 [--toy] [--n N] [--cpu]``.
"""

import tempfile

import numpy as np

from ._common import bfv_params, example_args


def build(ct):
    x = ct.BfvCiphertextNode('x', 4)
    a0 = ct.BfvPlaintextNode('a_0', 1)
    a = [ct.BfvPlaintextMulNode(f'a_{i}', 1) for i in range(1, 8)]

    x1_lv4 = x
    x2_lv3 = ct.rescale(ct.mult_relin(x1_lv4, x1_lv4))
    x1_lv3 = ct.rescale(x1_lv4)
    x3_lv2 = ct.rescale(ct.mult_relin(x1_lv3, x2_lv3))
    x4_lv2 = ct.rescale(ct.mult_relin(x2_lv3, x2_lv3))
    x2_lv2 = ct.rescale(x2_lv3)
    x5_lv1 = ct.rescale(ct.mult_relin(x2_lv2, x3_lv2))
    x6_lv1 = ct.rescale(ct.mult_relin(x3_lv2, x3_lv2))
    x7_lv1 = ct.rescale(ct.mult_relin(x3_lv2, x4_lv2))
    x2_lv1 = ct.rescale(x2_lv2)
    x3_lv1 = ct.rescale(x3_lv2)
    x4_lv1 = ct.rescale(x4_lv2)
    x1_lv2 = ct.rescale(x1_lv3)
    x1_lv1 = ct.rescale(x1_lv2)
    x_powers = [x1_lv1, x2_lv1, x3_lv1, x4_lv1, x5_lv1, x6_lv1, x7_lv1]
    y = a0
    for i in range(7):
        y = ct.add(y, ct.mult(x_powers[i], a[i]))
    return x, a0, a, y


def compile_task(fe_param, task_dir: str) -> str:
    from ..frontend import custom_task as ct
    ct.set_fhe_param(fe_param)
    x, a0, a, y = build(ct)
    ct.process_custom_task(
        [ct.Argument('x', x), ct.Argument('a0', a0), ct.Argument('a', a)],
        [ct.Argument('y', y)], output_instruction_path=task_dir)
    return task_dir


def main(argv=None) -> dict:
    args = example_args('BFV degree-7 polynomial evaluation', argv)
    from ..runtime import BfvContext, FheTask

    fe_param, rt_params = bfv_params(args.n, args.toy)
    t = rt_params.t
    with tempfile.TemporaryDirectory(prefix='bfv_poly7_task_') as task_dir:
        task = FheTask(compile_task(fe_param, task_dir), device=args.device)

    context = BfvContext.create_random_context(rt_params, seed=5, device=args.device)
    rng = np.random.default_rng(0)
    xv = rng.integers(0, 16, rt_params.n, dtype=np.uint64)
    coeffs = rng.integers(0, 16, 8, dtype=np.uint64)
    inputs = {
        'x': context.encrypt(context.encode(xv, 4)),
        'a0': context.encode(np.full(rt_params.n, coeffs[0], dtype=np.uint64), 1),
        'a': [context.encode_mul(np.full(rt_params.n, c, dtype=np.uint64), 1)
              for c in coeffs[1:]],
    }
    outputs, dur_ns = task.run(context, inputs)
    got = context.decrypt_decode(outputs['y'])
    expected = np.zeros(rt_params.n, dtype=object) + int(coeffs[0])
    xo = xv.astype(object)
    for i in range(1, 8):
        expected = expected + int(coeffs[i]) * pow(xo, i)
    expected = (expected % t).astype(np.uint64)
    assert np.array_equal(got, expected), 'polynomial evaluation mismatch'
    print(f'p(x) evaluated homomorphically on {rt_params.n} slots '
          f'({dur_ns/1e6:.1f} ms) — OK')
    return {'y': got, 'expected': expected, 'ms': dur_ns / 1e6}


if __name__ == '__main__':
    main()
