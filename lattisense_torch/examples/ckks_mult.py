"""Example: CKKS mult + relinearize + rescale through the compiled-task path
(port of ``examples/ckks_mult/ckks_mult.py``; reference parity:
examples/ckks_mult_cpu).

Run: ``python -m lattisense_torch.examples.ckks_mult [--toy] [--n N] [--cpu]``.
"""

import tempfile

import numpy as np

from ._common import ckks_params, example_args

LEVEL = 3


def compile_task(fe_param, task_dir: str) -> str:
    from ..frontend import custom_task as ct
    ct.set_fhe_param(fe_param)
    x = ct.CkksCiphertextNode('x', LEVEL)
    y = ct.CkksCiphertextNode('y', LEVEL)
    z = ct.rescale(ct.mult_relin(x, y, 'z'), 'zr')
    ct.process_custom_task([ct.Argument('x', x), ct.Argument('y', y)],
                           [ct.Argument('zr', z)], output_instruction_path=task_dir)
    return task_dir


def main(argv=None) -> dict:
    args = example_args('CKKS homomorphic multiply', argv)
    from ..runtime import CkksContext, FheTask

    fe_param, rt_params = ckks_params(args.n, args.toy)
    with tempfile.TemporaryDirectory(prefix='ckks_mult_task_') as task_dir:
        task = FheTask(compile_task(fe_param, task_dir), device=args.device)

    context = CkksContext.create_random_context(rt_params, seed=1, device=args.device)
    xv, yv = np.array([5.0, 10.0]), np.array([2.0, 3.0])
    ea = context.encrypt(context.encode(xv, LEVEL))
    eb = context.encrypt(context.encode(yv, LEVEL))
    outputs, dur_ns = task.run(context, {'x': ea, 'y': eb})
    got = context.decrypt_decode(outputs['zr']).real[:2]
    print(f'[5,10] * [2,3] = {np.round(got, 4)} ({dur_ns/1e6:.1f} ms)')
    assert np.allclose(got, [10.0, 30.0], atol=1e-2)
    print('OK')
    return {'zr': got, 'expected': xv * yv, 'ms': dur_ns / 1e6}


if __name__ == '__main__':
    main()
