"""Standalone consumer template (port of ``examples/project_template/main.py``;
reference parity: examples/project_template — the minimal skeleton of an
application built on the framework).

Copy this file out of the repo, put the framework on PYTHONPATH, and fill in
your own task. The JAX template fixes n=16384 and checks nothing; this one
takes the runners' flags and checks the sum.

Run: ``python -m lattisense_torch.examples.project_template [--toy] [--n N] [--cpu]``.
"""

import tempfile

import numpy as np

from lattisense_torch.examples._common import bfv_params, example_args
from lattisense_torch.frontend import custom_task as ct
from lattisense_torch.runtime import BfvContext, FheTask

LEVEL = 1


def compile_task(fe_param, task_dir: str) -> str:
    ct.set_fhe_param(fe_param)
    x = ct.BfvCiphertextNode('x', LEVEL)
    y = ct.BfvPlaintextNode('y', LEVEL)
    z = ct.add(x, y, 'z')
    ct.process_custom_task([ct.Argument('x', x), ct.Argument('y', y)],
                           [ct.Argument('z', z)], output_instruction_path=task_dir)
    return task_dir


def main(argv=None) -> dict:
    args = example_args('project template: an encrypted add', argv)
    fe_param, params = bfv_params(args.n, args.toy)

    # 1. describe the FHE computation
    with tempfile.TemporaryDirectory(prefix='my_task_') as task_dir:
        task = FheTask(compile_task(fe_param, task_dir), device=args.device)

    # 2. create a context + keys, run the compiled task
    context = BfvContext.create_random_context(params, device=args.device)
    n = params.n
    a = np.arange(n, dtype=np.uint64) % context.params.t
    b = np.ones(n, dtype=np.uint64)
    outputs, _ = task.run(context, {
        'x': context.encrypt(context.encode(a, LEVEL)),
        'y': context.encode(b, LEVEL),
    })
    got = context.decrypt_decode(outputs['z'])
    print('first slots:', got[:4])
    expected = (a + b) % context.params.t
    assert np.array_equal(got, expected), 'decryption mismatch'
    print('OK')
    return {'z': got, 'expected': expected}


if __name__ == '__main__':
    main()
