"""Example: BFV homomorphic multiply, end-to-end through the compiled-task
path (port of ``examples/bfv_mult/bfv_mult.py``; reference example parity:
examples/bfv_mult_cpu/bfv_mult_cpu.{py,cpp}).

Compile step: build the Erg graph and emit the task directory.
Run step: create a context, encrypt, execute the task, decrypt.

Run: ``python -m lattisense_torch.examples.bfv_mult [--toy] [--n N] [--cpu]``.
"""

import tempfile

import numpy as np

from ._common import bfv_params, example_args

LEVEL = 3


def compile_task(fe_param, task_dir: str) -> str:
    from ..frontend import custom_task as ct
    ct.set_fhe_param(fe_param)
    x = ct.BfvCiphertextNode('x', LEVEL)
    y = ct.BfvCiphertextNode('y', LEVEL)
    z = ct.mult_relin(x, y, 'z')
    ct.process_custom_task([ct.Argument('x', x), ct.Argument('y', y)],
                           [ct.Argument('z', z)], output_instruction_path=task_dir)
    return task_dir


def main(argv=None) -> dict:
    args = example_args('BFV homomorphic multiply', argv)
    from ..runtime import BfvContext, FheTask

    fe_param, params = bfv_params(args.n, args.toy)
    with tempfile.TemporaryDirectory(prefix='bfv_mult_task_') as task_dir:
        # --- compile (frontend) ---
        compile_task(fe_param, task_dir)
        print(f'task compiled -> {task_dir}')

        # --- run (runtime) ---
        context = BfvContext.create_random_context(params, seed=1, device=args.device)
        task = FheTask(task_dir, device=args.device)

    a = np.full(params.n, 3, dtype=np.uint64)
    b = np.full(params.n, 5, dtype=np.uint64)
    ea = context.encrypt(context.encode(a, LEVEL))
    eb = context.encrypt(context.encode(b, LEVEL))
    outputs, dur_ns = task.run(context, {'x': ea, 'y': eb})
    got = context.decrypt_decode(outputs['z'])
    print(f'3 * 5 = {got[0]} (task ran in {dur_ns/1e6:.1f} ms)')
    assert (got == 15).all(), 'decryption mismatch'
    print('OK')
    return {'z': got, 'expected': 15, 'ms': dur_ns / 1e6}


if __name__ == '__main__':
    main()
