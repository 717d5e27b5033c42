"""Example: packed squared-euclidean distance (port of
``examples/ckks_euclidean_distance/ckks_euclidean_distance.py``; reference
parity: examples/ckks_euclidean_distance_cpu — (x+w)^2, rotate-and-add
reduction over packed segments, mask multiply).

Run: ``python -m lattisense_torch.examples.ckks_euclidean_distance [--toy] [--n N] [--cpu]``.
"""

import tempfile

import numpy as np

from ._common import ckks_params, example_args

PACK = 4


def build(ct, pack: int, skip: int):
    x = ct.CkksCiphertextNode('x', 3)
    w = ct.CkksCiphertextNode('w', 3)
    mask = ct.CkksPlaintextRingtNode(id='mask')

    z = ct.add(x, w, 'z')
    u = ct.rescale(ct.mult_relin(z, z), 'u')
    u_rot_list = [u]
    step = skip
    for j in range(pack - 1):
        u_rot_list.append(ct.rotate_cols(u, step, f'u_rot_{j}')[0])
        step += skip
    s = u_rot_list[0]
    for k in range(1, len(u_rot_list)):
        s = ct.add(s, u_rot_list[k], f'sum_{k}')
    distance = ct.rescale(ct.mult(s, mask, 'distance'))
    return x, w, mask, distance


def compile_task(fe_param, task_dir: str, pack: int, skip: int) -> str:
    from ..frontend import custom_task as ct
    ct.set_fhe_param(fe_param)
    x, w, mask, distance = build(ct, pack, skip)
    ct.process_custom_task(
        [ct.Argument('x_input', x), ct.Argument('w_input_inv', w),
         ct.Argument('mask', mask)],
        [ct.Argument('d', distance)], output_instruction_path=task_dir)
    return task_dir


def main(argv=None) -> dict:
    args = example_args('CKKS packed euclidean distance', argv)
    from ..runtime import CkksContext, FheTask

    fe_param, rt_params = ckks_params(args.n, args.toy)
    slots = rt_params.slots
    pack, skip = PACK, slots // 8
    with tempfile.TemporaryDirectory(prefix='ckks_eucl_task_') as task_dir:
        task = FheTask(compile_task(fe_param, task_dir, pack, skip), device=args.device)

    context = CkksContext.create_random_context(rt_params, seed=6, device=args.device)
    # rotation keys for the NAF decompositions of the used steps
    context.gen_rotation_keys_for_rotations([skip * (j + 1) for j in range(pack - 1)])

    rng = np.random.default_rng(0)
    xv = rng.uniform(-1, 1, pack * skip)
    wv = rng.uniform(-1, 1, pack * skip)
    mask_v = np.zeros(slots)
    mask_v[:skip] = 1.0
    inputs = {
        'x_input': context.encrypt(context.encode(xv, 3)),
        'w_input_inv': context.encrypt(context.encode(-wv, 3)),
        'mask': context.encode_ringt(mask_v),
    }
    outputs, dur_ns = task.run(context, inputs)
    got = context.decrypt_decode(outputs['d']).real[:skip]

    diff2 = (xv - wv).reshape(pack, skip) ** 2
    expected = diff2.sum(axis=0)
    err = np.max(np.abs(got - expected))
    assert err < 1e-2, f'distance mismatch (max err {err})'
    print(f'packed euclidean distance over {pack}x{skip} features '
          f'({dur_ns/1e6:.1f} ms, max err {err:.2e}) — OK')
    return {'distance': got, 'expected': expected, 'max_err': err, 'ms': dur_ns / 1e6}


if __name__ == '__main__':
    main()
