"""Example: 2-party client/server encrypted computation over serialized
bytes (port of
``examples/ckks_mult_serialization/ckks_mult_serialization.py``; reference
parity: examples/ckks_mult_serialization_cpu — the client keeps the secret
key; the server computes on deserialized state). The bytes are the JAX
package's format (``utils/serialize.py``).

Run: ``python -m lattisense_torch.examples.ckks_mult_serialization [--toy] [--n N] [--cpu]``.
"""

import numpy as np

from ._common import ckks_params, example_args

LEVEL = 3


def client_phase_0(rt_params, level, device=None):
    from ..runtime import CkksContext
    ctx = CkksContext.create_random_context(rt_params, seed=3, device=device)
    x_ct = ctx.encrypt(ctx.encode(np.array([5.0, 10.0]), level))
    y_ct = ctx.encrypt(ctx.encode(np.array([2.0, 3.0]), level))
    public_ctx_bin = ctx.make_public_context().serialize_advanced()
    return (ctx, public_ctx_bin, ctx.serialize_ciphertext(x_ct),
            ctx.serialize_ciphertext(y_ct))


def server_phase_1(ctx_bin: bytes, x_bin: bytes, y_bin: bytes, device=None) -> bytes:
    from ..runtime import CkksContext
    public_context = CkksContext.deserialize(ctx_bin, device=device)
    x_ct = public_context.deserialize_ciphertext(x_bin, device=public_context.device)
    y_ct = public_context.deserialize_ciphertext(y_bin, device=public_context.device)
    z_ct = public_context.relinearize(public_context.mult(x_ct, y_ct))
    return public_context.serialize_ciphertext(z_ct)


def client_phase_2(ctx, z_bin: bytes):
    z_ct = ctx.deserialize_ciphertext(z_bin, device=ctx.device)
    return ctx.decrypt_decode(z_ct).real[:2]


def main(argv=None) -> dict:
    args = example_args('CKKS two-party encrypted computation with serialization', argv)
    _, rt_params = ckks_params(args.n, args.toy)
    ctx, public_ctx_bin, x_bin, y_bin = client_phase_0(rt_params, LEVEL, args.device)
    print(f'client -> server: context {len(public_ctx_bin)} B, '
          f'cts {len(x_bin)} + {len(y_bin)} B')
    z_bin = server_phase_1(public_ctx_bin, x_bin, y_bin, args.device)
    print(f'server -> client: {len(z_bin)} B')
    got = client_phase_2(ctx, z_bin)
    print(f'z = {np.round(got, 4)}')
    assert np.allclose(got, [10.0, 30.0], atol=1e-2)
    print('OK')
    return {'z': got, 'expected': np.array([10.0, 30.0]), 'context_bytes': len(public_ctx_bin),
            'ciphertext_bytes': len(x_bin), 'result_bytes': len(z_bin)}


if __name__ == '__main__':
    main()
