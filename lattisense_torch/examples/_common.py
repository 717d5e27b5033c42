"""Shared example scaffolding: the command line and the parameter helpers.

Port of ``examples/_common.py``. Every runner takes ``--n <ring_dim>``
(default 16384, reference parity), ``--toy`` (n=64 custom parameters, for a
fast self-check) and ``--cpu``. Unlike the JAX helper, ``--toy`` keeps the
card: ``--cpu`` is the only way to the CPU.
"""

import argparse

from .. import resolve_device


def example_args(description: str, argv=None, flags=()):
    """Parse ``argv`` (``sys.argv[1:]`` when None); ``flags`` names extra
    boolean switches. ``args.device`` is the device the runner computes on:
    the card, or the CPU with ``--cpu``; it raises when the card is asked
    for and absent."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument('--n', type=int, default=16384)
    ap.add_argument('--toy', action='store_true',
                    help='n=64 custom params for a fast self-check (still on the card)')
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (the plain PyTorch twins of the kernels)')
    for flag in flags:
        ap.add_argument(flag, action='store_true')
    args = ap.parse_args(argv)
    if args.toy:
        args.n = 64
    args.device = resolve_device('cpu' if args.cpu else None)
    return args


def bfv_params(n: int, toy: bool):
    """(frontend Param, runtime BfvParams) pair for the chosen size."""
    from ..frontend import custom_task as ct
    from ..params import BfvParams

    if toy:
        from ..core.modring import gen_ntt_primes
        q = gen_ntt_primes(n, 50, 5)
        p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
        return (ct.BfvParam.create_custom_param(n=n, q=q, p=p, t=65537),
                BfvParams.create_custom(n, 65537, q, p))
    return ct.BfvParam.create_default_param(n=n), BfvParams.create(n)


def ckks_params(n: int, toy: bool):
    """(frontend Param, runtime CkksParams) pair for the chosen size."""
    from ..frontend import custom_task as ct
    from ..params import CkksParams

    if toy:
        from ..core.modring import gen_ntt_primes
        big = gen_ntt_primes(n, 60, 2)
        mids = gen_ntt_primes(n, 40, 4)
        q, p, scale = [big[0]] + mids, [big[1]], float(1 << 40)
        return (ct.CkksParam.create_custom_param(n=n, q=q, p=p, scale=scale),
                CkksParams.create_custom(n, q, p, scale=scale))
    return ct.CkksParam.create_default_param(n=n), CkksParams.create(n)

