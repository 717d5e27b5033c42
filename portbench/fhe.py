"""What the traffic drivers share: the seeded data the benchmark makes
itself (secrets, messages), the program's contexts built on those secrets,
and the spans of a traced step.

The benchmark draws every secret and message from ``--seed`` with NumPy and
hands them to the program, whose own sampling (public-key masks, noise,
evaluation keys) draws from its CSPRNG seeded with the same number. So one
seed gives one run's inputs, and the reference decrypts with the secret the
benchmark made, never with a key of the program's.
"""

import contextlib
import time

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's stream ``stream``: 1 the secret, 2 the messages."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def secret(seed: int, cfg: dict) -> np.ndarray:
    """The run's ternary secret as the configuration states it, (n,) int64:
    ``secret_weight`` distinct positions of random sign where it gives a
    Hamming weight, else uniform."""
    g, n = rng(seed, 1), cfg['n']
    if 'secret_weight' not in cfg:
        return g.integers(-1, 2, n, dtype=np.int64)
    h = cfg['secret_weight']
    s = np.zeros(n, dtype=np.int64)
    s[g.choice(n, size=h, replace=False)] = g.choice(np.array([-1, 1], dtype=np.int64), size=h)
    return s


def bfv_context(cfg: dict, seed: int, device, s: np.ndarray):
    """The program's BFV context on ``device`` holding the secret ``s`` and
    its public key; evaluation keys are added by the driver."""
    from lattisense_torch.params import BfvParams
    from lattisense_torch.runtime.context import BfvContext
    from lattisense_torch.schemes import keys as K
    params = BfvParams(cfg['n'], cfg['t'], cfg['q'], cfg['p'], word_bits=cfg['word_bits'])
    ctx = BfvContext(params, seed, device)
    _own_keys(ctx, K, s)
    return ctx


def ckks_context(cfg: dict, seed: int, device, s: np.ndarray, cls=None):
    """The program's CKKS context (or ``cls``) on ``device`` holding the
    secret ``s`` and its public key."""
    from lattisense_torch.params import CkksParams
    from lattisense_torch.runtime.context import CkksContext
    from lattisense_torch.schemes import keys as K
    params = CkksParams.create_custom(cfg['n'], cfg['q'], cfg['p'], slots=cfg['slots'],
                                      scale=float(cfg['scale']), word_bits=cfg['word_bits'])
    ctx = (cls or CkksContext)(params, seed, device)
    _own_keys(ctx, K, s)
    return ctx


def _own_keys(ctx, K, s):
    p = ctx.params
    ctx.sk = K.SecretKey(s)
    ctx.pk = K.gen_public_key(ctx.rng, ctx.sk, tuple(p.q), p.n, ctx.device, p.word_bits)


def add_relin_key(ctx):
    from lattisense_torch.schemes import keys as K
    p = ctx.params
    ctx.rlk = K.gen_relin_key(ctx.rng, ctx.sk, tuple(p.q), tuple(p.p), p.n, ctx.device,
                              p.word_bits)


def stack(cts):
    import torch
    return torch.stack([ct.data for ct in cts])


class Spans:
    """The named parts of each traced step, timed between CUDA events (the
    host clock on the CPU) and labelled ``pb.<name>`` for the profiler, so
    that the kernels launched inside a part can be told apart in a trace."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == 'cuda'
        self.marks: dict[str, list] = {}

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def __call__(self, name: str):
        with self.torch.profiler.record_function('pb.' + name):
            start = self._mark()
            yield
            self.marks.setdefault(name, []).append((start, self._mark()))

    def ms(self) -> dict[str, list[float]]:
        """Each part's milliseconds, one entry a step, once the device is
        idle."""
        if self.cuda:
            self.torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.marks.items()}
        return {k: [(b - a) * 1e3 for a, b in v] for k, v in self.marks.items()}
