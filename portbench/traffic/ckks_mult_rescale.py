"""CKKS ``mult_relin_rescale`` on a batch of ciphertext pairs: the leveled
product an application runs between bootstraps (the reference SDK's
``benchmark_cpu.cpp`` CKKS op), through the program's entry
``make_batched_step(engine, ckks_mult_relin_rescale, level, 2, is_ntt=True)``.

The inputs are B pairs of encryptions, at the cell's level and the
configuration's scale Δ, of complex slots with parts uniform in [-1, 1).
The product's slots are a·b at the scale Δ²/q_level; every ciphertext of
the batch is judged.
"""

import numpy as np

from portbench import fhe, work
from portbench.reference import ckks as ref
from portbench.reference import control as ctl


def messages(cfg: dict, cell: dict, seed: int):
    g = fhe.rng(seed, 2)
    shape = (cell['batch'], cfg['slots'])
    a = g.uniform(-1, 1, shape) + 1j * g.uniform(-1, 1, shape)
    b = g.uniform(-1, 1, shape) + 1j * g.uniform(-1, 1, shape)
    return a, b


def control(cfg: dict, cell: dict, seed: int) -> np.ndarray:
    """The control in the place of the program's decoded products: the
    products computed in float16."""
    return ctl.float16_product(*messages(cfg, cell, seed))


def compare(cfg: dict, cell: dict, seed: int, got: np.ndarray) -> list[dict]:
    """Each ciphertext's slots against a·b: the widest gap."""
    a, b = messages(cfg, cell, seed)
    return [{'max_abs_err': float(e)} for e in np.abs(got - a * b).max(axis=-1)]


class Driver:
    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        from lattisense_torch.parallel.batch import (ckks_mult_relin_rescale, key_tree,
                                                     make_batched_step)
        self.cfg, self.cell = cfg, cell
        self.batch, level = cell['batch'], cell['level']
        self.s = fhe.secret(seed, cfg)
        ma, mb = messages(cfg, cell, seed)
        ctx = fhe.ckks_context(cfg, seed, device, self.s)
        fhe.add_relin_key(ctx)
        self.a = fhe.stack([ctx.encrypt(ctx.encode(m, level)) for m in ma])
        self.b = fhe.stack([ctx.encrypt(ctx.encode(m, level)) for m in mb])
        self.keys = key_tree(ctx)
        self.ctx = ctx
        self.entry = make_batched_step(ctx.engine, ckks_mult_relin_rescale, level, 2,
                                       is_ntt=True)
        self.traced_entry = make_batched_step(ctx.engine, self._traced, level, 2, is_ntt=True)
        self.spans = None

    def step(self):
        return self.entry(self.a, self.b, self.keys)

    def traced_step(self, spans):
        self.spans = spans
        return self.traced_entry(self.a, self.b, self.keys)

    def _traced(self, engine, a, b, keys):
        with self.spans('mult'):
            d = engine.mult(a, b)
        with self.spans('keyswitch'):
            d = engine.relinearize(d, keys['rlk'])
        return engine.rescale(d)

    def work(self) -> dict:
        B, L, n = self.batch, self.cell['level'] + 1, self.cfg['n']
        mult = work.ckks_mult_work(B, L, n)
        ksw = work.ckks_relin_work(B, L, len(self.cfg['p']), n)
        return {'mult': mult, 'keyswitch': ksw,
                'step': work.add(mult, ksw, work.ckks_rescale_work(B, L, n))}

    def release(self):
        del self.ctx, self.keys, self.a, self.b, self.entry, self.traced_entry

    def decrypted(self, out) -> np.ndarray:
        """A step's outputs decrypted by the reference with the run's secret
        and decoded at Δ²/q_level: (B, slots)."""
        level, cfg = self.cell['level'], self.cfg
        scale = float(cfg['scale']) ** 2 / cfg['q'][level]
        return ref.decrypt_decode(out, self.s, cfg['q'][:level], scale, cfg['slots'])
