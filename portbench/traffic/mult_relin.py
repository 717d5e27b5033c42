"""BFV ``mult_relin`` on a batch of ciphertext pairs: the reference SDK's
measured operation (``benchmark_cpu.cpp``), through the program's entry
``parallel/batch.py`` ``make_batched_step(engine, bfv_mult_relin, ...)``.

The cell file gives the batch, the level and the BEHZ auxiliary rows the
multiply runs over at that level (the work functions' shape). The inputs are
B pairs of encryptions of uniform plaintext polynomials mod t, made once at
set-up and multiplied again at every step.
"""

import numpy as np

from portbench import fhe, work
from portbench.reference import bfv as ref
from portbench.reference import control as ctl


def messages(cfg: dict, cell: dict, seed: int):
    g = fhe.rng(seed, 2)
    shape = (cell['batch'], cfg['n'])
    return g.integers(0, cfg['t'], shape), g.integers(0, cfg['t'], shape)


def expected(cfg: dict, cell: dict, seed: int) -> np.ndarray:
    ma, mb = messages(cfg, cell, seed)
    return ref.negacyclic_mul(ma, mb, cfg['t'])


def control(cfg: dict, cell: dict, seed: int) -> np.ndarray:
    """The control in the place of the program's decrypted products: the
    reference's products held in int16, the integer type below the 17 bits
    that t = 65537 needs."""
    return ctl.int16(expected(cfg, cell, seed), cfg['t'])


def compare(cfg: dict, cell: dict, seed: int, got: np.ndarray) -> list[dict]:
    """Each ciphertext's plaintext against the reference's product: the
    coefficients that differ."""
    bad = (got != expected(cfg, cell, seed)).sum(axis=-1)
    return [{'wrong_coeffs': int(b)} for b in bad]


class Driver:
    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        from lattisense_torch.parallel.batch import bfv_mult_relin, key_tree, make_batched_step
        self.cfg, self.cell = cfg, cell
        self.batch, level = cell['batch'], cell['level']
        self.s = fhe.secret(seed, cfg)
        ma, mb = messages(cfg, cell, seed)
        ctx = fhe.bfv_context(cfg, seed, device, self.s)
        fhe.add_relin_key(ctx)
        self.a = fhe.stack([ctx.encrypt(ctx.encode_coeffs(m, level)) for m in ma])
        self.b = fhe.stack([ctx.encrypt(ctx.encode_coeffs(m, level)) for m in mb])
        self.keys = key_tree(ctx)
        self.ctx = ctx
        self.entry = make_batched_step(ctx.engine, bfv_mult_relin, level, 2)
        self.traced_entry = make_batched_step(ctx.engine, self._traced, level, 2)
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
            return engine.relinearize(d, keys['rlk'])

    def work(self) -> dict:
        B, L, n = self.batch, self.cell['level'] + 1, self.cfg['n']
        mult = work.bfv_mult_work(B, L, self.cell['aux_limbs'], n)
        ksw = work.bfv_relin_work(B, L, len(self.cfg['p']), n)
        return {'mult': mult, 'keyswitch': ksw, 'step': work.add(mult, ksw)}

    def release(self):
        del self.ctx, self.keys, self.a, self.b, self.entry, self.traced_entry

    def decrypted(self, out) -> np.ndarray:
        """A step's outputs decrypted by the reference with the run's
        secret: (B, n) plaintexts mod t."""
        return ref.decrypt(out, self.s, self.cfg['q'][:self.cell['level'] + 1], self.cfg['t'])
