"""BFV ``rotate_col`` on a batch of ciphertexts: the Galois automorphism of
a column rotation by the cell's ``step`` and its key switch, through the
program's entry ``make_batched_step(engine, make_rotate_step(elt), ...)``
with ``elt = galois_elt_col(step, n)``.

The configuration states the column rotations' generator g; rotating by
``step`` maps each plaintext polynomial m(X) to m(X^(g^step mod 2n)), which
the reference works out on the coefficients. Only that rotation's Galois
key is made.
"""

import numpy as np

from portbench import fhe, work
from portbench.reference import bfv as ref
from portbench.reference import control as ctl


def messages(cfg: dict, cell: dict, seed: int):
    return fhe.rng(seed, 2).integers(0, cfg['t'], (cell['batch'], cfg['n']))


def expected(cfg: dict, cell: dict, seed: int) -> np.ndarray:
    g = pow(cfg['galois_generator'], cell['step'], 2 * cfg['n'])
    return ref.automorphism(messages(cfg, cell, seed), g, cfg['t'])


def control(cfg: dict, cell: dict, seed: int) -> np.ndarray:
    """The control in the place of the program's decrypted rotations: the
    reference's rotated plaintexts held in int16, the integer type below
    the 17 bits that t = 65537 needs."""
    return ctl.int16(expected(cfg, cell, seed), cfg['t'])


def compare(cfg: dict, cell: dict, seed: int, got: np.ndarray) -> list[dict]:
    """Each ciphertext's plaintext against the reference's rotation: the
    coefficients that differ."""
    bad = (got != expected(cfg, cell, seed)).sum(axis=-1)
    return [{'wrong_coeffs': int(b)} for b in bad]


class Driver:
    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        from lattisense_torch.parallel.batch import make_batched_step, make_rotate_step
        from lattisense_torch.schemes.galois import galois_elt_col
        self.cfg, self.cell = cfg, cell
        self.batch, level = cell['batch'], cell['level']
        self.s = fhe.secret(seed, cfg)
        ctx = fhe.bfv_context(cfg, seed, device, self.s)
        elt = galois_elt_col(cell['step'], cfg['n'])
        ctx.gen_galois_keys_for_elements([elt])
        self.a = fhe.stack([ctx.encrypt(ctx.encode_coeffs(m, level))
                            for m in messages(cfg, cell, seed)])
        self.keys = {'glk': {elt: ctx.glk.keys[elt]}}
        self.ctx, self.elt = ctx, elt
        self.entry = make_batched_step(ctx.engine, make_rotate_step(elt), level, 1)
        self.traced_entry = make_batched_step(ctx.engine, self._traced, level, 1)
        self.spans = None

    def step(self):
        return self.entry(self.a, self.keys)

    def traced_step(self, spans):
        self.spans = spans
        return self.traced_entry(self.a, self.keys)

    def _traced(self, engine, a, keys):
        with self.spans('keyswitch'):
            return engine.apply_galois(a, self.elt, keys['glk'][self.elt])

    def work(self) -> dict:
        B, L, n = self.batch, self.cell['level'] + 1, self.cfg['n']
        ksw = work.bfv_rotate_work(B, L, len(self.cfg['p']), n)
        return {'keyswitch': ksw, 'step': ksw}

    def release(self):
        del self.ctx, self.keys, self.a, self.entry, self.traced_entry

    def decrypted(self, out) -> np.ndarray:
        """A step's outputs decrypted by the reference with the run's
        secret: (B, n) plaintexts mod t."""
        return ref.decrypt(out, self.s, self.cfg['q'][:self.cell['level'] + 1], self.cfg['t'])
