"""CKKS bootstrapping of a batch of ciphertexts at the configuration's
bootstrapping settings, under the level plan the cell names, through the
program's entry ``make_batched_step(engine, ckks_bootstrap, level, 1,
is_ntt=True)`` on a context made by ``CkksBtpContext.create_random_context``.

The benchmark brings both secrets: the dense one of ``fhe.secret`` (the
reference decrypts with it) and the ephemeral sparse one of the
configuration's ``bootstrap_secret_weight``, drawn from the seed's stream 3;
the program bridges them with its two switching keys. The inputs are B fresh
encryptions at the cell's level and the configuration's scale of complex
slots with parts uniform in [-1, 1), made once. Each output is judged by its
widest slot gap from its input's message and by its level.
"""

import numpy as np

from portbench import fhe, work
from portbench.reference import bootstrap as ref_btp
from portbench.reference import ckks as ref


def secrets(cfg: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(dense, sparse): the run's secret and the ephemeral bootstrapping
    secret, ``bootstrap_secret_weight`` positions of random sign."""
    g, n, h = fhe.rng(seed, 3), cfg['n'], cfg['bootstrap_secret_weight']
    sparse = np.zeros(n, dtype=np.int64)
    sparse[g.choice(n, size=h, replace=False)] = g.choice(np.array([-1, 1], dtype=np.int64),
                                                          size=h)
    return fhe.secret(seed, cfg), sparse


def messages(cfg: dict, cell: dict, seed: int) -> np.ndarray:
    g = fhe.rng(seed, 2)
    shape = (cell['batch'], cfg['slots'])
    return g.uniform(-1, 1, shape) + 1j * g.uniform(-1, 1, shape)


def control(cfg: dict, cell: dict, seed: int) -> dict:
    """The control in the place of the program's decoded outputs: the
    messages rounded through float8-e4m3, at the level the configuration
    guarantees."""
    return {'slots': ref_btp.float8_e4m3(messages(cfg, cell, seed)),
            'level': cfg['bootstrap_output_level']}


def compare(cfg: dict, cell: dict, seed: int, got: dict) -> list[dict]:
    """Each ciphertext's widest slot gap from its message, and the level it
    came out at."""
    gap = np.abs(got['slots'] - messages(cfg, cell, seed)).max(axis=-1)
    return [{'max_abs_err': float(e), 'output_level': int(got['level'])} for e in gap]


class Driver:
    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        from lattisense_torch.schemes.bootstrap import BootstrapConfig
        # first: a program without the cell's plan refuses it here, at once
        btp_cfg = BootstrapConfig(**cfg['bootstrap'], level_plan=cell['level_plan'])
        from lattisense_torch.params import CkksParams
        from lattisense_torch.parallel.batch import ckks_bootstrap, key_tree, make_batched_step
        from lattisense_torch.runtime.context import CkksBtpContext
        self.cfg, self.cell = cfg, cell
        self.batch, level = cell['batch'], cell['level']
        self.s, sparse = secrets(cfg, seed)
        params = CkksParams.create_custom(cfg['n'], cfg['q'], cfg['p'], slots=cfg['slots'],
                                          scale=float(cfg['scale']),
                                          word_bits=cfg['word_bits'])
        ctx = CkksBtpContext.create_random_context(
            params, seed, h=cfg['bootstrap_secret_weight'], btp_config=btp_cfg, device=device,
            secret=self.s, sparse_secret=sparse, output_level=cfg['bootstrap_output_level'])
        self.a = fhe.stack([ctx.encrypt(ctx.encode(m, level))
                            for m in messages(cfg, cell, seed)])
        btp = ctx.engine.bootstrapper
        self.keys = dict(key_tree(ctx, btp.galois_elements()), swk=dict(ctx.swk))
        self.ctx = ctx
        self.entry = make_batched_step(ctx.engine, ckks_bootstrap, level, 1, is_ntt=True)

    def step(self):
        return self.entry(self.a, self.keys)

    def traced_step(self, spans):
        with spans('bootstrap'):
            return self.entry(self.a, self.keys)

    def work(self) -> dict:
        return {'step': bootstrap_work(self.cfg, self.batch)}

    def release(self):
        del self.ctx, self.keys, self.a, self.entry

    def decrypted(self, out) -> dict:
        """A step's outputs decrypted by the reference with the run's secret
        at the level they came out at, decoded at the input's scale:
        {'slots': (B, slots), 'level'}."""
        level = out.shape[-2] - 1
        slots = ref.decrypt_decode(out, self.s, self.cfg['q'][:level + 1],
                                   float(self.cfg['bootstrap_input']['scale']),
                                   self.cfg['slots'])
        return {'slots': slots, 'level': level}


# ---- the bootstrap's least work ---------------------------------------------

def _key_switch(B: int, L: int, alpha: int, n: int, hoisted: bool = False):
    """One key switch of B ciphertexts at L limbs (``work.ckks_relin_work``);
    ``hoisted``: the decomposition and mod-up left out, paid once a group by
    ``_modup``, and only the key and the two outputs read and written."""
    nbytes, ops = work.ckks_relin_work(B, L, alpha, n)
    if not hoisted:
        return nbytes, ops
    beta, T = -(-L // alpha), L + alpha
    return 8.0 * n * (beta * 2 * T + 2 * B * L), ops - _modup(B, L, alpha, n)[1]


def _modup(B: int, L: int, alpha: int, n: int):
    """The decomposition of c1 into β digits raised to Q ∪ P in the NTT
    domain: the first four terms of ``work.ckks_relin_work``."""
    beta, T = -(-L // alpha), L + alpha
    return (8.0 * B * L * n, work.add(
        work.ntt64_work(B * L, L, n, True),
        (0.0, float(B * beta * alpha * n * work.OPS64_MONT)),
        work.bconv64_work(B * beta, alpha, T - alpha, n),
        work.ntt64_work(B * beta * T, T, n, False))[1])


def _product(B: int, L: int, alpha: int, n: int):
    """Two ciphertexts multiplied, relinearized and rescaled at L limbs."""
    return work.add(work.ckks_mult_work(B, L, n), work.ckks_relin_work(B, L, alpha, n),
                    work.ckks_rescale_work(B, L, n))


def _const(B: int, L: int, n: int, count: int = 1):
    """``count`` plaintext products of B ciphertexts at L limbs, summed:
    each plaintext read once and each product a modular product and add a
    coefficient of both components."""
    return 8.0 * count * L * n, float(count * 2 * B * L * n * (work.OPS64_MONT
                                                              + work.OPS64_ADDSUB))


def _transform(B: int, L: int, alpha: int, n: int, group: dict):
    """One group of a DFT at L limbs: one mod-up for its hoisted babies,
    each baby's switch, each giant's whole switch, a plaintext product a
    diagonal, and the rescale."""
    return work.add(_modup(B, L, alpha, n),
                    *[_key_switch(B, L, alpha, n, hoisted=True)] * group['babies'],
                    *[_key_switch(B, L, alpha, n)] * group['giants'],
                    _const(B, L, n, group['diagonals']),
                    work.ckks_rescale_work(B, L, n))


def bootstrap_work(cfg: dict, B: int):
    """The least (bytes, 32-bit operations) of a bootstrap of B ciphertexts
    under the published plan, from the configuration alone: the two
    switching keys and ModRaise, CoeffsToSlots (its last group twice, with a
    conjugation each for the split), EvalMod on both halves (the
    Chebyshev basis and series, the double angles), the merge (one
    plaintext product) and SlotsToCoeffs, every key switch at its level."""
    b, n, alpha, slots = cfg['bootstrap'], cfg['n'], len(cfg['p']), cfg['slots']
    top = len(cfg['q']) - 1
    parts = [work.ckks_relin_work(B, 1, alpha, n),
             work.ntt64_work(2 * B, 1, n, True), work.ntt64_work(2 * B * (top + 1), top + 1, n,
                                                                  False),
             work.ckks_relin_work(B, top + 1, alpha, n)]
    lv = top
    cts = ref_btp.dft_groups(slots, b['cts_depth'], True, b['bsgs_ratio'])
    for i, g in enumerate(cts):
        for _ in range(2 if i == len(cts) - 1 else 1):
            parts.append(_transform(B, lv + 1, alpha, n, g))
        lv -= 1
    parts += [_key_switch(B, lv + 1, alpha, n)] * 2
    cheb = ref_btp.chebyshev_products(b['sine_deg'])
    parts += [_product(2 * B, lv + 1 + d, alpha, n) for d in cheb['mult']]
    parts += [_const(2 * B, lv + 1 + d, n) for d in cheb['const']]
    parts += [work.ckks_rescale_work(2 * B, lv + 1 + d, n) for d in cheb['rescale']]
    lv -= ref_btp.chebyshev_depth(b['sine_deg'])
    for _ in range(b['double_angle']):
        parts.append(_product(2 * B, lv + 1, alpha, n))
        lv -= 1
    parts.append(_const(B, lv + 1, n))
    for g in ref_btp.dft_groups(slots, b['stc_depth'], False, b['bsgs_ratio']):
        parts.append(_transform(B, lv + 1, alpha, n, g))
        lv -= 1
    return work.add(*parts)
