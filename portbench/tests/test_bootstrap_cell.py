"""The cell ``ckks_btp_full_b4`` at a toy size on the CPU: a whole run through
the harness on Lattigo's settings cut to n = 256 and a chain whose residual
part is two primes (so the published plan's 15 levels leave level 1), the
float8-e4m3 control in the program's place, and the pieces of the cell's
yardstick: the DFT groups the work count reads against the program's own
matrices, and the published plan's level budget."""

import numpy as np
import pytest

from portbench import run as harness
from portbench.reference import bootstrap as ref_btp

CELL = 'ckks_btp_full_b4'
SEED = 2 ** 33 + 23


def toy():
    """The cell at n = 256 with the chain's q0, one 40-bit prime and the 15
    primes the bootstrap spends: output level 1, two ciphertexts."""
    bench, cell, cfg = harness.load_cell(CELL)
    cfg = dict(cfg, n=256, slots=128, q=cfg['q'][:2] + cfg['q'][10:], bootstrap_output_level=1)
    cell = dict(cell, batch=2, limits=dict(cell['limits'], output_level={'min': 1}))
    return bench, cell, cfg


def test_the_configuration_is_the_programs_full_profile():
    """The bootstrap's deployment has its own file and source, and every
    number of the leveled product's: the same chain, secrets and settings,
    which are the program's ``full_profile()``."""
    import json
    import os
    from lattisense_torch.schemes.bootstrap_params import full_profile
    _, _, cfg = harness.load_cell(CELL)
    leveled = json.load(open(os.path.join(harness.HERE, 'configs', 'ckks_btp_n64k.json')))
    words = {'name', 'source', 'source_part', 'guarantees', 'deployment'}
    assert cfg['name'] != leveled['name'] and cfg['source'] != leveled['source']
    assert set(cfg) == set(leveled)
    assert {k: v for k, v in cfg.items() if k not in words} == {
        k: v for k, v in leveled.items() if k not in words}
    prof = full_profile()
    assert (cfg['n'], cfg['slots'], cfg['bootstrap_output_level']) == (
        prof.n, prof.slots, prof.btp_output_level)
    assert cfg['reduced'] == []


def test_the_budget_is_lattigos():
    _, _, cfg = harness.load_cell(CELL)
    levels = ref_btp.published_levels(cfg['bootstrap'])
    assert levels == {'raise': 0, 'cts': 4, 'evalmod': 8, 'stc': 3}
    assert len(cfg['q']) - 1 - sum(levels.values()) == cfg['bootstrap_output_level'] == 9


@pytest.mark.parametrize('trace', [False, True])
def test_a_toy_run_is_correct(trace):
    line, compared = harness.run(CELL, SEED, 0.01, trace, device='cpu', loaded=toy())
    assert line['correct'] and line['failed'] == 0, compared
    assert compared['output_level']['value'] >= 1
    assert compared['max_abs_err']['value'] < 1e-3
    assert list(line)[-1] == 'compared'


def test_the_float8_control_is_not_correct():
    bench, cell, cfg = toy()
    mod = harness.traffic(cell['op'])
    compared, _, correct = harness.decide(cell, mod.compare(cfg, cell, SEED,
                                                            mod.control(cfg, cell, SEED)))
    assert not correct and compared['max_abs_err']['value'] > 1e-2
    assert compared['output_level']['value'] >= cell['limits']['output_level']['min']

    def patch(drv):
        drv.decrypted = lambda out: mod.control(cfg, cell, SEED)
    line, compared = harness.run(CELL, SEED, 0.01, False, device='cpu', loaded=(bench, cell, cfg),
                                 patch=patch)
    assert not line['correct'] and line['failed'] == cell['batch'], compared


@pytest.mark.parametrize('cts,depth', [(True, 4), (False, 3), (True, 3)])
def test_dft_groups_are_the_programs(cts, depth):
    """The groups' diagonal offsets and BSGS split, counted from the
    parameters, are those of the program's special-FFT matrices at s=128."""
    from lattisense_torch.schemes.bootstrap_params import find_best_bsgs_split
    from lattisense_torch.schemes.special_fft import cts_matrices, stc_matrices
    s = 128
    groups = (cts_matrices if cts else stc_matrices)(s, depth)
    for g, want in zip(groups, ref_btp.dft_groups(s, depth, cts, 2.0)):
        n1 = find_best_bsgs_split({o: True for o in g}, s, 2.0)
        assert (len(g), n1) == (want['diagonals'], want['n1'])
        assert want['babies'] == len({o % n1 for o in g} - {0})
        assert want['giants'] == len({(o // n1) * n1 for o in g} - {0})


@pytest.mark.parametrize('degree', [7, 15, 30])
def test_chebyshev_products_land_on_the_budget(degree):
    """Every product of the published plan's series sits within its
    ⌈log2(deg+1)⌉ levels; at the configuration's degree 30 the series and
    its three double angles are sin(2π·2K·2^r·y) on [-2^-(r+1), 2^-(r+1)]
    to 1.3e-8 (the fit's own error, amplified by the doublings)."""
    ops = ref_btp.chebyshev_products(degree)
    depth = ref_btp.chebyshev_depth(degree)
    assert all(-depth < lv <= 0 for k in ops for lv in ops[k])
    assert len(ops['mult']) >= depth
    y = np.linspace(-1 / 16, 1 / 16, 2001)
    assert np.abs(ref_btp.evalmod(y, 16, 3, 30) - np.sin(2 * np.pi * 256 * y)).max() < 1e-7


def test_the_work_counts_every_stage():
    from portbench.traffic import ckks_bootstrap as drv
    _, cell, cfg = harness.load_cell(CELL)
    one = drv.bootstrap_work(cfg, 1)
    four = drv.bootstrap_work(cfg, 4)
    assert 0 < one[0] < four[0] and 3.5 * one[1] < four[1] < 4.01 * one[1]
