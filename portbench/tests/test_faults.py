"""Each cell driven through a whole run on the CPU at a toy size (the
harness's look for a card skipped): sound, it is correct; with the timed
path broken underneath, ``correct`` comes out false."""

import pytest

from portbench import run as harness
from portbench.tests.conftest import toy

CELLS = ['bfv_w32_mult_relin_b32', 'bfv_w32_rotate_b32', 'ckks_btp_mult_rescale_b32']
SEED = 2 ** 33 + 17


def altered(out):
    """One residue of the first output changed where the step made it."""
    out = out.clone()
    out.view(-1)[out.numel() // 3] += 1
    return out


def half_left_out(out):
    """The second half of the batch never computed: the first half's
    outputs stand in its place."""
    out = out.clone()
    h = out.shape[0] // 2
    out[h:] = out[:h]
    return out


FAULTS = {'answer_altered': altered, 'half_the_batch_left_out': half_left_out,
          'input_returned': None}


def break_step(fault):
    def patch(drv):
        if fault == 'input_returned':
            data = drv.ct.data if hasattr(drv, 'ct') else drv.a
            drv.step = lambda: data
            drv.traced_step = lambda spans: data
            return
        step, traced = drv.step, drv.traced_step
        drv.step = lambda: FAULTS[fault](step())
        drv.traced_step = lambda spans: FAULTS[fault](traced(spans))
    return patch




@pytest.mark.parametrize('cell', CELLS)
def test_a_sound_run_is_correct(cell):
    line, compared = harness.run(cell, SEED, 0.01, cell.startswith('bfv'), device='cpu',
                                 loaded=toy(cell))
    assert line['correct'] and line['failed'] == 0, compared
    assert list(line)[-1] == 'compared'


@pytest.mark.parametrize('cell', CELLS)
def test_the_control_in_the_programs_place_is_not_correct(cell):
    """The reference one precision down stands in for what the reference
    decrypts from the program's outputs; the run judges it as it judges
    the program's, and ``correct`` comes out false."""
    bench, c, cfg = toy(cell)
    mod = harness.traffic(c['op'])

    def patch(drv):
        drv.decrypted = lambda out: mod.control(cfg, c, SEED)
    line, compared = harness.run(cell, SEED, 0.01, False, device='cpu', loaded=(bench, c, cfg),
                                 patch=patch)
    assert not line['correct'] and line['failed'] > 0, compared


@pytest.mark.parametrize('cell,fault', [(c, f) for c in CELLS for f in FAULTS])
def test_a_broken_step_is_not_correct(cell, fault):
    line, compared = harness.run(cell, SEED, 0.01, False, device='cpu', loaded=toy(cell),
                                 patch=break_step(fault))
    assert not line['correct'], compared
