"""The controls of each cell at its own size: the reference's results one
precision below the configuration's (``portbench/reference/control.py``),
put in the place of the program's decrypted outputs and judged as a run's
are, by the traffic module's ``compare`` and the harness's ``decide``.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

One JSON line a seed: each compared number beside its limit, and whether
the control came out correct (it must not). Exits 1 where any seed's did.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import run as harness  # noqa: E402


def readings(name: str, seed: int, loaded=None) -> tuple[dict, bool]:
    """The control's compared numbers on ``seed`` and whether they pass."""
    _, cell, cfg = loaded or harness.load_cell(name)
    mod = harness.traffic(cell['op'])
    items = mod.compare(cfg, cell, seed, mod.control(cfg, cell, seed))
    compared, _, correct = harness.decide(cell, items)
    return compared, correct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)
    passed = False
    for seed in args.seeds:
        compared, correct = readings(args.workload, seed)
        passed = passed or correct
        print(json.dumps({'workload': args.workload, 'seed': seed, 'correct': correct,
                          'compared': compared}), flush=True)
    return 1 if passed else 0


if __name__ == '__main__':
    sys.exit(main())
