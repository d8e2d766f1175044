"""The control: the reference put in the program's place, computed in the
precision below the configuration's (bfloat16 for float32; float8
operands on bfloat16 for bfloat16), has to come out not correct.

On the card, at each cell's own size and on three seeds, every control run
fails one of the cell's limits (``limits/<workload>.json``).  On the CPU,
at the test sizes, the control reads far above the program on the same
seed, in every number that the two share.
"""

import json

import pytest

from gpubench.core import readings, spec
from gpubench.tests.drive import FIXTURES, TEST_CONFIG

CELLS = [w['name'] for w in spec.benchmark()['workloads']]


def _cell(workload, test_size):
    cell = spec.cell(workload, spec.benchmark())
    cfg = cell['config']
    if test_size:
        cfg = json.loads((FIXTURES / f"{TEST_CONFIG[cfg['name']]}.json").read_text())
    return cell, cfg


@pytest.mark.parametrize('workload', CELLS)
def test_control_reads_above_the_program(workload):
    cell, cfg = _cell(workload, test_size=True)
    prog = readings.program_reading(cell, cfg, 7, 'cpu')
    ctl = readings.control_reading(cell, cfg, 7, 'cpu')
    for name in ('step_err', 'map_err', 'overlay_err'):
        if name in prog:
            assert ctl[name] > 10 * max(prog[name], 1e-7), (name, prog[name], ctl[name])


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_control_fails_a_limit_on_the_card(workload, card):
    cell, cfg = _cell(workload, test_size=False)
    limits = cell['limits']['limits']
    for seed in (201, 202, 203):
        nums = readings.control_reading(cell, cfg, seed, card)
        assert any(nums.get(k, 0.0) > v for k, v in limits.items()), (seed, nums)
