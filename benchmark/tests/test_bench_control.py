"""The control (the reference in the program's place, one step below the
configuration's precision) fails the cell's check, here at a tiny size on
the CPU; on the card at each cell's own size it is read by
``benchmark/calibrate.py``, and the test marked ``cuda`` reads three seeds
of each train cell and of the DS-RNN fixture there."""

import pytest
import torch

from conftest import SRNN, need_card, tiny_config, tiny_mix
import calibrate
from harness import spec

CELLS = ["flagship-train", "config5-train", "flagship-eval", "flagship-gym",
         SRNN]


def _fails(cell, readings, root=None):
    limits = spec.load_cell(cell, *([root] if root else [])).limits
    prog, ctrl = readings["program"], readings["control"]
    return [k for k in limits if ctrl[k] > limits[k] and ctrl[k] > 3 * prog[k]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_a_tiny_size(cell, tmp_path, all_cells):
    r = calibrate.readings(cell, 1618033988, 1.0, torch.device("cpu"), (),
                           config_path=tiny_config(cell, tmp_path, all_cells),
                           mix_overrides=tiny_mix(cell, all_cells),
                           root=all_cells)
    assert _fails(cell, r, all_cells), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["flagship-train", "config5-train", SRNN])
def test_control_fails_on_the_card(cell, all_cells):
    need_card()
    for seed in (11, 12, 13):
        r = calibrate.readings(cell, seed, 1.0, torch.device("cuda", 0), (),
                               root=all_cells)
        assert _fails(cell, r, all_cells), r
