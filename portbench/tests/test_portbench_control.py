"""The control, the reference in bfloat16 put in the program's place, fails
each cell's limits: at a small size here, at the cell's own size on the card."""

import pytest

from portbench import calibrate, checks, spec
from portbench.tests.conftest import tiny_cell


def _fails(cell, numbers):
    return not checks.judge(numbers, cell["limits"]["limits"])[0]


@pytest.mark.parametrize("name", ["cbox.render", "cbox.grad"])
@pytest.mark.parametrize("seed", [2**31 + 3, 2**31 + 5, 2**31 + 7])
def test_control_fails_small(name, seed):
    cell = tiny_cell(name, pixels=256)
    assert _fails(cell, calibrate.control_numbers(cell, seed, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cbox.render", "cbox.grad", "room.render"])
def test_control_fails_full_size(card, name):
    cell = spec.cell(name)
    for seed in (2**31 + 3, 2**31 + 5, 2**31 + 7):
        assert _fails(cell, calibrate.control_numbers(cell, seed, card))
