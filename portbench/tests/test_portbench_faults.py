"""Each fault a cell can have, planted under the timed path, makes a run
come out not correct; the harness skips its look for a card and runs the
rest at a tiny size on the CPU."""

import pytest

from portbench import faults, run
from portbench.tests.conftest import tiny_cell

CASES = [("cbox.render", f) for f in faults.KINDS["render"]] + [("cbox.grad", f) for f in faults.KINDS["grad"]]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    with faults.plant(fault):
        result, _ = run.run(name, 2**31 + 1, 0.3, 0, device="cpu", cell=tiny_cell(name))
    assert result["correct"] is False
