"""Shared helpers of the benchmark's tests: cells cut to a size the CPU
runs in seconds, with the limits of their files."""

import pytest
import torch

from portbench import spec

TINY = {"cbox.render": {"resolution": [16, 16], "spp": 2},
        "cbox.grad": {"resolution": [16, 16]},
        "room.render": {"resolution": [12, 8], "spp": 1}}


def tiny_cell(name, pixels=64):
    """spec.cell(name) at TINY's size, comparing `pixels` pixels."""
    cell = spec.cell(name)
    cell["config_data"] = {**cell["config_data"], **TINY[name]}
    cell["limits"] = {**cell["limits"], "pixels": pixels}
    return cell


@pytest.fixture
def card():
    """Skip unless this process sees a CUDA device (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
