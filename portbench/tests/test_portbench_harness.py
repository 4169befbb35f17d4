"""The harness end to end at a tiny size on the CPU, where the program's
kernels run as their plain twins, and its last line."""

import functools
import json

import pytest
import torch

from portbench import run
from portbench.tests.conftest import tiny_cell

SEED = 2**32 + 12345  # more than 32 bits


@pytest.mark.parametrize("name", ["cbox.render", "cbox.grad", "room.render"])
def test_tiny_run_is_correct(name):
    result, rows = run.run(name, SEED, 0.5, 0, device="cpu", cell=tiny_cell(name))
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert [k for k, _, _ in rows] == list(result["checks"])
    assert all(v <= lim for _, v, lim in rows)
    metrics = result["metrics"]
    assert "setup_s" in metrics and len(metrics) >= 2 and all(m["value"] > 0 for m in metrics.values())


def test_last_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run", functools.partial(run.run, device="cpu", cell=tiny_cell("cbox.render")))
    assert run.main(["--workload", "cbox.render", "--seed", str(SEED), "--seconds", "0.3", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in last] == list(result["checks"])
    assert all(" limit " in line for line in last)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "cbox.render", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_jax_loaded_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run", functools.partial(run.run, device="cpu", cell=tiny_cell("cbox.render")))
    monkeypatch.setitem(__import__("sys").modules, "take_tpu", object())
    assert run.main(["--workload", "cbox.render", "--seed", "5", "--seconds", "0.2", "--trace", "0"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "take_tpu" in err


MIXES = {
    "seed_per_image": ("cbox.render", {"seeds": "per_unit"}, {"images": 2}),
    "scene_per_step": ("cbox.grad", {"reload_scene": True}, {}),
    "two_walls_and_light": ("cbox.grad", {"params": {
        "red": {"target": "material", "material": "red", "param": "reflectance", "map": "sigmoid", "init": [0.4] * 3},
        "green": {"target": "material", "material": "green", "param": "reflectance", "map": "identity",
                  "init": [0.3, 0.5, 0.2]},
        "light": {"target": "lights", "map": "exp", "init": 0.7}}}, {}),
}


@pytest.mark.parametrize("mix", list(MIXES))
def test_tiny_run_of_a_mix_given_as_data(mix):
    """Traffic mixes that differ only in their data file run and come out correct."""
    name, traffic, limits = MIXES[mix]
    cell = tiny_cell(name)
    cell["traffic_data"] = {**cell["traffic_data"], **traffic}
    cell["limits"] = {**cell["limits"], **limits}
    result, rows = run.run(name, SEED, 0.5, 0, device="cpu", cell=cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1, rows
