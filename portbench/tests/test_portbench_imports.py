"""The check for JAX compares whole top-level module names, and neither the
harness nor its reference imports JAX, the JAX package or, for the
reference, anything of the program."""

import ast
import sys

import pytest

from portbench import run, spec


def test_whole_top_level_names(monkeypatch):
    for name in ("take_tpu_torch", "take_tpu_torch.render", "jax_like", "flaxen", "jaxlibx"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    for name, top in (("take_tpu.render", "take_tpu"), ("jaxlib.xla", "jaxlib"), ("flax", "flax")):
        monkeypatch.setitem(sys.modules, name, object())
        assert top in run.forbidden_modules()


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(spec.HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(spec.HERE)))
def test_sources_import_no_jax(path):
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "take_tpu", "benchmarks"}
    if "reference" in path.parts:
        assert "take_tpu_torch" not in found
