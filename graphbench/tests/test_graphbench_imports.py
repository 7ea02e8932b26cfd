"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (``repro_torch`` passes, ``repro`` does not), the
plain reference imports nothing of the port, and only ``port.py`` and the
containers import the port."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCES = sorted(p for p in (ROOT / "graphbench").rglob("*.py")
                 if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_names(path: pathlib.Path):
  tree = ast.parse(path.read_text(), str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split(".")[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
  assert not set(top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "graphbench" / "reference")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_no_port(path):
  assert "repro_torch" not in set(top_names(path))


def test_only_port_imports_the_program():
  """``port.py`` and the containers under ``containers/``, and nothing
  else of the benchmark."""
  here = ROOT / "graphbench"
  importers = {p.relative_to(here) for p in SOURCES
               if "repro_torch" in set(top_names(p))}
  containers = {p for p in importers if p.parts[0] == "containers"}
  assert importers - containers == {pathlib.Path("port.py")}
  assert pathlib.Path("containers", "triangles.py") in containers


def test_whole_name_rule(tmp_path):
  probe = tmp_path / "probe.py"
  probe.write_text("import repro_torch.core\nfrom repro_torch import algos\n")
  assert not set(top_names(probe)) & FORBIDDEN
  probe.write_text("import repro.core\n")
  assert set(top_names(probe)) & FORBIDDEN == {"repro"}


def test_forbidden_modules_by_whole_name(monkeypatch):
  import sys
  from graphbench import cell
  monkeypatch.setitem(sys.modules, "repro_torch_like", object())
  assert "repro" not in cell.forbidden_modules()
  monkeypatch.setitem(sys.modules, "repro", object())
  assert "repro" in cell.forbidden_modules()
