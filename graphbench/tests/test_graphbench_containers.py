"""A configuration's container found by name: ``graph`` and ``ratings``
from ``port.CONTAINERS``, any other from ``containers/<name>.py``, so a
later configuration brings its container as a new file."""

import pytest

import graphbench.containers
from graphbench import cell as cell_mod
from graphbench import manifest, port
from graphbench.containers import triangles


@pytest.mark.parametrize("name", ["graph", "ratings"])
def test_port_containers_first(name):
  assert cell_mod.container(name) is port.CONTAINERS[name]


def test_triangles_by_name():
  assert cell_mod.container("triangles") is triangles.Container
  assert "triangles" not in port.CONTAINERS


@pytest.mark.parametrize("config", manifest.load()["configs"],
                         ids=lambda c: c["name"])
def test_every_configuration_resolves(config):
  body = manifest.read_json(manifest.ROOT / config["file"])
  assert callable(cell_mod.container(body["container"]))


def test_a_new_container_is_a_new_file(tmp_path, monkeypatch):
  """A module dropped beside the others is found with no other edit."""
  (tmp_path / "probe_container.py").write_text(
      "class Container:\n"
      "  def __init__(self, config, data, device):\n"
      "    self.config, self.data = config, data\n")
  monkeypatch.setattr(graphbench.containers, "__path__",
                      [*graphbench.containers.__path__, str(tmp_path)])
  monkeypatch.delitem(__import__("sys").modules,
                      "graphbench.containers.probe_container", raising=False)
  cell = {"config": {"container": "probe_container", "k": 1}}
  got = cell_mod.make_port(cell, {"n": 3}, "cpu")
  assert type(got).__name__ == "Container"
  assert got.config["k"] == 1 and got.data == {"n": 3}


def test_unknown_container_fails():
  with pytest.raises(ModuleNotFoundError):
    cell_mod.container("no_such_container")
