"""Import guard: the port and chip_smoke.py import nothing of JAX or of the
JAX package, and the port's entry points do not fall back to the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
  return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      bad = [a.name for a in node.names if _forbidden(a.name)]
    elif isinstance(node, ast.ImportFrom):
      bad = [node.module] if node.module and _forbidden(node.module) else []
    else:
      continue
    assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_port_imports_with_jax_blocked():
  code = (
      "import sys\n"
      "for m in ('jax', 'jaxlib', 'repro'):\n"
      "  sys.modules[m] = None\n"
      "import repro_torch, repro_torch.core, repro_torch.graphs\n"
      "import repro_torch.kernels.ops, repro_torch.algos, repro_torch.service\n"
      "import repro_torch.models, repro_torch.serve, repro_torch.configs\n"
      "import repro_torch.kernels.selective_scan, repro_torch.algos.native\n"
      "import repro_torch.models.moe\n"
      "import repro_torch.train, repro_torch.train.checkpoint\n"
      "import repro_torch.launch, repro_torch.launch.train\n"
      "import repro_torch.launch.mesh, repro_torch.launch.specs\n"
      "import repro_torch.launch.dryrun, repro_torch.analysis\n"
      "import repro_torch.models.sharding\n"
      "from repro_torch.models.transformer import build_model\n"
      "for name in repro_torch.configs.ARCHITECTURES:\n"
      "  build_model(repro_torch.configs.get_config(name)).defs()\n"
      "assert not any(k.split('.')[0] in ('jax', 'repro') and v is not None\n"
      "               for k, v in sys.modules.items())\n")
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=120,
                        env={"PYTHONPATH": str(ROOT / "src"),
                             "PATH": "/usr/bin:/bin"})
  assert proc.returncode == 0, proc.stderr


def test_entry_points_need_a_card_unless_asked_for_cpu():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is valid")
  from repro_torch.core import graph as TG
  src = np.array([0, 1], np.int32)
  dst = np.array([1, 0], np.int32)
  for build in (TG.build_coo, TG.build_ell, TG.build_dense):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      build(src, dst, n=2)
    assert build(src, dst, n=2, device="cpu").device.type == "cpu"
  g = TG.build_coo(src, dst, n=2, device="cpu")
  with pytest.raises(RuntimeError, match="CUDA"):
    g.to("cuda")

  from repro_torch import configs
  from repro_torch.models.common import init_params
  from repro_torch.models.transformer import build_model
  model = build_model(configs.get_smoke_config("falcon_mamba_7b"))
  gen = torch.Generator().manual_seed(0)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    init_params(model.defs(), gen)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    model.init_cache(2, 8)
  params = init_params(model.defs(), gen, device="cpu")
  assert params["embed"].device.type == "cpu"
  assert model.init_cache(2, 8, device="cpu")["h"].device.type == "cpu"
