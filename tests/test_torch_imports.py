"""Import guard: the port, its examples (``examples/*_torch.py``), its
tools (``tools/*.py``) and chip_smoke.py import nothing of JAX or of the
JAX package, and the port's entry points do not fall back to the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart_torch", "graph_analytics_suite_torch",
            "multi_query_service_torch", "distributed_pagerank_torch",
            "serve_lm_torch")
BENCH_FILES = sorted((ROOT / "benchmarks").glob("*_torch.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"] + \
    BENCH_FILES + sorted((ROOT / "tools").glob("*.py"))
BENCH_ENTRY_POINTS = (
    ("bench_algorithms_torch", "main", (8,)),
    ("bench_algorithms_torch", "multi_query", (8,)),
    ("bench_native_gap_torch", "main", (8,)),
    ("bench_optimizations_torch", "main", (8,)),
    ("bench_scaling_torch", "main", ()),
    ("run_torch", "main", ([],)),
    ("run_torch", "main", (["--device", "cuda", "--quick"],)))


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


def test_examples_import_with_jax_blocked():
  code = (
      "import importlib, sys\n"
      "for m in ('jax', 'jaxlib', 'repro'):\n"
      "  sys.modules[m] = None\n"
      f"sys.path.insert(0, {str(ROOT / 'examples')!r})\n"
      f"for name in {EXAMPLES!r}:\n"
      "  assert callable(importlib.import_module(name).main)\n"
      "assert not any(k.split('.')[0] in ('jax', 'repro') and v is not None\n"
      "               for k, v in sys.modules.items())\n")
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=120,
                        env={"PYTHONPATH": str(ROOT / "src"),
                             "PATH": "/usr/bin:/bin"})
  assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_a_card_unless_asked_for_cpu(name):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is valid")
  import importlib.util
  spec = importlib.util.spec_from_file_location(
      f"_example_{name}", ROOT / "examples" / f"{name}.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    mod.main([])


def _imports(path):
  """Every module name ``path`` imports (``from a import b`` gives ``a``
  and ``a.b``)."""
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module
      yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", BENCH_FILES,
                         ids=[p.name for p in BENCH_FILES])
def test_benchmarks_import_only_their_torch_siblings(path):
  """A harness file of the port imports ``benchmarks.*_torch`` and never a
  reference benchmark module (``benchmarks/common.py`` imports JAX)."""
  names = set(_imports(path))
  bench = {m for m in names if m.split(".")[0] == "benchmarks" and m != (
      "benchmarks")}
  assert all(m.split(".")[1].endswith("_torch") for m in bench), bench
  assert not [m for m in names if _forbidden(m)]


def test_benchmarks_import_with_jax_blocked():
  names = [p.stem for p in BENCH_FILES]
  assert set(names) >= {"common_torch", "bench_algorithms_torch",
                        "bench_native_gap_torch", "bench_optimizations_torch",
                        "run_torch", "bench_scaling_torch", "roofline_torch"}
  code = (
      "import importlib, sys\n"
      "for m in ('jax', 'jaxlib', 'repro'):\n"
      "  sys.modules[m] = None\n"
      f"for name in {names!r}:\n"
      "  importlib.import_module('benchmarks.' + name)\n"
      "bad = [k for k, v in sys.modules.items() if v is not None and (\n"
      "    k.split('.')[0] in ('jax', 'repro') or (\n"
      "        k.startswith('benchmarks.') and not k.endswith('_torch')))]\n"
      "assert not bad, bad\n")
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=120, cwd=ROOT,
                        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
                             "PATH": "/usr/bin:/bin"})
  assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module,fn,args", BENCH_ENTRY_POINTS,
                         ids=[f"{i}-{m}.{f}" for i, (m, f, _) in
                              enumerate(BENCH_ENTRY_POINTS)])
def test_benchmarks_need_a_card_unless_asked_for_cpu(module, fn, args):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is valid")
  import importlib
  mod = importlib.import_module(f"benchmarks.{module}")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    getattr(mod, fn)(*args)
