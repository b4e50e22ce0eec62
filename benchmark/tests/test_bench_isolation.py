"""Nothing under ``benchmark/`` loads JAX or the JAX package, and the plain
reference loads nothing of the program: by the imports in the sources and
by ``sys.modules`` in a fresh interpreter. Top-level names are compared
whole (``tcs_tpu_torch`` starts with ``tcs_tpu``)."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tcs_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub: str = ""):
    return [p for p in (ROOT / "benchmark" / sub).rglob("*.py") if "__pycache__" not in p.parts]


def test_sources_import_no_jax():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_reference_and_count_import_nothing_of_the_program():
    for sub in ("reference", "flops"):
        for path in _sources(sub):
            assert "tcs_tpu_torch" not in set(_imports(path)), path.relative_to(ROOT)


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_modules_after_importing_the_harness():
    loaded = _loaded_after(
        "import importlib.util, pathlib\n"
        "spec = importlib.util.spec_from_file_location('bench_run', 'benchmark/run.py')\n"
        "run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)\n"
        "run._environment()\n"
        "from benchmark.lib import harness, port, control, readings, trace\n"
        "for sub in ('drivers', 'metrics'):\n"
        "    for p in sorted((harness.BENCH / sub).glob('*.py')):\n"
        "        harness.load_module(p)\n"
        "import tcs_tpu_torch.evaluate, tcs_tpu_torch.train\n")
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_alone_loads_no_program():
    loaded = _loaded_after("import benchmark.reference.model, benchmark.reference.train, "
                           "benchmark.reference.stream, benchmark.flops.count")
    assert "tcs_tpu_torch" not in loaded and not loaded & FORBIDDEN
