"""Nothing of the benchmark imports JAX, Flax or the JAX package, and the
references import nothing of the program: top-level module names compared
whole (the port's own name begins with the JAX package's)."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from benchlib import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "distributed_tensorflow_framework_tpu"}
PORT = "distributed_tensorflow_framework_torch"
SOURCES = sorted(p for p in spec.HERE.rglob("*.py"))


def top_level_imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in top_level_imports(path)
    assert "benchlib" not in top_level_imports(path)


def test_reference_loads_alone():
    """Importing the references loads neither the program nor JAX."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import reference.bert, reference.resnet;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(spec.HERE)],
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert PORT not in loaded and not loaded & FORBIDDEN


def test_harness_leaves_jax_unloaded():
    """The harness's modules and the program they drive load no JAX."""
    code = ("import sys; sys.path[:0] = sys.argv[1:3];"
            "import run; from benchlib import cell, report;"
            "import distributed_tensorflow_framework_torch.train.loop;"
            "print(cell.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(spec.CHECKOUT),
                          str(spec.HERE)], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"


def test_a_late_import_of_jax_withholds_the_result(tmp_path):
    """A module that loads JAX after the ranks have returned (here a
    metric reader, run while the result line is built) leaves the run
    with exit code 3 and no result: the check is made again just before
    the result would be printed."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.CHECKOUT / "BENCHMARK.json").read_text())
    cell = "bert-base-mlm.s512-b96"
    (root / "benchmark" / "metrics" / "late_import.py").write_text(
        "def read(run):\n    import jax\n    return 1.0\n")
    bench["per_layer"].append({"name": "late_import", "unit": "1",
                               "better": "lower", "source": "host_clock",
                               "layer": "trainer loop and infeed",
                               "moves": "train_tokens_per_s",
                               "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    code = (
        "import sys; root = sys.argv[1];"
        "sys.path[:0] = [root + '/benchmark', root + '/benchmark/tests'];"
        "import run, tiny;"
        f"cell = {cell!r};"
        "sys.exit(run.finish(*run.run_cell(cell, tiny.SEED, 0.3, True,"
        " device='cpu', tiny=tiny.CELLS[cell])))")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(tmp_path / "stub"), str(spec.CHECKOUT)])}
    proc = subprocess.run([sys.executable, "-c", code, str(root)],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert proc.stdout == ""
    assert "forbidden modules loaded: jax" in proc.stderr
