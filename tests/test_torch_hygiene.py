"""Boundaries of the PyTorch port: it imports no JAX and nothing of the JAX
package, its entry points refuse to run without CUDA unless asked for the
CPU, and chip_smoke.py fails (printing no result) where there is no card
or no repository around it."""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from distributed_tensorflow_framework_torch.core import device as dev
from distributed_tensorflow_framework_torch.core.config import (
    ModelConfig,
    load_config,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "distributed_tensorflow_framework_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "distributed_tensorflow_framework_tpu")
TINY = ["model.vocab_size=100", "model.hidden_size=32", "model.num_layers=1",
        "model.num_heads=1", "model.mlp_dim=64", "model.max_seq_len=64",
        "data.seq_len=64", "model.dtype=float32"]


# The driver runs this suite on six xdist workers over a few cores; at
# torch's default, one intra-op thread a core, each worker's OpenMP
# threads spin against the other workers' and the suite takes about twice
# as long. The port's test modules take this autouse fixture (imported
# from here): TORCH_THREADS threads while a module runs, the worker's own
# count again after it. Two modules keep the default count:
# tests/test_torch_batchnorm.py, whose one-device f32 bound holds for the
# reduction order of that count (it missed it at 2 threads), and
# tests/test_torch_remat.py, whose remat-against-plain step is compared
# bit for bit (equal in every run at the default count, one miss in four
# full runs at 2 threads).
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not (
                node.level):
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_sources_are_found():
    names = {p.name for p in _port_sources()}
    assert {"flash_attention.py", "engine.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text())))
    assert not roots & set(FORBIDDEN), sorted(roots & set(FORBIDDEN))


def test_port_imports_with_jax_blocked():
    """Importing the port's entry points with ``sys.modules["jax"] =
    None`` (any ``import jax`` then fails) succeeds, and pulls in no module
    of the JAX package."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'orbax'):\n"
        "    sys.modules[name] = None\n"
        "import distributed_tensorflow_framework_torch.cli.serve\n"
        "import distributed_tensorflow_framework_torch.cli.train\n"
        "import distributed_tensorflow_framework_torch.cli.train_cluster\n"
        "import distributed_tensorflow_framework_torch.cli.train_resilient\n"
        "import distributed_tensorflow_framework_torch.cli.launch_local_cluster\n"
        "import distributed_tensorflow_framework_torch.cli.fleet\n"
        "import distributed_tensorflow_framework_torch.serve.fleet\n"
        "import distributed_tensorflow_framework_torch.train.loop\n"
        "import distributed_tensorflow_framework_torch.serve.server\n"
        "import distributed_tensorflow_framework_torch.serve.engine\n"
        "import distributed_tensorflow_framework_torch.models.convert\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.startswith('distributed_tensorflow_framework_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_cuda):
    assert dev.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(dev.DeviceUnavailableError, match="device='cpu'"):
        dev.resolve_device()
    with pytest.raises(dev.DeviceUnavailableError):
        dev.resolve_device("cuda:0")
    with pytest.raises(ValueError, match="unsupported device"):
        dev.resolve_device("meta")


def test_get_model_needs_cuda_unless_cpu(no_cuda):
    from distributed_tensorflow_framework_torch.models import get_model

    cfg = load_config(overrides=["model.name=bert", *TINY]).model
    with pytest.raises(dev.DeviceUnavailableError):
        get_model(cfg)
    assert next(get_model(cfg, device="cpu").parameters()).device.type == "cpu"


@pytest.fixture()
def tiny_artifact(tmp_path):
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.models.convert import to_flax
    from distributed_tensorflow_framework_torch.serve.export import (
        input_spec_for,
        save_artifact,
    )

    cfg = load_config(overrides=["model.name=bert", *TINY])
    params = to_flax(get_model(cfg.model, device="cpu"))
    return save_artifact(str(tmp_path / "art"), model_config=cfg.model,
                         task="mlm", params=params, step=0,
                         input_spec=input_spec_for(cfg, "mlm")), cfg


def test_engine_and_cli_need_cuda_unless_cpu(no_cuda, tiny_artifact):
    from distributed_tensorflow_framework_torch.cli import serve as cli
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        load_artifact,
    )

    path, cfg = tiny_artifact
    art = load_artifact(path)
    with pytest.raises(dev.DeviceUnavailableError):
        InferenceEngine(art, cfg.serve)
    eng = InferenceEngine(art, cfg.serve, device="cpu")
    assert eng.drain(10) is True
    with pytest.raises(dev.DeviceUnavailableError):
        cli.main(["--artifact", path, "--set", "serve.port=0"])
    assert cli.parse_args(["--artifact", path]).device == "cuda"


def test_train_cli_and_trainer_need_cuda_unless_cpu(no_cuda):
    from distributed_tensorflow_framework_torch.cli import train as cli
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    over = ["model.name=bert", *TINY, "model.attention_impl=pallas",
            "data.name=synthetic_mlm", "data.vocab_size=100",
            "data.global_batch_size=2", "optimizer.name=adamw",
            "train.total_steps=1", "train.eval_steps=0",
            "checkpoint.directory=", "resilience.rollback=false"]
    assert cli.parse_args([]).device == "cuda"
    with pytest.raises(dev.DeviceUnavailableError):
        cli.main(sum((["--set", o] for o in over), []))
    with pytest.raises(dev.DeviceUnavailableError):
        Trainer(load_config(overrides=over))
    assert cli.main(["--device", "cpu", *sum((["--set", o] for o in over),
                                             [])]) == 0


def test_engine_refuses_multi_device_serving(tiny_artifact, monkeypatch):
    """Two devices where the CPU has one: MeshSizeError, as the JAX
    package's ``serving_mesh``; on a machine that has two cards,
    data-parallel serving is refused naming its queue-A item."""
    from distributed_tensorflow_framework_torch.core.mesh import (
        MeshSizeError,
    )
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
        check_single_replica,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        load_artifact,
    )

    path, cfg = tiny_artifact
    cfg.serve.data = 2
    with pytest.raises(MeshSizeError, match="needs 2 devices but 1"):
        InferenceEngine(load_artifact(path), cfg.serve, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="A15"):
        check_single_replica(cfg.serve, torch.device("cuda", 0))


def test_model_config_round_trips_through_the_artifact(tiny_artifact):
    from distributed_tensorflow_framework_torch.serve.export import (
        load_artifact,
    )

    path, cfg = tiny_artifact
    assert load_artifact(path).model_config == cfg.model
    assert isinstance(cfg.model, ModelConfig)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert res.stdout == ""


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert res.stdout == ""
