"""Input pipelines: ``get_dataset`` from a DataConfig.

The port's copy of ``data/__init__.py``'s dispatch: ``synthetic*``
(masked-LM when the name holds ``mlm`` or ``text``, images otherwise),
``mnist``, ``cifar10``, ``imagenet`` (TFRecords of JPEGs, or the
synthetic fallback without them) and ``text_mlm``/``mlm``.
``register_dataset`` is the extension point: a user factory under a name
no built-in holds slots into the same per-rank sharding, infeed,
checkpointable iterator and exact eval as the built-ins.
"""

from __future__ import annotations

from typing import Callable

from distributed_tensorflow_framework_torch.core.config import DataConfig
from distributed_tensorflow_framework_torch.data.pipeline import (  # noqa: F401
    HostDataset,
)

# name → factory(config, process_index, process_count, train) -> HostDataset
_CUSTOM_DATASETS: dict[str, Callable[..., HostDataset]] = {}


def _is_builtin_dataset_name(name: str) -> bool:
    """Name twin of get_dataset's dispatch below — keep the two in sync
    when adding a pipeline (the whole synthetic* prefix is reserved)."""
    return name.startswith("synthetic") or name in (
        "mnist", "cifar10", "imagenet", "text_mlm", "mlm")


def register_dataset(name: str):
    """Register a user dataset factory under ``data.name`` (decorator).

    The factory must return a ``HostDataset`` yielding THIS PROCESS'S
    share of each global batch (``global_batch_size // process_count``
    rows — see pipeline.host_batch_size) and honor the iterator
    state()/restore() contract for exact resume. Finite eval streams
    should set ``cardinality`` and pad the final batch with zero-weight
    rows (the exact-eval contract; pipeline.finite_array_eval is the
    reusable helper). Built-in names cannot be shadowed.

        @register_dataset("my_corpus")
        def build(config, process_index, process_count, *, train=True):
            return HostDataset(...)
    """
    key = name.lower()

    def deco(factory):
        if key in _CUSTOM_DATASETS:
            raise ValueError(f"dataset {name!r} already registered")
        if _is_builtin_dataset_name(key):
            raise ValueError(f"dataset {name!r} shadows a built-in")
        _CUSTOM_DATASETS[key] = factory
        return factory

    return deco


def get_dataset(config: DataConfig, *, process_index: int = 0,
                process_count: int = 1, train: bool = True) -> HostDataset:
    name = config.name.lower()
    if name in _CUSTOM_DATASETS:
        return _CUSTOM_DATASETS[name](
            config, process_index, process_count, train=train)
    if name.startswith("synthetic"):
        from distributed_tensorflow_framework_torch.data import synthetic

        if "mlm" in name or "text" in name:
            return synthetic.synthetic_mlm(config, process_index,
                                           process_count)
        return synthetic.synthetic_images(config, process_index,
                                          process_count)
    if name == "mnist":
        from distributed_tensorflow_framework_torch.data import mnist

        return mnist.make_mnist(config, process_index, process_count,
                                train=train)
    if name == "cifar10":
        from distributed_tensorflow_framework_torch.data import cifar

        return cifar.make_cifar10(config, process_index, process_count,
                                  train=train)
    if name == "imagenet":
        from distributed_tensorflow_framework_torch.data import imagenet

        return imagenet.make_imagenet(config, process_index, process_count,
                                      train=train)
    if name in ("text_mlm", "mlm"):
        from distributed_tensorflow_framework_torch.data import text_mlm

        return text_mlm.make_mlm(config, process_index, process_count,
                                 train=train)
    raise ValueError(f"Unknown dataset {config.name!r}")
