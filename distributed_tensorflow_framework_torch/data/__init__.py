"""Input pipelines: ``get_dataset`` from a DataConfig.

The port's copy of ``data/__init__.py``'s dispatch for the masked-LM
names. Every other dataset raises NotImplementedError naming the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

from distributed_tensorflow_framework_torch.core.config import DataConfig
from distributed_tensorflow_framework_torch.data.pipeline import (  # noqa: F401
    HostDataset,
)


def get_dataset(config: DataConfig, *, process_index: int = 0,
                process_count: int = 1, train: bool = True) -> HostDataset:
    name = config.name.lower()
    if name.startswith("synthetic") and ("mlm" in name or "text" in name):
        from distributed_tensorflow_framework_torch.data import synthetic

        return synthetic.synthetic_mlm(config, process_index, process_count)
    if name in ("text_mlm", "mlm"):
        from distributed_tensorflow_framework_torch.data import text_mlm

        return text_mlm.make_mlm(config, process_index, process_count,
                                 train=train)
    if name.startswith("synthetic") or name in ("mnist", "cifar10",
                                                "imagenet"):
        raise NotImplementedError(
            f"dataset {config.name!r} is not ported yet — ROADMAP.md queue A "
            f"(image pipelines: items A1, A2 and A5)")
    raise ValueError(f"Unknown dataset {config.name!r}")
