"""Input pipelines: ``get_dataset`` from a DataConfig.

The port's copy of ``data/__init__.py``'s dispatch: ``synthetic*``
(masked-LM when the name holds ``mlm`` or ``text``, images otherwise),
``mnist``, ``cifar10``, ``imagenet`` (TFRecords of JPEGs, or the
synthetic fallback without them) and ``text_mlm``/``mlm``.
``register_dataset`` is ROADMAP.md queue A item A19.
"""

from __future__ import annotations

from distributed_tensorflow_framework_torch.core.config import DataConfig
from distributed_tensorflow_framework_torch.data.pipeline import (  # noqa: F401
    HostDataset,
)


def get_dataset(config: DataConfig, *, process_index: int = 0,
                process_count: int = 1, train: bool = True) -> HostDataset:
    name = config.name.lower()
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
