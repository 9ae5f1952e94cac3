"""ImageNet: the port's copy of ``data/imagenet.py``'s synthetic fallback.

With no record files under ``data.data_dir`` (``train-*`` or
``validation-*``, sidecar files ignored) the pipeline is the synthetic
image stream at ``data.image_size``, with a warning, as in the JAX
package: config 3's model trains on it. Record files are refused: the
TFRecord/JPEG reader is ROADMAP.md queue A item A5.
"""

from __future__ import annotations

import glob
import logging
import os

from distributed_tensorflow_framework_torch.core.config import DataConfig
from distributed_tensorflow_framework_torch.data import synthetic
from distributed_tensorflow_framework_torch.data.pipeline import HostDataset

log = logging.getLogger(__name__)

_SIDECAR_EXTS = (".txt", ".json", ".yaml", ".csv")


def record_files(config: DataConfig, train: bool) -> list[str]:
    if not config.data_dir:
        return []
    sub = "train" if train else "validation"
    files = glob.glob(os.path.join(config.data_dir, f"{sub}-*"))
    return sorted(f for f in files if not f.lower().endswith(_SIDECAR_EXTS))


def make_imagenet(config: DataConfig, process_index: int, process_count: int,
                  *, train: bool = True) -> HostDataset:
    files = record_files(config, train)
    if files:
        raise NotImplementedError(
            f"ImageNet records under {config.data_dir!r} ({len(files)} "
            f"files): the TFRecord/JPEG reader is not ported yet — "
            f"ROADMAP.md queue A item A5")
    log.warning("ImageNet TFRecords not found under %r — synthetic fallback",
                config.data_dir)
    return synthetic.synthetic_images(config, process_index, process_count)
