"""``python -m distributed_tensorflow_framework_torch.cli.export`` — freeze
a training checkpoint into a serving artifact.

    python -m distributed_tensorflow_framework_torch.cli.export \\
        --config configs/bert_base_mlm.yaml --output DIR \\
        [--set checkpoint.directory=CKPT] [--step 30] [--device cuda]

The config names the training run (``checkpoint.directory``) and the
model. The artifact (``dtf-torch-serve-artifact/1``, serve/export.py) is
what ``cli/serve.py --artifact DIR`` loads. ``--step`` picks a committed
step (default: the newest that verifies). ``--device`` defaults to
``cuda`` and fails without one, unless ``--device cpu``. Prints the
artifact's path.
"""

from __future__ import annotations

import argparse
import logging
import sys

from distributed_tensorflow_framework_torch.core.config import load_config
from distributed_tensorflow_framework_torch.core.metrics import setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default=None, help="YAML config path")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="key.path=value",
                   help="config override (repeatable)")
    p.add_argument("--output", type=str, required=True,
                   help="artifact directory to create (must not exist "
                        "non-empty: artifacts are immutable)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to export (default: the newest "
                        "committed)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to build the model on (default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    setup_logging()
    args = parse_args(argv)
    config = load_config(args.config, overrides=list(args.overrides))
    from distributed_tensorflow_framework_torch.serve.export import (
        export_checkpoint,
    )

    path = export_checkpoint(config, args.output, step=args.step,
                             device=args.device)
    logging.getLogger(__name__).info("artifact ready: %s", path)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
