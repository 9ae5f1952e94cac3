"""``python -m distributed_tensorflow_framework_torch.cli.train`` — train a
config on one device.

    python -m distributed_tensorflow_framework_torch.cli.train \\
        --config configs/bert_base_mlm.yaml [--device cuda] \\
        [--set data.global_batch_size=32 --set checkpoint.directory= \\
         --set resilience.rollback=false] [--log-dir DIR]

The same YAML configs and ``--set`` overrides as the JAX package's
``train.py``. ``--device`` defaults to ``cuda`` and the command fails when
no CUDA device is present, unless ``--device cpu``. ``--print-config``
prints the resolved config and exits without touching a device.
``--eval-only`` raises: it restores a checkpoint, and checkpointing is not
ported yet (ROADMAP.md queue A item A4). ``--log-dir`` receives
``events.jsonl``. After training, ``train.eval_steps > 0`` runs a final
eval. Returns 0 on success; failures raise.
"""

from __future__ import annotations

import argparse
import logging
import sys

from distributed_tensorflow_framework_torch.core.config import load_config
from distributed_tensorflow_framework_torch.core.metrics import setup_logging

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default=None, help="YAML config path")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="key.path=value",
                   help="config override (repeatable)")
    p.add_argument("--eval-only", action="store_true",
                   help="restore the latest checkpoint and evaluate (not "
                        "ported yet: raises)")
    p.add_argument("--print-config", action="store_true",
                   help="print the resolved config as YAML and exit without "
                        "touching a device")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda; cpu runs "
                        "the plain PyTorch path)")
    p.add_argument("--log-dir", type=str, default=None,
                   help="directory for the events.jsonl telemetry stream")
    return p.parse_args(argv)


def main(argv=None) -> int:
    setup_logging()
    args = parse_args(argv)
    config = load_config(args.config, overrides=list(args.overrides))
    if args.print_config:
        import yaml

        print(yaml.safe_dump(config.to_dict(), sort_keys=False))
        return 0
    if args.eval_only:
        raise NotImplementedError(
            "--eval-only restores a checkpoint to evaluate, and "
            "checkpointing is not ported yet — ROADMAP.md queue A item A4")
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    trainer = Trainer(config, device=args.device, log_dir=args.log_dir)
    try:
        trainer.build()
        final = trainer.train()
        if config.train.eval_steps > 0:
            results = trainer.evaluate(step=trainer.host_step)
            log.info("final eval: %s", results)
        log.info("final train metrics: %s", final)
    finally:
        trainer.writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
