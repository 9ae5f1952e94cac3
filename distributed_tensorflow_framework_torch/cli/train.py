"""``python -m distributed_tensorflow_framework_torch.cli.train`` — train a
config on one device, or data parallel over a gang of ranks.

    python -m distributed_tensorflow_framework_torch.cli.train \\
        --config configs/bert_base_mlm.yaml [--device cuda] \\
        [--set data.global_batch_size=32 --set checkpoint.directory=DIR] \\
        [--log-dir DIR] [--eval-only]

The same YAML configs and ``--set`` overrides as the JAX package's
``train.py``. ``--device`` defaults to ``cuda`` and the command fails when
no CUDA device is present, unless ``--device cpu``. ``--print-config``
prints the resolved config and exits without touching a device. With
``checkpoint.directory`` set, the run restores the newest verified
checkpoint there and saves into it; running the same command again
resumes. ``--eval-only`` restores the checkpoint (``checkpoint.restore_step``
or the newest) and evaluates it; it raises when there is none.
``--log-dir`` receives ``events.jsonl`` (default: the checkpoint
directory). After training, ``train.eval_steps > 0`` runs a final eval.

Started N times with the gang environment of ``core/cluster.py``
(``JAX_COORDINATOR_ADDRESS=host:port``, ``JAX_NUM_PROCESSES=N``,
``JAX_PROCESS_ID=i``), the processes form one ``torch.distributed`` group
(NCCL on CUDA, gloo with ``--device cpu``; rank i on GPU i modulo the
visible count) and train one model data parallel, each rank feeding its
block of the global batch (core/mesh.py, train/step.py); the ranks along
``mesh.seq`` split each row of one block between them under ring
attention (parallel/ring.py), as ``configs/bert_long_ring.yaml`` asks.
Without it the run is a single process.

Exit codes: 0 done; 83 (``GRACEFUL_PREEMPT_RC``) after a SIGTERM, which
stops at the next step boundary and saves a checkpoint; 84
(``ELASTIC_RESHARD_RC``) when the mesh does not fit the gang's ranks
(e.g. ``mesh.data=2`` in one process); 85 (``ANOMALY_ESCALATION_RC``)
when the recovery ladder ran out of rollbacks. Other failures raise.
"""

from __future__ import annotations

import argparse
import logging
import sys

from distributed_tensorflow_framework_torch.core import supervision
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
                   help="restore the checkpoint and evaluate it")
    p.add_argument("--print-config", action="store_true",
                   help="print the resolved config as YAML and exit without "
                        "touching a device")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda; cpu runs "
                        "the plain PyTorch path)")
    p.add_argument("--log-dir", type=str, default=None,
                   help="directory for the events.jsonl telemetry stream "
                        "(default: checkpoint.directory)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    setup_logging()
    args = parse_args(argv)
    config = load_config(args.config, overrides=list(args.overrides))
    if args.print_config:
        import yaml

        print(yaml.safe_dump(config.to_dict(), sort_keys=False))
        return 0
    from distributed_tensorflow_framework_torch.core.mesh import (
        MeshSizeError,
        initialize_runtime,
    )

    try:
        runtime = initialize_runtime(config.mesh, args.device)
    except MeshSizeError as e:
        # A topology change to refit to (ROADMAP.md A17), not a crash.
        log.error("mesh does not fit the gang — exiting rc=%d for an "
                  "elastic refit: %s", supervision.ELASTIC_RESHARD_RC, e)
        return supervision.ELASTIC_RESHARD_RC
    try:
        return _train(args, config, runtime)
    finally:
        runtime.shutdown()


def _train(args, config, runtime) -> int:
    from distributed_tensorflow_framework_torch.train.anomaly import (
        PersistentAnomalyError,
    )
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    trainer = Trainer(config, log_dir=args.log_dir, runtime=runtime)
    try:
        trainer.build()
        if args.eval_only:
            if trainer.restored_step is None:
                raise ValueError(
                    f"--eval-only needs a committed checkpoint, and "
                    f"checkpoint.directory={config.checkpoint.directory!r} "
                    f"holds none")
            results = trainer.evaluate(step=trainer.host_step)
            log.info("eval results at step %d: %s", trainer.host_step,
                     results)
            return 0
        # SIGTERM lets the loop finish its step and save; train() returns
        # only after the checkpoint's exit barrier, so rc 83 never races
        # an in-flight commit.
        with supervision.graceful_preemption():
            try:
                final = trainer.train()
            except PersistentAnomalyError as e:
                log.error("persistent anomaly — escalating with rc=%d: %s "
                          "(provenance: %s)",
                          supervision.ANOMALY_ESCALATION_RC, e, e.provenance)
                return supervision.ANOMALY_ESCALATION_RC
        if trainer.preempted:
            log.warning("preempted gracefully at step %d (checkpoint saved: "
                        "%s) — exiting rc=%d", trainer.host_step,
                        bool(config.checkpoint.directory),
                        supervision.GRACEFUL_PREEMPT_RC)
            return supervision.GRACEFUL_PREEMPT_RC
        if config.train.eval_steps > 0:
            results = trainer.evaluate(step=trainer.host_step)
            log.info("final eval: %s", results)
        log.info("final train metrics: %s", final)
    finally:
        if trainer._ckpt_manager is not None:
            trainer._ckpt_manager.close()
        trainer.writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
