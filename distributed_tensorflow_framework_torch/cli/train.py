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
``--set train.profile_start=N --set train.profile_stop=M`` writes a
Kineto trace of steps N+1..M under ``<checkpoint.directory>/traces``
(core/trace_analysis.py reads it); ``train.memory_analysis=true`` measures
the first step's memory; ``train.compilation_cache_dir`` is logged and
ignored (the port compiles no programs).

Started N times with the gang environment of ``core/cluster.py``
(``JAX_COORDINATOR_ADDRESS=host:port``, ``JAX_NUM_PROCESSES=N``,
``JAX_PROCESS_ID=i``), the processes form one ``torch.distributed`` group
(NCCL when each rank has a GPU of its own, gloo with ``--device cpu``
and when ranks share a card; rank i on GPU i modulo the visible count)
and train one model data parallel, each rank feeding its block of the
global batch (core/mesh.py, train/step.py); the ranks along
``mesh.seq`` split each row of one block between them under ring
attention (parallel/ring.py), as ``configs/bert_long_ring.yaml`` asks,
and the ranks along ``mesh.pipe`` (with ``model.pipeline_stages`` equal
to it) each hold one stage of BERT's encoder stack, the activations
passed stage to stage under ``model.pipeline_schedule``
(parallel/pipeline.py). Without it the run is a single process.

Exit codes: 0 done; 83 (``GRACEFUL_PREEMPT_RC``) after a SIGTERM, which
stops at the next step boundary and saves a checkpoint; 84
(``ELASTIC_RESHARD_RC``) when the mesh does not fit the gang's ranks
(e.g. ``mesh.data=2`` in one process), after writing the device report
(``devices.json`` in ``checkpoint.directory``: the world the run saw as
``visible_devices``, a port device being a rank); 85
(``ANOMALY_ESCALATION_RC``) when the recovery ladder ran out of
rollbacks. Other failures raise. The supervisors (cli/train_resilient.py,
cli/train_cluster.py) pass a refit as ``DTF_ELASTIC_OVERRIDES``
(comma-separated ``key.path=value``), applied after the ``--set``
overrides so that the refit wins; with it a checkpoint of another mesh
restores under ``checkpoint.allow_reshard``.
"""

from __future__ import annotations

import argparse
import logging
import os
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
    overrides = list(args.overrides)
    # The supervisor's refit, after the command line's own overrides.
    elastic = os.environ.get(supervision.ELASTIC_OVERRIDES_ENV, "")
    if elastic:
        extra = [e.strip() for e in elastic.split(",") if e.strip()]
        log.warning("applying elastic overrides from %s: %s",
                    supervision.ELASTIC_OVERRIDES_ENV, " ".join(extra))
        overrides += extra
    config = load_config(args.config, overrides=overrides)
    if args.print_config:
        import yaml

        print(yaml.safe_dump(config.to_dict(), sort_keys=False))
        return 0
    if config.train.compilation_cache_dir:
        # The JAX CLI's branch for a JAX without the persistent cache: the
        # eager port compiles no programs (its kernels persist in
        # build/kernels/ by source hash), so the run goes on uncached and
        # its startup event names the setting.
        log.warning("train.compilation_cache_dir=%s: the port has no "
                    "compilation cache to enable — continuing uncached",
                    config.train.compilation_cache_dir)
    from distributed_tensorflow_framework_torch.core.mesh import (
        MeshSizeError,
        initialize_runtime,
    )

    try:
        runtime = initialize_runtime(config.mesh, args.device)
    except MeshSizeError as e:
        # A topology change to refit to, not a crash: leave the device
        # report for the supervisor, which fits the mesh to it.
        log.error("mesh does not fit the gang — exiting rc=%d for an "
                  "elastic refit: %s", supervision.ELASTIC_RESHARD_RC, e)
        if config.checkpoint.directory:
            supervision.write_device_report(
                config.checkpoint.directory, visible_devices=e.available,
                needed=e.needed, mesh=e.sizes)
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
