"""``python -m distributed_tensorflow_framework_torch.cli.serve`` — stand up
the batched-inference server on a port artifact (serve/export.py).

    python -m distributed_tensorflow_framework_torch.cli.serve \\
        --artifact /runs/bert_artifact [--device cuda] \\
        [--config configs/bert_base_mlm.yaml] \\
        [--set serve.port=8000 --set serve.seq_buckets=[128,256,512]]

The model comes from the artifact; ``--config`` is optional and only its
``serve`` and ``decode`` blocks are consulted. With ``decode.enabled``
(an mlm artifact of the dense bert family) a decode engine
(serve/decode.py) stands beside the single-shot one and ``POST /generate``
streams tokens; an artifact that cannot decode is refused with exit code
2 before the port is bound. ``serve.data`` devices serve the batches
(engine.py ``serving_devices``), and the decode engine takes the same
ones. ``--device`` defaults to ``cuda`` and the
command fails when no CUDA device is present, unless ``--device cpu``. The
process serves until SIGTERM (or SIGINT), then drains in-flight requests and
exits 0. The resolved endpoint (ephemeral ports included) is written to
``<log_dir>/endpoint.json``. SIGUSR1 dumps the replica's flight recorder
(the last ``trace.ring_size`` telemetry events and the open spans) to
``<log_dir>/flightrec-<pid>.json`` (``trace.dump_dir`` when set).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys

from distributed_tensorflow_framework_torch.core.config import load_config
from distributed_tensorflow_framework_torch.core.metrics import setup_logging

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--artifact", type=str, default=None,
                   help="port artifact directory (overrides "
                        "serve.artifact_dir)")
    p.add_argument("--config", type=str, default=None,
                   help="optional YAML config (serve.* block)")
    p.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="key.path=value", help="config override (repeatable)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (default cuda; cpu runs "
                        "the plain PyTorch path)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Serve until SIGTERM/SIGINT. Call from the main thread: it installs
    the drain handlers (and restores the previous ones on return)."""
    setup_logging()
    args = parse_args(argv)
    config = load_config(args.config, overrides=list(args.overrides))
    srv = config.serve
    artifact_dir = args.artifact or srv.artifact_dir
    if not artifact_dir:
        log.error("no artifact: pass --artifact or set serve.artifact_dir")
        return 2

    from distributed_tensorflow_framework_torch.core import telemetry, tracing
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        load_artifact,
    )
    from distributed_tensorflow_framework_torch.serve.server import (
        ServingServer,
    )

    artifact = load_artifact(artifact_dir)
    log_dir = srv.log_dir or os.path.join(artifact_dir, "serve_logs")
    os.makedirs(log_dir, exist_ok=True)
    writer = telemetry.TelemetryWriter(os.path.join(log_dir, "events.jsonl"))
    try:
        writer.emit_run_meta(
            argv=list(argv if argv is not None else sys.argv),
            config=config.name, role="serve", artifact=artifact_dir,
            model=artifact.model_config.name, step=artifact.step,
            device=args.device)
        decode_engine = None
        if config.decode.enabled:
            from distributed_tensorflow_framework_torch.models import (
                decode_support_reason,
            )
            from distributed_tensorflow_framework_torch.serve.decode import (
                DecodeEngine,
            )

            reason = (None if artifact.task == "mlm" else
                      f"artifact task {artifact.task!r} has no vocabulary")
            reason = reason or decode_support_reason(artifact.model_config)
            if reason is not None:
                # decode.enabled on an unsupported artifact is a config
                # error, not a silent downgrade: fail before binding the
                # port.
                log.error("decode.enabled but artifact cannot decode: %s",
                          reason)
                return 2
        engine = InferenceEngine(artifact, srv, device=args.device,
                                 telemetry_writer=writer,
                                 trace_enabled=config.trace.enabled)
        if config.decode.enabled:
            decode_engine = DecodeEngine(artifact, config.decode, srv,
                                         devices=engine.devices,
                                         telemetry_writer=writer)
        # The replica's flight recorder: a ring of recent telemetry (spans
        # included), dumped to flightrec-<pid>.json on SIGUSR1.
        recorder = tracing.FlightRecorder(
            config.trace.ring_size,
            dump_dir=config.trace.dump_dir or log_dir,
            tracer=engine.tracer).attach(writer)
        server = ServingServer(engine, srv, decode_engine=decode_engine,
                               telemetry_writer=writer)
        # The resolved endpoint record: with serve.port=0 the OS picked
        # the port, so tooling polls this file instead of guessing.
        endpoint = {
            "url": f"http://{server.host}:{server.port}",
            "host": server.host, "port": server.port, "pid": os.getpid(),
            "artifact": os.path.abspath(artifact_dir),
            "events": os.path.join(log_dir, "events.jsonl"),
        }
        previous = {sig: signal.getsignal(sig) for sig in
                    (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)}
        recorder.install_sigusr1()
        server.install_sigterm_drain()
        try:
            with open(os.path.join(log_dir, "endpoint.json"), "w") as fh:
                json.dump(endpoint, fh, indent=2)
                fh.write("\n")
            server.serve_forever()
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
