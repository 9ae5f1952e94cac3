"""``python -m distributed_tensorflow_framework_torch.cli.fleet`` — stand up
a health-aware serving fleet: N port replicas behind one router.

    python -m distributed_tensorflow_framework_torch.cli.fleet \\
        --artifact /runs/bert_artifact [--device cuda] \\
        [--replicas 2] [--set serve.port=8000 --set serve.max_batch_size=8]

Each replica is a ``cli/serve.py`` subprocess (``--device`` passed on,
default ``cuda``) on an ephemeral port with its own log dir
(``<log_dir>/r{i}/``); the router (serve/fleet.py) balances ``POST
/predict`` across them with hedged retries, pins ``POST /generate``
sessions, ejects and readmits replicas on health, restarts dead ones
under the supervision machinery, walks ``POST /reload`` across the fleet
one drained replica at a time, and with ``serve.fleet_autoscale=true``
grows and shrinks the replica set from live pressure
(serve/autoscale.py), enforcing the ``X-DTF-Tenant`` QoS contract at the
front door. The router's resolved endpoint lands in
``<log_dir>/endpoint.json`` (``role: fleet``), the same contract as one
server's.

A replica that cannot reach its device exits nonzero; the crash-loop
breaker then gives up on it, and when no replica becomes healthy within
180 s the command exits 3. Nothing retries on another device.

SIGTERM drains the router first (stop admission), then SIGTERMs every
replica, whose own drain finishes its queued work: the whole tree exits 0.

The router process never imports torch: the replica subprocesses own the
device, the parent is stdlib plumbing.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys

from distributed_tensorflow_framework_torch.core.config import load_config
from distributed_tensorflow_framework_torch.core.metrics import setup_logging

log = logging.getLogger(__name__)

# What a replica runs: ``python <SERVE_ENTRY> <cli.serve arguments>``.
SERVE_ENTRY = ("-m", "distributed_tensorflow_framework_torch.cli.serve")


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
    p.add_argument("--replicas", type=int, default=None,
                   help="fleet size (overrides serve.fleet_replicas)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device every replica serves on (default "
                        "cuda; cpu runs the plain PyTorch path)")
    return p.parse_args(argv)


def make_replica_launcher(artifact_dir: str, log_dir: str,
                          overrides: list[str], device: str = "cuda",
                          entry: tuple[str, ...] = SERVE_ENTRY):
    """The launcher serve/fleet.py uses for the first launch AND every
    supervised restart: spawn ``entry`` (``cli.serve``) on an ephemeral
    port without waiting for it (the router's prober admits the replica
    once its endpoint.json appears and /healthz answers)."""

    def launch(index: int):
        replica_dir = os.path.join(log_dir, f"r{index}")
        os.makedirs(replica_dir, exist_ok=True)
        endpoint_path = os.path.join(replica_dir, "endpoint.json")
        # A stale endpoint.json of the previous incarnation would make the
        # prober probe a dead port: remove it first.
        try:
            os.remove(endpoint_path)
        except FileNotFoundError:
            pass
        cmd = [sys.executable, *entry,
               "--artifact", artifact_dir, "--device", device,
               "--set", "serve.port=0",
               "--set", f"serve.log_dir={replica_dir}"]
        for override in overrides:
            cmd.extend(["--set", override])
        env = dict(os.environ)
        env["DTF_REPLICA_ID"] = f"r{index}"
        # The chaos faults target the router's fleet_chaos and
        # fleet_reload points: a replica that inherited DTF_FAULTS would
        # fire the drill a second time.
        env.pop("DTF_FAULTS", None)
        env.pop("DTF_FAULTS_STATE", None)
        log.info("launching replica r%d: %s", index, " ".join(cmd))
        out = open(os.path.join(replica_dir, "stdout.log"), "ab")
        try:
            proc = subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT, env=env)
        finally:
            out.close()  # the child holds its own copy of the fd
        return proc, endpoint_path

    return launch


def main(argv=None) -> int:
    setup_logging()
    args = parse_args(argv)
    config = load_config(args.config, overrides=list(args.overrides))
    srv = config.serve
    artifact_dir = args.artifact or srv.artifact_dir
    if not artifact_dir:
        log.error("no artifact: pass --artifact or set serve.artifact_dir")
        return 2
    replicas = args.replicas if args.replicas is not None \
        else srv.fleet_replicas

    from distributed_tensorflow_framework_torch.core import telemetry, tracing
    from distributed_tensorflow_framework_torch.serve.fleet import FleetRouter

    log_dir = srv.log_dir or os.path.join(artifact_dir, "fleet_logs")
    os.makedirs(log_dir, exist_ok=True)
    writer = telemetry.TelemetryWriter(os.path.join(log_dir, "events.jsonl"))
    writer.emit_run_meta(
        argv=list(argv if argv is not None else sys.argv),
        config=config.name, role="fleet", artifact=artifact_dir,
        replicas=replicas, device=args.device)

    # The replicas' serve.* knobs ride through as they are; the router's
    # own (host, port, log_dir, the fleet_* control loop and the tenant_*
    # QoS, all enforced at the front door) are set per replica by the
    # launcher or withheld.
    passthrough = [o for o in args.overrides
                   if not o.startswith(("serve.port=", "serve.host=",
                                        "serve.log_dir=", "serve.fleet_",
                                        "serve.tenant_"))]
    launcher = make_replica_launcher(
        os.path.abspath(artifact_dir), log_dir, passthrough, args.device)
    # The router's flight recorder: a ring of recent route, attempt and
    # eject telemetry, dumped when the prober sees a replica die (and on
    # SIGUSR1).
    recorder = tracing.FlightRecorder(
        config.trace.ring_size,
        dump_dir=config.trace.dump_dir or log_dir).attach(writer)
    recorder.install_sigusr1()
    router = FleetRouter(srv, telemetry_writer=writer, launcher=launcher,
                         trace_enabled=config.trace.enabled,
                         flight_recorder=recorder)
    router.spawn_replicas(replicas)
    router.start()
    if not router.wait_ready(min_replicas=1, timeout=180.0):
        log.error("no replica became healthy within 180s — aborting")
        router.shutdown("startup failed")
        writer.close()
        return 3
    endpoint = {
        "url": f"http://{router.host}:{router.port}",
        "host": router.host, "port": router.port, "pid": os.getpid(),
        "artifact": os.path.abspath(artifact_dir),
        "events": os.path.join(log_dir, "events.jsonl"),
        "replicas": replicas, "role": "fleet",
    }
    with open(os.path.join(log_dir, "endpoint.json"), "w") as fh:
        json.dump(endpoint, fh, indent=2)
        fh.write("\n")
    router.install_sigterm_drain()
    try:
        router.serve_forever()
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
