"""``python -m distributed_tensorflow_framework_torch.cli.train_resilient``
— relaunch a training command until it is done: the port's counterpart of
``scripts/train_resilient.py``.

    python -m distributed_tensorflow_framework_torch.cli.train_resilient \\
        --max-attempts 25 --heartbeat-timeout 120 -- \\
        python -m distributed_tensorflow_framework_torch.cli.train \\
        --config configs/bert_base_mlm.yaml \\
        --set checkpoint.directory=/tmp/run_ck

The checkpoint contract (restore of the newest verified step, exact
resume of the data and the generators) makes relaunching the whole
process a recovery. Each exit code is classified (the same flags and
codes as the script):

  * 0 stops the loop (done).
  * 130/143 (SIGINT/SIGTERM death) is cancellation and is never
    relaunched; a SIGTERM or SIGINT sent to this supervisor is forwarded
    to the child and counts as cancellation too.
  * 83 (``GRACEFUL_PREEMPT_RC``): the child honoured a SIGTERM and saved;
    relaunched at once without using an attempt (``--max-preemptions``).
  * 84 (``ELASTIC_RESHARD_RC``): the child's mesh does not fit its world.
    The supervisor reads the device report, fits the largest valid mesh
    (``fit_axis_sizes``), rescales the batch so that the effective batch
    is kept (``rescale_for_devices``) and relaunches with the refit and
    ``checkpoint.allow_reshard=true`` in ``DTF_ELASTIC_OVERRIDES``,
    without using an attempt (bounded by ``--max-reshards``); a
    ``mesh_resized`` event records it.
  * 85 (``ANOMALY_ESCALATION_RC``): a persistent anomaly; relaunched
    after backoff, using an attempt, without feeding the crash-loop
    breaker.
  * The heartbeat watchdog SIGKILLs a child whose heartbeat
    (``<checkpoint.directory>/heartbeat.json``, pid-scoped) is older than
    ``--heartbeat-timeout``, or that wrote none within
    ``--startup-grace``; the kill is a transient hang.
  * Any other failure relaunches after capped exponential backoff with
    jitter, up to ``--max-attempts``; ``--crash-loop-threshold``
    identical no-progress failures in a row stop it early with the
    breaker's report (``crash_loop``).

Every attempt goes to ``<checkpoint.directory>/supervisor_events.jsonl``
(``supervisor_attempt``), beside spans ``supervisor.run`` →
``supervisor.attempt`` (its context passed to the child in
``DTF_TRACE_CTX``, which the trainer adopts) and
``supervisor.restart_gap``; a crash dumps the supervisor's flight
recorder. The ``drop_devices:N:S`` fault (core/faults.py) starts the
child, from its Sth launch on, as a gang of N ranks (a port device is a
rank): a mesh that needs another count exits 84 and is refit, and the
refit runs on the N ranks. The script's XLA fast-fail flags and its
virtual-device mask have no counterpart. Stdlib only: the supervisor
never imports torch.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time

from distributed_tensorflow_framework_torch.ckpt.manifest import (
    latest_committed_step,
)
from distributed_tensorflow_framework_torch.cli import (
    launch_local_cluster as llc,
)
from distributed_tensorflow_framework_torch.core import (
    cluster,
    faults,
    supervision,
    telemetry,
    tracing,
)


def _config_path(cmd: list[str]) -> str | None:
    path = None
    for i, tok in enumerate(cmd):
        if tok == "--config" and i + 1 < len(cmd):
            path = cmd[i + 1]
        elif tok.startswith("--config="):
            path = tok.split("=", 1)[1]
    return path


def _yaml_doc(path: str) -> dict:
    import yaml

    with open(path) as fh:
        return yaml.safe_load(fh) or {}


def find_checkpoint_dir(cmd: list[str]) -> tuple[str | None, bool]:
    """(checkpoint directory, checkpointing on) for a training command:
    the last ``checkpoint.directory=`` on the command line (it may ride
    inside a ``python -c`` program), else the ``--config`` YAML's; an
    unreadable YAML gets the benefit of the doubt (on, directory
    unknown)."""
    directory: str | None = None
    explicit = False
    for arg in cmd:
        if "checkpoint.directory=" in arg:
            explicit = True
            raw = arg.split("checkpoint.directory=", 1)[1]
            directory = re.split(r"[\s'\",]", raw, 1)[0]
    if explicit:
        return (directory or None), bool(directory)
    config_path = _config_path(cmd)
    if config_path is None:
        return None, False
    try:
        doc = _yaml_doc(config_path)
        directory = (doc.get("checkpoint") or {}).get("directory") or None
        return directory, bool(directory)
    except Exception:
        return None, True


def parse_training_params(cmd: list[str]) -> tuple[dict, int, int]:
    """(mesh axis sizes, global batch, grad accumulation) as the child
    sees them: the command line's last override of each, over the
    ``--config`` YAML, over the config defaults (``data=-1``, batch 64,
    accumulation 1)."""
    sizes = {a: (-1 if a == "data" else 1)
             for a in supervision.MESH_AXIS_ORDER}
    batch, accum = 64, 1
    config_path = _config_path(cmd)
    if config_path:
        try:
            doc = _yaml_doc(config_path)
            for a, v in (doc.get("mesh") or {}).items():
                if a in sizes:
                    sizes[a] = int(v)
            batch = int((doc.get("data") or {}).get(
                "global_batch_size", batch))
            accum = int((doc.get("train") or {}).get(
                "grad_accum_steps", accum))
        except Exception:
            pass
    text = " ".join(cmd)
    for a in sizes:
        for m in re.finditer(rf"mesh\.{a}=(-?\d+)", text):
            sizes[a] = int(m.group(1))
    for m in re.finditer(r"data\.global_batch_size=(\d+)", text):
        batch = int(m.group(1))
    for m in re.finditer(r"train\.grad_accum_steps=(\d+)", text):
        accum = int(m.group(1))
    return sizes, batch, accum


def fmt_axes(axes: dict) -> str:
    parts = [f"{a}:{v}" for a, v in axes.items() if int(v) != 1]
    return "{" + ", ".join(parts) + "}" if parts else "{1 device}"


# -- cancellation forwarding ----------------------------------------------
_children: list[subprocess.Popen] = []
_cancelled = False


def _forward_signal(signum, frame):
    global _cancelled
    _cancelled = True
    for child in _children:
        if child.poll() is None:
            child.send_signal(signum)


def _launch(cmd: list[str], env: dict, ranks: int) -> list[subprocess.Popen]:
    """The child, or (after a drop_devices drill) ``ranks`` copies of it
    wired into one gang by the discovery environment."""
    if ranks <= 1:
        return [subprocess.Popen(cmd, env=env)]
    port = llc.free_port()
    return [subprocess.Popen(cmd, env=cluster.worker_env(
        env, coordinator_port=port, num_processes=ranks, process_id=i))
        for i in range(ranks)]


def _run_attempt(cmd, env, *, ranks: int, hb_path: str | None,
                 hb_timeout: float, hb_poll: float,
                 startup_grace: float) -> tuple[int, bool, int]:
    """Run the child under the heartbeat watchdog; (rc, hung, child pid).
    In a gang the rc is the first failing rank's, the others stopped."""
    global _children
    _children = children = _launch(cmd, env, ranks)
    lead = children[0]
    start = time.monotonic()
    hung = False
    watch = hb_path is not None and hb_timeout > 0
    rc: int | None = None
    while rc is None:
        try:
            lead.wait(timeout=hb_poll if (watch or ranks > 1) else None)
        except subprocess.TimeoutExpired:
            pass
        failed = [c.returncode for c in children
                  if c.poll() is not None and c.returncode != 0]
        if failed or all(c.poll() is not None for c in children):
            rc = failed[0] if failed else 0
            break
        if not watch and startup_grace <= 0:
            continue
        age = (supervision.heartbeat_age_s(hb_path, pid=lead.pid)
               if hb_path else None)
        stale = watch and age is not None and age > hb_timeout
        no_start = (age is None and startup_grace > 0
                    and time.monotonic() - start > startup_grace)
        if stale or no_start:
            why = (f"heartbeat stale ({age:.0f}s > {hb_timeout:.0f}s budget)"
                   if stale else
                   f"no heartbeat within {startup_grace:.0f}s startup grace")
            print(f"train_resilient: {why} — killing hung child "
                  f"pid={lead.pid}", file=sys.stderr)
            lead.kill()
            rc = lead.wait()
            hung = True
    for child in children:
        if child.poll() is None:
            child.terminate()
            try:
                child.wait(timeout=llc.GRACE_S)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
    _children = []
    return rc, hung, lead.pid


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--max-attempts", type=int, default=10)
    parser.add_argument("--retry-sleep", type=float, default=5.0,
                        help="backoff BASE seconds (doubles per consecutive "
                             "failure, jittered)")
    parser.add_argument("--backoff-max", type=float, default=120.0,
                        help="backoff ceiling in seconds")
    parser.add_argument("--jitter", type=float, default=0.5,
                        help="fractional backoff jitter (0 disables)")
    parser.add_argument("--heartbeat-timeout", type=float, default=0.0,
                        help="kill the child when its heartbeat file is "
                             "older than this many seconds (0 disables the "
                             "watchdog)")
    parser.add_argument("--heartbeat-poll", type=float, default=2.0,
                        help="watchdog poll interval in seconds")
    parser.add_argument("--heartbeat-file", default=None,
                        help="heartbeat path (default: "
                             "<checkpoint.directory>/heartbeat.json)")
    parser.add_argument("--startup-grace", type=float, default=0.0,
                        help="kill the child when NO heartbeat appears "
                             "within this many seconds of launch (0 "
                             "disables)")
    parser.add_argument("--crash-loop-threshold", type=int, default=3,
                        help="stop after this many consecutive identical "
                             "no-progress failures (0 disables the breaker)")
    parser.add_argument("--max-preemptions", type=int, default=50,
                        help="safety bound on graceful-preemption "
                             "relaunches (they never consume attempts)")
    parser.add_argument("--max-reshards", type=int, default=8,
                        help="safety bound on elastic mesh-refit "
                             "relaunches, rc 84 (they never consume "
                             "attempts)")
    parser.add_argument("--events", default=None,
                        help="supervisor telemetry JSONL (default: "
                             "<checkpoint.directory>/supervisor_events"
                             ".jsonl; '-' disables)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="training command after --")
    return parser


def main(argv=None) -> int:
    global _cancelled
    parser = build_parser()
    args = parser.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no command given (put it after `--`)")
    if args.max_attempts < 1:
        parser.error("--max-attempts must be >= 1")

    ckpt_dir, ckpt_enabled = find_checkpoint_dir(cmd)
    if not ckpt_enabled:
        print("train_resilient: WARNING — no checkpoint.directory in the "
              "command; every relaunch will restart from step 0",
              file=sys.stderr)
    hb_file = args.heartbeat_file
    if args.heartbeat_timeout > 0 and hb_file is None and ckpt_dir is None:
        print("train_resilient: WARNING — --heartbeat-timeout set but no "
              "heartbeat path is known (need checkpoint.directory or "
              "--heartbeat-file); watchdog disabled", file=sys.stderr)

    events_path = args.events
    if events_path is None and ckpt_dir:
        events_path = os.path.join(ckpt_dir, "supervisor_events.jsonl")
    writer = telemetry.TelemetryWriter(
        None if events_path in (None, "-") else events_path)
    writer.emit_run_meta(
        argv=[sys.argv[0]], supervisor=True, command=" ".join(cmd),
        max_attempts=args.max_attempts,
        heartbeat_timeout_s=args.heartbeat_timeout,
        checkpoint_dir=ckpt_dir or "")

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _forward_signal)
        except (ValueError, OSError):  # not the main thread
            pass

    env = dict(os.environ)
    tracer = tracing.Tracer(writer, service="supervisor")
    flightrec = tracing.FlightRecorder(
        512, dump_dir=ckpt_dir or None, tracer=tracer).attach(writer)
    flightrec.install_sigusr1()
    root = tracer.start("supervisor.run", None, command=" ".join(cmd)[:200])
    breaker = supervision.CrashLoopBreaker(args.crash_loop_threshold)
    rc = 1
    attempt = failures = preemptions = reshards = 0
    prev_end_mono: float | None = None
    cur_sizes, cur_batch, cur_accum = parse_training_params(cmd)
    # The world a drop_devices drill gives the child (None: one process).
    masked_devices: int | None = None
    try:
        while attempt < args.max_attempts:
            attempt += 1
            if prev_end_mono is not None:
                tracer.emit_span("supervisor.restart_gap", root,
                                 start_mono=prev_end_mono,
                                 end_mono=time.monotonic(),
                                 before_attempt=attempt)
            attempt_span = tracer.start("supervisor.attempt", root,
                                        attempt=attempt)
            env[tracing.TRACE_CTX_ENV] = attempt_span.context().encode()
            for fault in faults.fire("relaunch", step=attempt):
                if fault.kind != "drop_devices":
                    continue
                masked_devices = fault.devices
                print(f"train_resilient: drop_devices drill — child world "
                      f"set to {masked_devices} rank(s)", file=sys.stderr)
            ranks = masked_devices or 1
            hb_path = hb_file or (cluster.heartbeat_path(ckpt_dir, 0, ranks)
                                  if ckpt_dir else None)
            print(f"train_resilient: attempt {attempt}/{args.max_attempts}",
                  file=sys.stderr)
            rc, hung, child_pid = _run_attempt(
                cmd, env, ranks=ranks, hb_path=hb_path,
                hb_timeout=args.heartbeat_timeout,
                hb_poll=args.heartbeat_poll,
                startup_grace=args.startup_grace)
            if rc < 0:
                rc = 128 - rc  # the shell's 128 + signal
            attempt_span.end(status="ok" if rc == 0 else f"rc_{rc}",
                             rc=rc, hung=hung)
            prev_end_mono = time.monotonic()
            # The heartbeat counts only when the child that just ended
            # wrote it: a predecessor's record would fake progress.
            hb = supervision.read_heartbeat(hb_path) if hb_path else None
            last_step = None
            if hb and hb.get("pid") in (None, child_pid):
                last_step = hb.get("last_completed_step", hb.get("step"))
            ckpt_step = latest_committed_step(ckpt_dir) if ckpt_dir else None

            if rc == 0:
                print(f"train_resilient: done (attempt {attempt})",
                      file=sys.stderr)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt, rc=0, classification="done",
                            last_step=last_step, ckpt_step=ckpt_step)
                return 0
            if _cancelled or rc in (130, 143):
                print(f"train_resilient: child cancelled (rc={rc}) — "
                      "not retrying", file=sys.stderr)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt, rc=rc,
                            classification="cancelled",
                            last_step=last_step, ckpt_step=ckpt_step)
                return rc
            if rc == supervision.GRACEFUL_PREEMPT_RC:
                preemptions += 1
                attempt -= 1  # preemption never uses the budget
                print(f"train_resilient: graceful preemption (rc={rc}, "
                      f"#{preemptions}) — relaunching immediately",
                      file=sys.stderr)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt + 1, rc=rc,
                            classification="preempted",
                            preemptions=preemptions,
                            last_step=last_step, ckpt_step=ckpt_step)
                if preemptions >= args.max_preemptions:
                    print("train_resilient: preemption churn exceeded "
                          f"--max-preemptions={args.max_preemptions} — "
                          "giving up", file=sys.stderr)
                    return rc
                continue

            if rc == supervision.ELASTIC_RESHARD_RC:
                report = (supervision.read_device_report(ckpt_dir)
                          if ckpt_dir else None)
                visible = ((report or {}).get("visible_devices")
                           or masked_devices)
                if not visible:
                    failures += 1
                    print(f"train_resilient: attempt {attempt} exited "
                          f"rc={rc} (elastic) but left no device report — "
                          "treating as a plain failure", file=sys.stderr)
                    writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                                attempt=attempt, rc=rc,
                                classification="elastic_no_report",
                                last_step=last_step, ckpt_step=ckpt_step)
                    if breaker.record(rc=rc, last_step=last_step,
                                      ckpt_step=ckpt_step):
                        print("train_resilient: CRASH LOOP — not retrying",
                              file=sys.stderr)
                        return rc
                    continue
                reshards += 1
                attempt -= 1  # topology changes never use the budget
                breaker.record(rc=rc, last_step=last_step,
                               ckpt_step=ckpt_step, transient=True)
                try:
                    fitted = supervision.fit_axis_sizes(cur_sizes,
                                                        int(visible))
                except ValueError as e:
                    print(f"train_resilient: no mesh fits {visible} devices "
                          f"({e}) — giving up", file=sys.stderr)
                    return rc
                old_dp = cur_sizes.get("data", 1)
                new_batch, new_accum, preserved = (cur_batch, cur_accum,
                                                   False)
                if old_dp > 0:
                    new_batch, new_accum, preserved = \
                        supervision.rescale_for_devices(
                            cur_batch, cur_accum, old_dp,
                            fitted.get("data", 1))
                if not preserved:
                    print("train_resilient: WARNING — could not preserve the "
                          f"effective batch across {fmt_axes(cur_sizes)} -> "
                          f"{fmt_axes(fitted)}; keeping "
                          f"global_batch={cur_batch}, accum={cur_accum}",
                          file=sys.stderr)
                    new_batch, new_accum = cur_batch, cur_accum
                overrides = [f"mesh.{a}={v}" for a, v in fitted.items()]
                overrides.append("checkpoint.allow_reshard=true")
                if preserved:
                    overrides += [f"data.global_batch_size={new_batch}",
                                  f"train.grad_accum_steps={new_accum}"]
                env[supervision.ELASTIC_OVERRIDES_ENV] = ",".join(overrides)
                print(f"train_resilient: elastic reshard #{reshards} "
                      f"(rc={rc}) — mesh {fmt_axes(cur_sizes)} -> "
                      f"{fmt_axes(fitted)} on {visible} devices, "
                      f"global_batch {cur_batch} -> {new_batch}, grad_accum "
                      f"{cur_accum} -> {new_accum} — relaunching "
                      "immediately", file=sys.stderr)
                writer.emit(telemetry.KIND_MESH_RESIZED,
                            attempt=attempt + 1, rc=rc, reshards=reshards,
                            from_axes=dict(cur_sizes), to_axes=dict(fitted),
                            visible_devices=int(visible),
                            global_batch=new_batch, grad_accum=new_accum,
                            effective_batch_preserved=preserved,
                            overrides=" ".join(overrides),
                            last_step=last_step, ckpt_step=ckpt_step)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt + 1, rc=rc,
                            classification="elastic_reshard",
                            reshards=reshards, last_step=last_step,
                            ckpt_step=ckpt_step)
                cur_sizes, cur_batch, cur_accum = fitted, new_batch, new_accum
                if reshards >= args.max_reshards:
                    print("train_resilient: topology churn exceeded "
                          f"--max-reshards={args.max_reshards} — giving up",
                          file=sys.stderr)
                    return rc
                continue

            if rc == supervision.ANOMALY_ESCALATION_RC:
                # The child's own ladder gave up on one incident; the
                # relaunch resumes past part of the region, so this is not
                # a crash signature for the breaker. It uses an attempt.
                failures += 1
                print(f"train_resilient: attempt {attempt} exited rc={rc} "
                      f"(persistent_anomaly — the child exhausted its "
                      f"in-process rollback ladder; last_step={last_step}, "
                      f"ckpt_step={ckpt_step})", file=sys.stderr)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt, rc=rc,
                            classification="persistent_anomaly",
                            last_step=last_step, ckpt_step=ckpt_step)
                breaker.record(rc=rc, last_step=last_step,
                               ckpt_step=ckpt_step, transient=True)
                if attempt < args.max_attempts:
                    delay = supervision.backoff_seconds(
                        failures, base=args.retry_sleep,
                        cap=args.backoff_max, jitter=args.jitter)
                    print(f"train_resilient: backing off {delay:.1f}s",
                          file=sys.stderr)
                    time.sleep(delay)
                continue

            failures += 1
            classification = "hung" if hung else "crashed"
            print(f"train_resilient: attempt {attempt} exited rc={rc} "
                  f"({classification}, last_step={last_step}, "
                  f"ckpt_step={ckpt_step})", file=sys.stderr)
            writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                        attempt=attempt, rc=rc, classification=classification,
                        hung=hung, last_step=last_step, ckpt_step=ckpt_step)
            flightrec.dump(f"child {classification} (rc={rc})",
                           open_spans=tracer.open_spans())
            if breaker.record(rc=rc, last_step=last_step,
                              ckpt_step=ckpt_step, hung=hung):
                report = breaker.report()
                print("train_resilient: CRASH LOOP — deterministic failure, "
                      "not retrying:\n" + json.dumps(report, indent=2),
                      file=sys.stderr)
                writer.emit(telemetry.KIND_CRASH_LOOP, **report)
                return rc
            if attempt < args.max_attempts:
                delay = supervision.backoff_seconds(
                    failures, base=args.retry_sleep, cap=args.backoff_max,
                    jitter=args.jitter)
                print(f"train_resilient: backing off {delay:.1f}s",
                      file=sys.stderr)
                time.sleep(delay)
        return rc
    finally:
        root.end(status="ok" if rc == 0 else f"rc_{rc}",
                 attempts=attempt, failures=failures,
                 reshards=reshards, preemptions=preemptions)
        writer.close()


if __name__ == "__main__":
    sys.exit(main())
