"""``python -m distributed_tensorflow_framework_torch.cli.train_cluster``
— the gang supervisor: the port's counterpart of ``scripts/train_cluster.py``.

    python -m distributed_tensorflow_framework_torch.cli.train_cluster \\
        --procs 2 --heartbeat-timeout 60 --workdir /tmp/dtf-gang -- \\
        --config configs/bert_base_mlm.yaml --device cpu \\
        --set mesh.data=2 --set checkpoint.directory=/tmp/dtf-gang/ck

A gang fails as a unit (one dead rank blocks every collective), so this
supervisor owns the whole gang. Everything after ``--`` goes to
``cli.train``; the ranks start through cli/launch_local_cluster.py's
``spawn_gang`` (the discovery environment, the backend core/mesh.py
picks: gloo when ranks share a card). The same flags as the script;
``--devices-per-proc`` takes 1 (a port rank is one device). Its ladder:

  * Coordinated gang restart: on any rank's crash or stale heartbeat
    (each rank beats its own ``heartbeat-p<i>.json``, pid-scoped) the
    survivors get SIGTERM (the chief finishes its step and saves, rc 83),
    SIGKILL after the grace, then the gang is relaunched after the shared
    exponential backoff. The first nonzero exit is the root cause; the
    rest is fallout.
  * A crash-loop breaker per rank (core/cluster.py ``GangBreaker``).
  * Gang-level rc 84: a rank lost for good (``drop_worker`` chaos, or no
    heartbeat within the rejoin timeout while its peers have one) shrinks
    the gang: the mesh is refit to the survivors (``decide_refit``), the
    batch rescaled so that the effective batch is kept, and the smaller
    gang relaunched with ``checkpoint.allow_reshard=true`` in
    ``DTF_ELASTIC_OVERRIDES``, without using an attempt (bounded by
    ``--max-reshards``; a ``mesh_resized`` event records it). A rank's own
    rc 84 refits at the same process count from its device report.
  * Graceful preemption (a first exit of 83 not caused here) and
    cancellation (130/143, or a signal to this supervisor, forwarded to
    the gang) as in cli/train_resilient.py; a rank that lost the port-bind
    race relaunches the gang on a fresh port for free.
  * Cluster chaos (core/faults.py): ``kill_worker:W[:T]``,
    ``stall_worker:W:S`` (SIGSTOP, then SIGCONT) and ``drop_worker:W[:T]``
    fire at the ``gang_chaos`` point on a tick clock (``--chaos-tick``
    seconds) that starts once every rank has heartbeated.

Every attempt lands in ``<checkpoint.directory>/supervisor_events.jsonl``
with the ``process_id`` it is attributed to, beside the spans
``supervisor.run`` → ``supervisor.attempt`` (passed to every rank in
``DTF_TRACE_CTX``) and ``supervisor.restart_gap``, so
core/goodput.py ``stitch_attempts`` joins the ranks' relaunches.
Single-threaded: one poll loop owns the ranks, the watchdogs, the chaos
clock and the SIGTERM → SIGKILL escalation. Stdlib only.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from distributed_tensorflow_framework_torch.cli.train_resilient import (
    _config_path,
    _yaml_doc,
    find_checkpoint_dir,
    fmt_axes,
    parse_training_params,
)
from distributed_tensorflow_framework_torch.core import (
    cluster,
    faults,
    supervision,
    telemetry,
    tracing,
)


def parse_rejoin_timeout(cmd: list[str]) -> float:
    """The child's ``cluster.rejoin_timeout_s``: the ``--config`` YAML's,
    then the command line's last ``--set cluster.rejoin_timeout_s=``."""
    value = 0.0
    config_path = _config_path(cmd)
    if config_path:
        try:
            value = float((_yaml_doc(config_path).get("cluster") or {}).get(
                "rejoin_timeout_s", value))
        except Exception:
            pass
    for m in re.finditer(r"cluster\.rejoin_timeout_s=([0-9.]+)",
                         " ".join(cmd)):
        value = float(m.group(1))
    return value


# -- cancellation forwarding ----------------------------------------------
_children: dict[int, subprocess.Popen] = {}
_cancelled = False


def _forward_signal(signum, frame):
    global _cancelled
    _cancelled = True
    for child in _children.values():
        if child.poll() is None:
            child.send_signal(signum)


@dataclasses.dataclass
class GangResult:
    """One gang attempt's post-mortem, as the poll loop saw it."""

    rcs: dict[int, int]             # rank → exit code (128 + signal)
    pids: dict[int, int]            # rank → pid (heartbeat scoping)
    first_worker: int | None = None  # root cause: the first nonzero exit
    first_rc: int = 0
    hung: set[int] = dataclasses.field(default_factory=set)
    dropped: set[int] = dataclasses.field(default_factory=set)

    @property
    def done(self) -> bool:
        return all(rc == 0 for rc in self.rcs.values())


def _run_gang_attempt(train_args: list[str], env: dict, *, procs: int,
                      devices_per_proc: int, workdir: str,
                      ckpt_dir: str | None, hb_timeout: float,
                      hb_poll: float, startup_grace: float,
                      rejoin_timeout_s: float, chaos_tick_s: float,
                      grace: float = llc.GRACE_S) -> GangResult:
    """Start one gang and watch it to its end. The loop owns four clocks:
    each rank's heartbeat age (pid-scoped to this attempt), the rejoin
    watchdog before admission, the chaos tick (from the moment every rank
    has beaten) and the SIGTERM → SIGKILL escalation of a shutdown."""
    global _children
    port = llc.free_port()
    children, logs = llc.spawn_gang(
        train_args, procs=procs, devices_per_proc=devices_per_proc,
        workdir=workdir, port=port, base_env=env)
    live = dict(enumerate(children))
    _children = dict(live)
    result = GangResult(rcs={}, pids={w: p.pid for w, p in live.items()})
    hb_paths = {w: (cluster.heartbeat_path(ckpt_dir, w, procs)
                    if ckpt_dir else None) for w in live}
    print(f"train_cluster: launched gang of {procs} "
          f"(coordinator 127.0.0.1:{port}); logs in {workdir}/worker-*.log",
          file=sys.stderr)

    start = time.monotonic()
    admitted: float | None = None
    tick = 0
    stalled: dict[int, float] = {}   # rank → when to SIGCONT it
    shutting_down = False
    term_at = 0.0
    killed: set[int] = set()

    def _begin_shutdown(now: float) -> None:
        nonlocal shutting_down, term_at
        if shutting_down:
            return
        shutting_down = True
        term_at = now
        for w in list(stalled):
            # A stopped rank cannot act on SIGTERM: wake it first.
            proc = live.get(w)
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGCONT)
            del stalled[w]
        for proc in live.values():
            if proc.poll() is None:
                proc.terminate()

    def _exited(w: int, r: int, now: float) -> None:
        del live[w]
        if r < 0:
            r = 128 - r
        result.rcs[w] = r
        if r != 0 and result.first_worker is None:
            result.first_worker, result.first_rc = w, r
        if r != 0:
            # One rank down blocks every collective: SIGTERM the
            # survivors so that the chief saves (rc 83).
            _begin_shutdown(now)

    try:
        while live:
            now = time.monotonic()
            for w, proc in list(live.items()):
                r = proc.poll()
                if r is None:
                    if shutting_down and now - term_at > grace \
                            and w not in killed:
                        proc.kill()
                        killed.add(w)
                    continue
                _exited(w, r, now)
            if not live:
                break
            if not shutting_down:
                ages = {w: (supervision.heartbeat_age_s(hb_paths[w],
                                                        pid=proc.pid)
                            if hb_paths[w] else None)
                        for w, proc in live.items()}
                if hb_timeout > 0 or startup_grace > 0:
                    for w, proc in list(live.items()):
                        age = ages.get(w)
                        stale = (hb_timeout > 0 and age is not None
                                 and age > hb_timeout)
                        no_start = (startup_grace > 0 and age is None
                                    and now - start > startup_grace)
                        if stale or no_start:
                            why = (f"heartbeat stale ({age:.0f}s > "
                                   f"{hb_timeout:.0f}s budget)" if stale
                                   else f"no heartbeat within "
                                        f"{startup_grace:.0f}s startup grace")
                            print(f"train_cluster: worker {w} {why} — "
                                  f"killing pid={proc.pid}", file=sys.stderr)
                            result.hung.add(w)
                            if proc.poll() is None:
                                proc.send_signal(signal.SIGCONT)
                                proc.kill()
                            stalled.pop(w, None)
                if admitted is None:
                    overdue = cluster.decide_rejoin(
                        ages, elapsed_s=now - start,
                        rejoin_timeout_s=rejoin_timeout_s)
                    for w in overdue:
                        print(f"train_cluster: worker {w} failed to rejoin "
                              f"within {rejoin_timeout_s:.0f}s — dropping "
                              f"it from the gang", file=sys.stderr)
                        result.dropped.add(w)
                        proc = live.get(w)
                        if proc is not None and proc.poll() is None:
                            proc.kill()
                    if live and all(ages.get(w) is not None for w in live):
                        admitted = now  # the chaos clock starts here
                if admitted is not None and chaos_tick_s > 0:
                    while admitted + (tick + 1) * chaos_tick_s <= now:
                        tick += 1
                        for fault in faults.fire("gang_chaos", step=tick):
                            w = fault.worker
                            proc = live.get(w) if w is not None else None
                            if proc is None or proc.poll() is not None:
                                print(f"train_cluster: {fault.fault_id} "
                                      f"targets worker {w}, which is not "
                                      f"live — ignored", file=sys.stderr)
                                continue
                            if fault.kind in ("kill_worker", "drop_worker"):
                                if fault.kind == "kill_worker":
                                    print(f"train_cluster: chaos SIGKILL "
                                          f"worker {w} (tick {tick})",
                                          file=sys.stderr)
                                else:
                                    print(f"train_cluster: chaos DROP worker "
                                          f"{w} permanently (tick {tick})",
                                          file=sys.stderr)
                                    result.dropped.add(w)
                                proc.kill()
                                # The killed rank is the root cause: record
                                # it now, before a peer that fails in the
                                # dead collective can be polled first.
                                _exited(w, proc.wait(), now)
                            elif fault.kind == "stall_worker":
                                print(f"train_cluster: chaos SIGSTOP worker "
                                      f"{w} for {fault.seconds:.0f}s "
                                      f"(tick {tick})", file=sys.stderr)
                                proc.send_signal(signal.SIGSTOP)
                                stalled[w] = now + (fault.seconds or 0.0)
                for w, resume_at in list(stalled.items()):
                    if now >= resume_at:
                        proc = live.get(w)
                        if proc is not None and proc.poll() is None:
                            print(f"train_cluster: chaos SIGCONT worker {w}",
                                  file=sys.stderr)
                            proc.send_signal(signal.SIGCONT)
                        del stalled[w]
            time.sleep(min(0.2, hb_poll))
    finally:
        for proc in children:
            if proc.poll() is None:
                try:
                    proc.wait(timeout=grace)
                except subprocess.TimeoutExpired:
                    proc.kill()
            proc.wait()
        for log in logs:
            log.close()
        _children = {}
    for w, proc in enumerate(children):
        result.rcs.setdefault(w, 0 if proc.returncode == 0
                              else abs(proc.returncode))
    return result


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--devices-per-proc", type=int, default=1,
                        help="devices per rank: 1 (a port rank drives one "
                             "device)")
    parser.add_argument("--workdir", default="/tmp/dtf-gang",
                        help="worker log directory")
    parser.add_argument("--max-attempts", type=int, default=10)
    parser.add_argument("--retry-sleep", type=float, default=5.0,
                        help="backoff BASE seconds (doubles per consecutive "
                             "failure, jittered)")
    parser.add_argument("--backoff-max", type=float, default=120.0)
    parser.add_argument("--jitter", type=float, default=0.5)
    parser.add_argument("--heartbeat-timeout", type=float, default=0.0,
                        help="kill a worker whose heartbeat-p<i>.json is "
                             "older than this many seconds and restart the "
                             "gang (0 disables)")
    parser.add_argument("--heartbeat-poll", type=float, default=2.0)
    parser.add_argument("--startup-grace", type=float, default=0.0,
                        help="kill a worker with NO heartbeat this many "
                             "seconds after launch (0 disables)")
    parser.add_argument("--rejoin-timeout", type=float, default=None,
                        help="drop a worker that fails to rejoin within "
                             "this many seconds while peers did, and refit "
                             "the gang (default: the command's "
                             "cluster.rejoin_timeout_s knob; 0 disables)")
    parser.add_argument("--chaos-tick", type=float, default=1.0,
                        help="gang_chaos fault-point tick period in "
                             "seconds (0 disables the chaos clock)")
    parser.add_argument("--crash-loop-threshold", type=int, default=3)
    parser.add_argument("--max-preemptions", type=int, default=50)
    parser.add_argument("--max-reshards", type=int, default=8,
                        help="safety bound on gang refits + child-led "
                             "elastic reshards (they never consume "
                             "attempts)")
    parser.add_argument("--events", default=None,
                        help="supervisor telemetry JSONL (default: "
                             "<checkpoint.directory>/supervisor_events"
                             ".jsonl; '-' disables)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="cli.train arguments after --")
    return parser


def main(argv=None) -> int:
    global _cancelled
    parser = build_parser()
    args = parser.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no cli.train arguments given (put them after `--`)")
    if args.procs < 1:
        parser.error("--procs must be >= 1")
    if args.max_attempts < 1:
        parser.error("--max-attempts must be >= 1")
    if args.devices_per_proc != 1:
        parser.error("--devices-per-proc must be 1: a port rank drives one "
                     "device")

    ckpt_dir, ckpt_enabled = find_checkpoint_dir(cmd)
    if not ckpt_enabled:
        print("train_cluster: WARNING — no checkpoint.directory in the "
              "command; every gang restart will lose all progress AND the "
              "per-worker heartbeat/rejoin watchdogs are blind",
              file=sys.stderr)
    rejoin_timeout = (args.rejoin_timeout if args.rejoin_timeout is not None
                      else parse_rejoin_timeout(cmd))

    events_path = args.events
    if events_path is None and ckpt_dir:
        events_path = os.path.join(ckpt_dir, "supervisor_events.jsonl")
    writer = telemetry.TelemetryWriter(
        None if events_path in (None, "-") else events_path)
    writer.emit_run_meta(
        argv=[sys.argv[0]], supervisor=True, gang=True,
        command=" ".join(cmd), procs=args.procs,
        devices_per_proc=args.devices_per_proc,
        max_attempts=args.max_attempts,
        heartbeat_timeout_s=args.heartbeat_timeout,
        rejoin_timeout_s=rejoin_timeout, checkpoint_dir=ckpt_dir or "")

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _forward_signal)
        except (ValueError, OSError):  # not the main thread
            pass

    # The gang's one causal root: supervisor.run → supervisor.attempt (its
    # context in every rank's DTF_TRACE_CTX) → supervisor.restart_gap.
    tracer = tracing.Tracer(writer, service="supervisor")
    flightrec = tracing.FlightRecorder(
        512, dump_dir=ckpt_dir or args.workdir, tracer=tracer).attach(writer)
    flightrec.install_sigusr1()
    root = tracer.start("supervisor.run", None, procs=args.procs,
                        command=" ".join(cmd)[:200])

    env = dict(os.environ)
    breaker = cluster.GangBreaker(args.crash_loop_threshold)
    cur_sizes, cur_batch, cur_accum = parse_training_params(cmd)
    active = args.procs
    rc = 1
    attempt = failures = preemptions = reshards = 0
    prev_end_mono: float | None = None
    try:
        while attempt < args.max_attempts:
            attempt += 1
            if prev_end_mono is not None:
                tracer.emit_span(
                    "supervisor.restart_gap", root,
                    start_mono=prev_end_mono, end_mono=time.monotonic(),
                    before_attempt=attempt)
            attempt_span = tracer.start(
                "supervisor.attempt", root, attempt=attempt, gang=active)
            env[tracing.TRACE_CTX_ENV] = attempt_span.context().encode()
            print(f"train_cluster: attempt {attempt}/{args.max_attempts} "
                  f"(gang of {active})", file=sys.stderr)
            res = _run_gang_attempt(
                cmd, env, procs=active,
                devices_per_proc=args.devices_per_proc,
                workdir=args.workdir, ckpt_dir=ckpt_dir,
                hb_timeout=args.heartbeat_timeout,
                hb_poll=args.heartbeat_poll,
                startup_grace=args.startup_grace,
                rejoin_timeout_s=rejoin_timeout,
                chaos_tick_s=args.chaos_tick)
            attempt_span.end(
                status="ok" if res.done else f"rc_{res.first_rc}",
                rc=res.first_rc, worker=res.first_worker,
                hung=sorted(res.hung), dropped=sorted(res.dropped))
            prev_end_mono = time.monotonic()
            rc = res.first_rc or 0
            worker = res.first_worker
            # The failing rank's own heartbeat, scoped to this attempt's
            # process, so that a predecessor's cannot fake progress.
            last_step = None
            if worker is not None and ckpt_dir:
                hb = supervision.read_heartbeat(
                    cluster.heartbeat_path(ckpt_dir, worker, active))
                if hb and hb.get("pid") in (None, res.pids.get(worker)):
                    last_step = hb.get("last_completed_step",
                                       hb.get("step"))
            ckpt_step = latest_committed_step(ckpt_dir) if ckpt_dir else None

            if res.done:
                print(f"train_cluster: done (attempt {attempt})",
                      file=sys.stderr)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt, rc=0, classification="done",
                            process_id=0, process_count=active,
                            last_step=last_step, ckpt_step=ckpt_step)
                return 0
            hung = worker in res.hung
            if _cancelled or rc in (130, 143):
                print(f"train_cluster: gang cancelled (rc={rc}) — not "
                      "retrying", file=sys.stderr)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt, rc=rc,
                            classification="cancelled", process_id=worker,
                            process_count=active, last_step=last_step,
                            ckpt_step=ckpt_step)
                return rc

            if res.dropped:
                # A rank lost for good: refit to the survivors, a topology
                # change that uses no attempt and never feeds the breaker.
                survivors = active - len(res.dropped)
                reshards += 1
                attempt -= 1
                for w in res.dropped:
                    breaker.record(w, rc=rc, last_step=last_step,
                                   ckpt_step=ckpt_step, transient=True)
                if survivors < 1:
                    print("train_cluster: every worker dropped — giving up",
                          file=sys.stderr)
                    return rc or 1
                try:
                    refit = cluster.decide_refit(
                        cur_sizes, cur_batch, cur_accum,
                        process_count=survivors,
                        devices_per_proc=args.devices_per_proc)
                except cluster.ClusterSpecError as e:
                    print(f"train_cluster: {e} — giving up", file=sys.stderr)
                    return rc or 1
                if not refit.batch_preserved:
                    print("train_cluster: WARNING — could not preserve the "
                          f"effective batch across {fmt_axes(cur_sizes)} -> "
                          f"{fmt_axes(refit.sizes)}", file=sys.stderr)
                env[supervision.ELASTIC_OVERRIDES_ENV] = ",".join(
                    refit.overrides)
                print(f"train_cluster: gang refit #{reshards} — workers "
                      f"{sorted(res.dropped)} lost, {active} -> {survivors} "
                      f"processes ({refit.n_devices} devices), mesh "
                      f"{fmt_axes(cur_sizes)} -> {fmt_axes(refit.sizes)}, "
                      f"global_batch {cur_batch} -> {refit.global_batch}, "
                      f"grad_accum {cur_accum} -> {refit.grad_accum} — "
                      "relaunching immediately", file=sys.stderr)
                writer.emit(telemetry.KIND_MESH_RESIZED,
                            attempt=attempt + 1, rc=rc, reshards=reshards,
                            from_axes=dict(cur_sizes),
                            to_axes=dict(refit.sizes),
                            visible_devices=refit.n_devices,
                            process_count=survivors,
                            dropped_workers=sorted(res.dropped),
                            global_batch=refit.global_batch,
                            grad_accum=refit.grad_accum,
                            effective_batch_preserved=refit.batch_preserved,
                            overrides=" ".join(refit.overrides),
                            last_step=last_step, ckpt_step=ckpt_step)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt + 1, rc=rc,
                            classification="gang_refit", reshards=reshards,
                            process_id=worker, process_count=survivors,
                            last_step=last_step, ckpt_step=ckpt_step)
                cur_sizes, cur_batch, cur_accum = (
                    refit.sizes, refit.global_batch, refit.grad_accum)
                active = survivors
                if reshards >= args.max_reshards:
                    print("train_cluster: topology churn exceeded "
                          f"--max-reshards={args.max_reshards} — giving up",
                          file=sys.stderr)
                    return rc
                continue

            if rc == supervision.GRACEFUL_PREEMPT_RC:
                # The first exit was 83: the gang was preempted from
                # outside (this supervisor SIGTERMs only after a failure).
                preemptions += 1
                attempt -= 1
                print(f"train_cluster: gang preempted (rc={rc}, "
                      f"#{preemptions}) — relaunching immediately",
                      file=sys.stderr)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt + 1, rc=rc,
                            classification="preempted",
                            preemptions=preemptions, process_id=worker,
                            process_count=active, last_step=last_step,
                            ckpt_step=ckpt_step)
                if preemptions >= args.max_preemptions:
                    print("train_cluster: preemption churn exceeded "
                          f"--max-preemptions={args.max_preemptions} — "
                          "giving up", file=sys.stderr)
                    return rc
                continue

            if rc == supervision.ELASTIC_RESHARD_RC:
                # A rank could not build its mesh on the world it saw:
                # refit over the reported devices at the same rank count.
                report = (supervision.read_device_report(ckpt_dir)
                          if ckpt_dir else None)
                visible = (report or {}).get("visible_devices")
                if not visible:
                    failures += 1
                    print(f"train_cluster: attempt {attempt} exited rc={rc} "
                          "(elastic) but left no device report — treating "
                          "as a plain failure", file=sys.stderr)
                    writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                                attempt=attempt, rc=rc,
                                classification="elastic_no_report",
                                process_id=worker, process_count=active,
                                last_step=last_step, ckpt_step=ckpt_step)
                    if worker is not None and breaker.record(
                            worker, rc=rc, last_step=last_step,
                            ckpt_step=ckpt_step):
                        print("train_cluster: CRASH LOOP — not retrying",
                              file=sys.stderr)
                        return rc
                    continue
                reshards += 1
                attempt -= 1
                try:
                    fitted = supervision.fit_axis_sizes(cur_sizes,
                                                        int(visible))
                except ValueError as e:
                    print(f"train_cluster: no mesh fits {visible} devices "
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
                    new_batch, new_accum = cur_batch, cur_accum
                overrides = [f"mesh.{a}={v}" for a, v in fitted.items()]
                overrides.append("checkpoint.allow_reshard=true")
                if preserved:
                    overrides += [f"data.global_batch_size={new_batch}",
                                  f"train.grad_accum_steps={new_accum}"]
                env[supervision.ELASTIC_OVERRIDES_ENV] = ",".join(overrides)
                print(f"train_cluster: elastic reshard #{reshards} "
                      f"(rc={rc}) — mesh {fmt_axes(cur_sizes)} -> "
                      f"{fmt_axes(fitted)} on {visible} devices — "
                      "relaunching immediately", file=sys.stderr)
                writer.emit(telemetry.KIND_MESH_RESIZED,
                            attempt=attempt + 1, rc=rc, reshards=reshards,
                            from_axes=dict(cur_sizes), to_axes=dict(fitted),
                            visible_devices=int(visible),
                            process_count=active, global_batch=new_batch,
                            grad_accum=new_accum,
                            effective_batch_preserved=preserved,
                            overrides=" ".join(overrides),
                            last_step=last_step, ckpt_step=ckpt_step)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt + 1, rc=rc,
                            classification="elastic_reshard",
                            reshards=reshards, process_id=worker,
                            process_count=active, last_step=last_step,
                            ckpt_step=ckpt_step)
                cur_sizes, cur_batch, cur_accum = fitted, new_batch, new_accum
                if reshards >= args.max_reshards:
                    print("train_cluster: topology churn exceeded "
                          f"--max-reshards={args.max_reshards} — giving up",
                          file=sys.stderr)
                    return rc
                continue

            if rc == supervision.ANOMALY_ESCALATION_RC:
                failures += 1
                print(f"train_cluster: attempt {attempt} exited rc={rc} "
                      f"(persistent_anomaly on worker {worker}; "
                      f"last_step={last_step}, ckpt_step={ckpt_step})",
                      file=sys.stderr)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt, rc=rc,
                            classification="persistent_anomaly",
                            process_id=worker, process_count=active,
                            last_step=last_step, ckpt_step=ckpt_step)
                if worker is not None:
                    breaker.record(worker, rc=rc, last_step=last_step,
                                   ckpt_step=ckpt_step, transient=True)
                if attempt < args.max_attempts:
                    delay = supervision.backoff_seconds(
                        failures, base=args.retry_sleep,
                        cap=args.backoff_max, jitter=args.jitter)
                    print(f"train_cluster: backing off {delay:.1f}s",
                          file=sys.stderr)
                    time.sleep(delay)
                continue

            if worker is not None and not hung and llc.is_bind_failure(
                    llc.log_tail(llc.log_path(args.workdir, worker))):
                # Rank 0 lost the free-port bind race at start-up: the
                # launch's noise, not a training failure; a fresh port
                # (chosen per attempt) at no cost.
                attempt -= 1
                print(f"train_cluster: worker {worker} lost the port-bind "
                      "race — relaunching the gang on a fresh port",
                      file=sys.stderr)
                writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                            attempt=attempt + 1, rc=rc,
                            classification="port_race", process_id=worker,
                            process_count=active, last_step=last_step,
                            ckpt_step=ckpt_step)
                continue

            failures += 1
            classification = "hung" if hung else "crashed"
            print(f"train_cluster: attempt {attempt} exited rc={rc} "
                  f"({classification} on worker {worker}, "
                  f"last_step={last_step}, ckpt_step={ckpt_step})",
                  file=sys.stderr)
            writer.emit(telemetry.KIND_SUPERVISOR_ATTEMPT,
                        attempt=attempt, rc=rc, classification=classification,
                        hung=hung, process_id=worker, process_count=active,
                        last_step=last_step, ckpt_step=ckpt_step)
            flightrec.dump(f"worker {worker} {classification} (rc={rc})")
            if worker is not None:
                # The next attempt rewrites the log: show its end now.
                llc._report_failure(args.workdir, worker, rc)
            if worker is not None and breaker.record(
                    worker, rc=rc, last_step=last_step, ckpt_step=ckpt_step,
                    hung=hung):
                report = breaker.report(worker)
                print(f"train_cluster: CRASH LOOP on worker {worker} — "
                      "deterministic failure, not retrying:\n"
                      + json.dumps(report, indent=2), file=sys.stderr)
                writer.emit(telemetry.KIND_CRASH_LOOP, **report)
                return rc
            if attempt < args.max_attempts:
                delay = supervision.backoff_seconds(
                    failures, base=args.retry_sleep, cap=args.backoff_max,
                    jitter=args.jitter)
                print(f"train_cluster: backing off {delay:.1f}s",
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
