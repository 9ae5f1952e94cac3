"""The port's autoscaler and tenant QoS (serve/autoscale.py and the
router's actuation of them) held to the JAX package's.

The pure policy first: snapshot sequences made from a numpy seed go
through the JAX and the port ``Autoscaler.decide`` with the same knobs,
the same clock sequences through both ``TenantQuotas``, tenant names
through both ``priority_of``, and the traffic fault specs through both
parsers: every decision, verdict, class and error is equal. Then the
router's front door and control loop over tests/test_autoscale.py's
stub replicas and fake launcher, once per package (tests/test_torch_fleet
``both``): quota 429 with Retry-After, priority-ordered shedding at exact
capacity, the stampede reserve, ``X-DTF-Model`` pinning and the models
rollup, the reload scoped by digest and count, scale up then drain down,
the spike window, and the KIND_SCALE / KIND_ADMISSION rollups — equal
observations, and the port's showing what tests/test_autoscale.py
asserts of the JAX router.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np
import pytest

from distributed_tensorflow_framework_torch.core import faults as pfaults
from distributed_tensorflow_framework_torch.serve import autoscale as pasc
from distributed_tensorflow_framework_tpu.core import faults as jfaults
from distributed_tensorflow_framework_tpu.serve import autoscale as jasc
from tests.test_autoscale import FakeProc, StubReplica
from tests.test_torch_fleet import (  # noqa: F401 — the autouse fixture
    Fleet,
    _clean_plans,
    both,
    post,
)


# ------------------------------------------------------ policy: scaling


def _knobs(rng):
    down = float(rng.uniform(0.05, 0.45))
    return dict(min_replicas=int(rng.integers(1, 3)),
                max_replicas=int(rng.integers(3, 7)),
                up_threshold=float(rng.uniform(down + 0.05, 1.2)),
                down_threshold=down,
                cooldown_s=float(rng.choice([0.0, 2.0, 10.0])), now=100.0)


def _snapshots(rng, n):
    t = 100.0
    for _ in range(n):
        t += float(rng.choice([0.0, 0.5, 1.0, 3.0, 11.0]))
        admitted = int(rng.integers(0, 6))
        booting = int(rng.choice([0, 0, 0, 1]))
        yield t, dict(
            admitted=admitted, alive=admitted + booting, booting=booting,
            draining=int(rng.choice([0, 0, 0, 1])),
            give_up=int(rng.choice([0, 0, 0, 0, 1])),
            load=float(rng.uniform(0, 10) * max(admitted, 1)),
            capacity=int(rng.choice([1, 4, 8])),
            shed_delta=int(rng.choice([0, 0, 0, 0, 2])))


@pytest.mark.parametrize("seed", range(6))
def test_autoscaler_decisions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    knobs = _knobs(rng)
    ours, ref = pasc.Autoscaler(**knobs), jasc.Autoscaler(**knobs)
    decided = 0
    for now, snap in _snapshots(rng, 400):
        a = ours.decide(pasc.FleetSnapshot(**snap), now=now)
        b = ref.decide(jasc.FleetSnapshot(**snap), now=now)
        assert (a and a.to_dict()) == (b and b.to_dict()), (now, snap)
        assert ours.last_pressure == ref.last_pressure
        assert pasc.FleetSnapshot(**snap).pressure() == \
            jasc.FleetSnapshot(**snap).pressure()
        decided += a is not None
    assert decided > 0  # the sequence reached both kinds of verdict


BAD_KNOBS = [dict(min_replicas=0), dict(min_replicas=4, max_replicas=2),
             dict(up_threshold=0.25, down_threshold=0.75),
             dict(down_threshold=0.0)]


@pytest.mark.parametrize("bad", BAD_KNOBS)
def test_autoscaler_rejects_degenerate_knobs_alike(bad):
    knobs = {**dict(min_replicas=1, max_replicas=4, up_threshold=0.75,
                    down_threshold=0.25, cooldown_s=10.0), **bad}
    with pytest.raises(ValueError) as ours:
        pasc.Autoscaler(**knobs)
    with pytest.raises(ValueError) as ref:
        jasc.Autoscaler(**knobs)
    assert str(ours.value) == str(ref.value)


TENANTS = ["high", "default", "batch", "batch:nightly-eval", "gold-customer",
           None, "", "high:team-a", "typo:x", ":", "HIGH"]


@pytest.mark.parametrize("default_class", ["default", "batch", "high",
                                           "nonsense"])
def test_priority_of_equals_jax(default_class):
    assert pasc.PRIORITY_CLASSES == jasc.PRIORITY_CLASSES
    for tenant in TENANTS:
        assert pasc.priority_of(tenant, default_class=default_class) == \
            jasc.priority_of(tenant, default_class=default_class), tenant


# ------------------------------------------------------- policy: quotas


@pytest.mark.parametrize("rate, burst, seed", [
    (2.0, 2, 0), (2.5, 0, 1), (0.2, 0, 2), (10.0, 3, 3), (0.0, 0, 4)])
def test_quota_verdicts_equal_jax(rate, burst, seed):
    """The same clock sequence (steps forward, repeats and steps back)
    and tenants through both token buckets: equal verdicts and tokens."""
    rng = np.random.default_rng(seed)
    ours, ref = pasc.TenantQuotas(rate, burst), jasc.TenantQuotas(rate, burst)
    assert (ours.burst, ours.enabled) == (ref.burst, ref.enabled)
    t = 100.0
    for _ in range(500):
        t += float(rng.choice([0.0, 0.01, 0.1, 0.4, 1.0, -0.3]))
        tenant = str(rng.choice(["high", "batch", "batch:etl"]))
        a, b = ours.admit(tenant, now=t), ref.admit(tenant, now=t)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ours.snapshot() == ref.snapshot()


def test_quota_concurrent_race_for_one_remaining_token():
    q = pasc.TenantQuotas(1e-9, burst=1)
    start = threading.Barrier(12)
    verdicts, lock = [], threading.Lock()

    def worker():
        start.wait()
        v = q.admit("batch", now=500.0)
        with lock:
            verdicts.append(v.ok)

    threads = [threading.Thread(target=worker) for _ in range(12)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    assert sum(verdicts) == 1 and len(verdicts) == 12


# ------------------------------------------------- traffic-shaped chaos


FLEET_SPECS = ["spike:6:8s,tenant_stampede:3:4s", "tenant_stampede:2",
               "kill_replica:1:3,stall_replica:2:10s,corrupt_reload:v2",
               "stall_replica:1:0,spike:0.5:1", "kill_replica:0"]
BAD_SPECS = ["spike:0:8s", "spike:6:0", "spike:nope", "tenant_stampede:0",
             "tenant_stampede:1:0s", "tenant_stampede:x", "kill_replica:-1",
             "kill_replica:0:0", "stall_replica:nope", "stall_replica:-1:3"]


@pytest.mark.parametrize("spec", FLEET_SPECS)
def test_fleet_fault_specs_parse_alike(spec):
    ours = pfaults.FaultPlan.parse(spec).faults
    ref = jfaults.FaultPlan.parse(spec).faults
    assert [dataclasses.asdict(f) for f in ours] == [
        dataclasses.asdict(f) for f in ref]
    assert [f.point for f in ours] == [f.point for f in ref]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fleet_fault_specs_refused_alike(spec):
    with pytest.raises(ValueError) as ours:
        pfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as ref:
        jfaults.FaultPlan.parse(spec)
    assert str(ours.value) == str(ref.value)


def _firings(pkg):
    plan = pkg.faults.FaultPlan.parse(
        "kill_replica:0:2,tenant_stampede:3:4s,spike:6:8s,corrupt_reload:v2")
    points = [("fleet_chaos", 1), ("fleet_chaos", 2), ("fleet_chaos", 2),
              ("fleet_chaos", 3), ("fleet_reload", None),
              ("fleet_reload", None)]
    return [[f.kind for f in plan.fire(point, step=step)]
            for point, step in points]


def test_fleet_faults_fire_at_their_points():
    assert both(_firings) == [["spike"], ["kill_replica"], [],
                              ["tenant_stampede"], ["corrupt_reload"], []]


# ----------------------------------------------- router QoS front door


def view(resp, *keys):
    status, payload, headers = resp
    return (status, *(payload.get(k) for k in keys),
            headers.get("X-DTF-Replica"))


def _quota(pkg):
    fleet = Fleet(pkg, [StubReplica()], learned=True, tenant_quota_rps=1.0,
                  tenant_quota_burst=1)
    try:
        first = post(fleet.url, headers={"X-DTF-Tenant": "high:team-a"})
        second = post(fleet.url, headers={"X-DTF-Tenant": "high:team-a"})
        other = post(fleet.url, headers={"X-DTF-Tenant": "batch:etl"})
        tenants = fleet.router.fleet_healthz()["fleet"]["tenants"]
    finally:
        fleet.close()
    retry_after = float(second[2]["Retry-After"])
    return {"replies": [view(r, "retryable", "tenant")
                        for r in (first, second, other)],
            "retry_after_ok": 0 < retry_after <= 1.0, "tenants": tenants}


def test_quota_breach_answers_429_with_retry_after():
    out = both(_quota)
    assert [r[0] for r in out["replies"]] == [200, 429, 200]
    assert out["replies"][1][1:3] == (True, "high:team-a")
    assert out["retry_after_ok"]
    assert out["tenants"]["high:team-a"] == {"routed": 1, "shed": 0,
                                             "quota_rejected": 1}
    assert out["tenants"]["batch:etl"]["routed"] == 1


def _priority(pkg):
    stub = StubReplica()
    stub.queue_depth = 2
    fleet = Fleet(pkg, [stub], learned=True, queue_capacity=3,
                  tenant_priority_reserve=1, fleet_shed_retry_after_s=1.5)
    try:
        replies = []
        for tenant in ("batch", "default", "high"):
            r = post(fleet.url, headers={"X-DTF-Tenant": tenant})
            replies.append(view(r, "shed", "tenant") + (
                r[2].get("Retry-After"),))
        tenants = fleet.router.fleet_healthz()["fleet"]["tenants"]
    finally:
        fleet.close()
    return {"replies": replies, "tenants": tenants}


def test_shedding_is_priority_ordered_at_exact_capacity():
    out = both(_priority)
    assert out["replies"] == [(503, True, "batch", None, "1.5"),
                              (503, True, "default", None, "1.5"),
                              (200, None, None, "r0", None)]
    assert out["tenants"]["high"] == {"routed": 1, "shed": 0,
                                      "quota_rejected": 0}
    assert out["tenants"]["batch"]["shed"] == 1


def _stampede(pkg):
    fleet = Fleet(pkg, [StubReplica()], learned=True, queue_capacity=4,
                  tenant_priority_reserve=1)
    try:
        fault = pkg.faults.FaultPlan.parse("tenant_stampede:1:30s").faults[0]
        fleet.router._apply_chaos(fault)
        during = [post(fleet.url, headers={"X-DTF-Tenant": t})[0]
                  for t in ("batch", "default", "high")]
        with fleet.router._lock:
            fleet.router._stampede_until = 0.0
        after = post(fleet.url, headers={"X-DTF-Tenant": "batch"})[0]
    finally:
        fleet.close()
    return during + [after]


def test_tenant_stampede_window_spares_reserved_headroom():
    assert both(_stampede) == [503, 503, 200, 200]


def _models(pkg):
    fleet = Fleet(pkg, [StubReplica(digest="modelA-1111"),
                        StubReplica(digest="modelB-2222")], learned=True)
    try:
        replies = [view(post(fleet.url, headers={"X-DTF-Model": m}))
                   for m in ("modelA", "modelA", "modelA", "modelB",
                             "modelC")]
        models = fleet.router.fleet_healthz()["fleet"]["models"]
    finally:
        fleet.close()
    return {"replies": replies, "models": models}


def test_model_header_pins_routing_and_models_rollup():
    out = both(_models)
    assert out["replies"] == [(200, "r0")] * 3 + [(200, "r1"), (503, None)]
    assert out["models"] == {"modelA-1111": {"replicas": 1, "routed": 3},
                             "modelB-2222": {"replicas": 1, "routed": 1}}


def _scoped(pkg):
    stubs = [StubReplica(digest="modelA-1111"),
             StubReplica(digest="modelB-2222")]
    fleet = Fleet(pkg, stubs, learned=True, serve=False)
    try:
        by_digest = fleet.router.rolling_reload("v2", only_digest="modelB")
        reloads_1 = [s.reloads for s in stubs]
        by_count = fleet.router.rolling_reload("v3", count=1)
        reloads_2 = [s.reloads for s in stubs]
    finally:
        fleet.close()
    return [[r["replica"] for r in by_digest[0]], by_digest[1], reloads_1,
            [r["replica"] for r in by_count[0]], by_count[1], reloads_2]


def test_rolling_reload_scoped_by_digest_and_count():
    assert both(_scoped) == [["r1"], True, [0, 1], ["r0"], True, [1, 1]]


def _scale(pkg, tmp_path):
    d = tmp_path / pkg.name
    d.mkdir()
    stubs = [StubReplica(), StubReplica()]
    procs = {}

    def launcher(index):
        procs[index] = FakeProc()
        endpoint = d / f"r{index}-endpoint.json"
        endpoint.write_text(json.dumps({"url": stubs[index].url}))
        return procs[index], str(endpoint)

    fleet = Fleet(pkg, stubs[:1], learned=True, serve=False,
                  launcher=launcher, writer_path=d / "events.jsonl",
                  queue_capacity=8, fleet_autoscale=True,
                  fleet_min_replicas=1, fleet_max_replicas=2,
                  fleet_scale_up_threshold=0.5,
                  fleet_scale_down_threshold=0.2, fleet_scale_cooldown_s=0.0,
                  drain_timeout_s=5.0)
    fleet.stubs = stubs
    router = fleet.router
    seen = []
    try:
        with router._lock:
            router._replicas[0].last_health["engine"]["queue_depth"] = 7
        router._autoscale_tick(time.monotonic())
        seen.append([r.state for r in router._replicas])
        router._autoscale_tick(time.monotonic())  # booting: no double spawn
        seen.append(len(router._replicas))
        router._probe_replica(router._replicas[1], time.monotonic())
        seen.append(router._replicas[1].state)
        with router._lock:
            router._replicas[0].last_health["engine"]["queue_depth"] = 0
        router._autoscale_tick(time.monotonic())
        victim = router._replicas[1]
        seen.append((victim.state, victim.retiring))
        router._autoscale_tick(time.monotonic())
        router._advance_retirements(time.monotonic())
        seen.append((victim.state, procs[1].terminated))
        health = router.fleet_healthz()["fleet"]
    finally:
        fleet.close()
    summary = pkg.telemetry.summarize_events(str(d / "events.jsonl"))
    scaling = summary["fleet"]["scaling"]
    return {"seen": seen, "router": health["router"],
            "autoscale": {k: v for k, v in health["autoscale"].items()
                          if k != "pressure"},
            "scaling": scaling}


def test_router_scales_up_then_drains_back_down(tmp_path):
    out = both(_scale, tmp_path)
    assert out["seen"] == [["admitted", "ejected"], 2, "admitted",
                           ("draining", True), ("retired", True)]
    assert out["router"]["scale_ups"] == 1
    assert out["router"]["scale_downs"] == 1
    assert out["autoscale"] == {"enabled": True, "min_replicas": 1,
                                "max_replicas": 2}
    assert [e["action"] for e in out["scaling"]["events"]] == ["up", "down"]


def _spike(pkg):
    fleet = Fleet(pkg, [StubReplica()], learned=True, queue_capacity=8,
                  fleet_autoscale=True, fleet_min_replicas=1,
                  fleet_max_replicas=2, fleet_scale_up_threshold=0.5,
                  fleet_scale_down_threshold=0.2, fleet_scale_cooldown_s=0.0)
    try:
        fleet.router._apply_chaos(
            pkg.faults.FaultPlan.parse("spike:6:30s").faults[0])
        fleet.router._autoscale_tick(time.monotonic())
        pressure = fleet.router._autoscaler.last_pressure
        replicas = len(fleet.router._replicas)
        status = post(fleet.url, headers={"X-DTF-Tenant": "batch"})[0]
    finally:
        fleet.close()
    return [pressure, replicas, status]


def test_spike_window_raises_pressure_without_touching_traffic():
    assert both(_spike) == [pytest.approx(0.75), 1, 200]


def _admission_rollup(pkg, tmp_path):
    events = str(tmp_path / f"{pkg.name}-scale.jsonl")
    writer = pkg.telemetry.TelemetryWriter(events)
    t = pkg.telemetry
    writer.emit(t.KIND_SCALE, metrics={"pressure": 0.91}, action="up",
                reason="pressure 0.910 >= 0.75", replica="r2",
                from_replicas=2, to_replicas=3)
    writer.emit(t.KIND_SCALE, metrics={"pressure": 0.12}, action="down",
                reason="pressure 0.120 <= 0.25", replica="r2",
                from_replicas=3, to_replicas=2)
    for lat in (4.0, 6.0, 8.0):
        writer.emit(t.KIND_SERVE_ROUTE,
                    metrics={"latency_ms": lat, "retries": 0, "status": 200},
                    replica="r0", shed=False, deadline_exceeded=False,
                    tenant="high")
    writer.emit(t.KIND_ADMISSION, tenant="batch", priority=2, verdict="shed",
                retry_after_s=1.0)
    writer.emit(t.KIND_ADMISSION, tenant="default", priority=1,
                verdict="quota", retry_after_s=0.5)
    writer.close()
    summary = t.summarize_events(events)
    return {"fleet": summary["fleet"],
            "p50": summary["fleet"]["tenants"]["high"]["latency_ms"]["p50"],
            "text": [line for line in t.format_run_summary(
                summary).splitlines() if "scaling" in line
                or "tenant" in line or "fleet" in line]}


def test_scale_and_admission_telemetry_rollup(tmp_path):
    out = both(_admission_rollup, tmp_path)
    fleet = out["fleet"]
    assert fleet["scaling"]["ups"] == 1 and fleet["scaling"]["downs"] == 1
    assert fleet["scaling"]["events"][0] == {
        "action": "up", "reason": "pressure 0.910 >= 0.75",
        "replica": "r2", "from_replicas": 2, "to_replicas": 3,
        "pressure": 0.91}
    assert out["p50"] == pytest.approx(6.0)
    assert fleet["tenants"]["batch"]["shed"] == 1
    assert fleet["tenants"]["default"]["quota_rejected"] == 1
    text = "\n".join(out["text"])
    assert "scaling: 1 up / 1 down" in text and "up->3@0.91" in text
    assert "tenant high: routed 3" in text
