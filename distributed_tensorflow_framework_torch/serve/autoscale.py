"""Fleet autoscaling policy and multi-tenant admission: the port's copy
of ``serve/autoscale.py`` (stdlib only, as there).

Two small, pure pieces the fleet router (serve/fleet.py) composes into its
control loop:

  * :class:`Autoscaler` — the scaling POLICY. The router's prober tick
    hands it a :class:`FleetSnapshot` (queue depth + in-flight over
    admitted capacity, shed delta, boot/crash-loop state) and gets back
    at most one :class:`ScaleDecision` per cooldown window. The policy
    never touches processes: the router actuates, scale-up through the
    same supervised spawn path restarts use (so the crash-loop breaker
    gates both) and scale-down through the same drain path rolling
    reloads use.

  * :class:`TenantQuotas` — per-tenant token buckets for admission
    control. ``admit()`` is the only entry point and is thread-safe:
    concurrent requests racing one remaining token see exactly one
    winner. A breach returns the seconds until the next token, so the
    router can answer 429 with an honest Retry-After.

Priority classes are fixed and ordered best-first: ``high`` (0),
``default`` (1), ``batch`` (2). A tenant header of ``class`` or
``class:anything`` maps to that class; unknown names get the configured
default class. The class number is the number of reserved queue slots
(per ``serve.tenant_priority_reserve``) the request must leave free on a
replica to claim it, which makes shedding strictly priority-ordered under
exact-capacity load.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

__all__ = [
    "Autoscaler",
    "FleetSnapshot",
    "PRIORITY_CLASSES",
    "QuotaVerdict",
    "ScaleDecision",
    "TenantQuotas",
    "priority_of",
]

# Best-first priority order. The value doubles as the number of
# tenant_priority_reserve steps the class gives up in _claim_replica.
PRIORITY_CLASSES = {"high": 0, "default": 1, "batch": 2}


def priority_of(tenant: str | None, *, default_class: str = "default") -> int:
    """Priority of a tenant header value (lower = better).

    The class is the header value itself or its prefix before ``:``
    (``batch:nightly-eval`` is a batch-class tenant named
    ``batch:nightly-eval``); anything unrecognized gets the configured
    default class so a typo degrades to default service, never to a
    crash or to silent high-priority treatment.
    """
    name = (tenant or default_class).partition(":")[0]
    if name not in PRIORITY_CLASSES:
        name = default_class
    return PRIORITY_CLASSES.get(name, PRIORITY_CLASSES["default"])


@dataclasses.dataclass
class FleetSnapshot:
    """One observation of the fleet, taken under the router lock.

    ``alive`` counts replicas that could serve traffic now or soon:
    admitted + booting + restarting, but NOT retired (drained away by a
    scale-down) and NOT given up (crash-loop verdict). The max bound
    applies to ``alive`` so a replica being restarted mid-scale-event
    still occupies its slot — the autoscaler and the restart supervisor
    never race to fill the same hole.
    """

    admitted: int = 0
    alive: int = 0
    booting: int = 0      # spawned but never yet admitted
    draining: int = 0     # scale-down victims still finishing in-flight
    give_up: int = 0      # crash-loop breaker verdicts (supervision)
    load: float = 0.0     # sum of queue_depth + inflight + synthetic
    capacity: int = 1     # per-replica queue_capacity
    shed_delta: int = 0   # sheds since the previous decision

    def pressure(self) -> float:
        """Fleet utilization in [0, inf): load over admitted capacity."""
        if self.admitted <= 0 or self.capacity <= 0:
            return 0.0
        return self.load / float(self.admitted * self.capacity)


@dataclasses.dataclass
class ScaleDecision:
    action: str           # "up" | "down"
    reason: str
    pressure: float
    from_replicas: int    # alive before actuation
    to_replicas: int      # alive after actuation

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Autoscaler:
    """Hysteresis + cooldown + hard bounds around ``FleetSnapshot.pressure``.

    One decision per call, at most one call acted on per cooldown
    window; the router applies it (spawn one / drain one) and calls
    back next tick with a fresh snapshot. Growing one replica at a time
    through the supervised spawn path means a traffic spike produces a
    measured ramp, and a crash-looping artifact (give_up > 0) freezes
    scale-up entirely — more copies of a broken binary is not capacity.
    """

    def __init__(
        self,
        *,
        min_replicas: int,
        max_replicas: int,
        up_threshold: float,
        down_threshold: float,
        cooldown_s: float,
        now: float | None = None,
    ) -> None:
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas={max_replicas} < min_replicas={min_replicas}"
            )
        if not (0.0 < down_threshold < up_threshold):
            raise ValueError(
                f"need 0 < down_threshold={down_threshold} < "
                f"up_threshold={up_threshold} for hysteresis"
            )
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_threshold = up_threshold
        self.down_threshold = down_threshold
        self.cooldown_s = max(0.0, cooldown_s)
        # Allow an immediate first decision: a fleet that boots into a
        # spike should not idle out a full cooldown before reacting.
        t = time.monotonic() if now is None else now
        self._last_action_t = t - self.cooldown_s
        self.last_pressure = 0.0

    def decide(
        self, snap: FleetSnapshot, now: float | None = None
    ) -> ScaleDecision | None:
        """Return the one action warranted by this snapshot, or None."""
        now = time.monotonic() if now is None else now
        pressure = snap.pressure()
        # A shed since the last look means demand already exceeded
        # capacity, whatever the instantaneous queue depths say — treat
        # it as at least up-threshold pressure.
        if snap.shed_delta > 0:
            pressure = max(pressure, self.up_threshold)
        self.last_pressure = pressure
        if snap.admitted <= 0:
            # Nothing healthy to measure: supervision owns this phase.
            return None
        if snap.booting > 0:
            # A spawn is still warming up; judging pressure now would
            # double-count the gap it was spawned to fill.
            return None
        if now - self._last_action_t < self.cooldown_s:
            return None
        if pressure >= self.up_threshold and snap.alive < self.max_replicas:
            if snap.give_up > 0:
                # Crash-loop verdict standing: scale-up would just feed
                # the breaker more corpses of the same artifact.
                return None
            self._last_action_t = now
            return ScaleDecision(
                action="up",
                reason=f"pressure {pressure:.3f} >= {self.up_threshold}",
                pressure=pressure,
                from_replicas=snap.alive,
                to_replicas=snap.alive + 1,
            )
        if (pressure <= self.down_threshold
                and snap.admitted > self.min_replicas
                and snap.alive > self.min_replicas
                and snap.draining == 0):
            self._last_action_t = now
            return ScaleDecision(
                action="down",
                reason=f"pressure {pressure:.3f} <= {self.down_threshold}",
                pressure=pressure,
                from_replicas=snap.alive,
                to_replicas=snap.alive - 1,
            )
        return None


@dataclasses.dataclass
class QuotaVerdict:
    ok: bool
    tenant: str
    retry_after_s: float = 0.0
    tokens_left: float = 0.0


class TenantQuotas:
    """Per-tenant token buckets (``serve.tenant_quota_rps`` / ``_burst``).

    Buckets refill continuously at ``rate_per_s`` up to ``burst`` and
    are created full on a tenant's first request. ``admit`` takes an
    explicit ``now`` for deterministic tests; production callers omit it
    and get the monotonic clock. rate_per_s <= 0 disables enforcement
    (every admit succeeds and no state is kept).
    """

    def __init__(self, rate_per_s: float, burst: int = 0) -> None:
        self.rate_per_s = float(rate_per_s)
        if burst <= 0:
            burst = max(1, math.ceil(self.rate_per_s))
        self.burst = int(burst)
        self._lock = threading.Lock()
        self._buckets: dict[str, list[float]] = {}  # tenant -> [tokens, t]

    @property
    def enabled(self) -> bool:
        return self.rate_per_s > 0

    def admit(self, tenant: str, now: float | None = None) -> QuotaVerdict:
        if not self.enabled:
            return QuotaVerdict(ok=True, tenant=tenant)
        now = time.monotonic() if now is None else now
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = [float(self.burst), now]
                self._buckets[tenant] = bucket
            tokens, last = bucket
            # Refill across however many clock ticks elapsed; a stale
            # (or test-supplied non-monotonic) now never drains tokens.
            tokens = min(
                float(self.burst),
                tokens + max(0.0, now - last) * self.rate_per_s,
            )
            bucket[1] = max(last, now)
            if tokens >= 1.0:
                bucket[0] = tokens - 1.0
                return QuotaVerdict(
                    ok=True, tenant=tenant, tokens_left=bucket[0]
                )
            bucket[0] = tokens
            return QuotaVerdict(
                ok=False,
                tenant=tenant,
                retry_after_s=(1.0 - tokens) / self.rate_per_s,
                tokens_left=tokens,
            )

    def snapshot(self) -> dict[str, float]:
        """Tenant -> tokens remaining (telemetry / healthz)."""
        with self._lock:
            return {t: b[0] for t, b in self._buckets.items()}
