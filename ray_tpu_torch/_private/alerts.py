"""Head-side SLO alert engine: the stateful fire/resolve machine.

``util.slo`` owns the pure burn-rate math; this module owns the per-rule
state machine the head's ``head-alerts`` thread ticks against the drained
metric series:

* a rule whose evaluation breaches FIRES immediately — the multi-window
  burn-rate condition is its own damping (the slow window must agree), so
  an extra pending phase would only delay the page;
* a firing rule RESOLVES only after ``resolve_after_s`` of continuously
  clean evaluations (flapping hysteresis — one good window mid-incident
  must not close and re-open the alert);
* every transition lands in the flight recorder (``alert.fire`` /
  ``alert.resolve`` events, visible to ``obs events``/``obs req`` drains
  and crash flushes) and in the manager's state for ``obs alerts`` /
  ``/api/alerts``;
* firing alerts labeled ``{"serve": "upscale"}`` feed the serve
  autoscaler: a burning latency SLO adds one replica of upscale pressure
  (``serve/_private/controller.desired_replicas``).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.util import slo as _slo

OK = "OK"
FIRING = "FIRING"
RESOLVED = "RESOLVED"  # terminal display state until the next breach


class _RuleState:
    __slots__ = (
        "status", "since", "last_value", "last_detail", "clear_since",
        "fired_count", "last_transition",
    )

    def __init__(self):
        self.status = OK
        self.since: Optional[float] = None
        self.last_value = 0.0
        self.last_detail: dict = {}
        self.clear_since: Optional[float] = None
        self.fired_count = 0
        self.last_transition: Optional[float] = None


class AlertManager:
    """Evaluates a rule set against merged series and tracks transitions."""

    def __init__(self, rules: Optional[list] = None):
        self._lock = threading.Lock()
        self.rules = list(rules) if rules is not None else _slo.default_rules()
        self._states: dict[str, _RuleState] = {r.name: _RuleState() for r in self.rules}

    def set_rules(self, rules: list) -> None:
        with self._lock:
            self.rules = list(rules)
            for r in self.rules:
                self._states.setdefault(r.name, _RuleState())

    def evaluate(self, merged: dict, now: Optional[float] = None) -> list[dict]:
        """One pass over every rule. Returns the transitions that happened
        (``[{"rule", "to", "value"}...]``); each is also recorded as an
        ``alert.*`` flight-recorder event in this (the head's) process."""
        now = time.time() if now is None else now
        transitions = []
        with self._lock:
            for rule in self.rules:
                st = self._states[rule.name]
                try:
                    res = _slo.evaluate_rule(rule, merged, now)
                except Exception as e:  # a broken rule must not kill the rest
                    res = {"breached": False, "value": 0.0,
                           "detail": {"error": repr(e)}}
                st.last_value = float(res.get("value", 0.0))
                st.last_detail = dict(res.get("detail") or {})
                if res["breached"]:
                    st.clear_since = None
                    if st.status != FIRING:
                        st.status = FIRING
                        st.since = now
                        st.fired_count += 1
                        st.last_transition = now
                        transitions.append(
                            {"rule": rule.name, "to": FIRING, "value": st.last_value}
                        )
                        _events.record(
                            "alert.fire", rule=rule.name, value=st.last_value,
                            labels=dict(rule.labels), metric=rule.metric,
                            **{k: v for k, v in st.last_detail.items()
                               if isinstance(v, (int, float))},
                        )
                elif st.status == FIRING:
                    if st.clear_since is None:
                        st.clear_since = now
                    if now - st.clear_since >= rule.resolve_after_s:
                        st.status = RESOLVED
                        st.last_transition = now
                        transitions.append(
                            {"rule": rule.name, "to": RESOLVED, "value": st.last_value}
                        )
                        _events.record(
                            "alert.resolve", rule=rule.name, value=st.last_value,
                            firing_s=round(now - (st.since or now), 3),
                        )
        return transitions

    def state(self) -> list[dict]:
        """Per-rule view for ``obs alerts`` / ``/api/alerts``."""
        with self._lock:
            out = []
            for rule in self.rules:
                st = self._states[rule.name]
                out.append(
                    {
                        "rule": rule.name,
                        "metric": rule.metric,
                        "kind": rule.kind,
                        "status": st.status,
                        "value": st.last_value,
                        "detail": st.last_detail,
                        "since": st.since,
                        "fired_count": st.fired_count,
                        "labels": dict(rule.labels),
                        "description": rule.description,
                    }
                )
            return out

    def firing(self) -> list[dict]:
        return [a for a in self.state() if a["status"] == FIRING]
