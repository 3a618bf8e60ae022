"""ray_tpu_torch.workflow: durable DAG execution with storage-backed
checkpoints (copy of ``ray_tpu/workflow/__init__.py``).

Reference: ``python/ray/workflow/`` (``workflow_executor.py`` step loop +
``workflow_storage.py`` persisted step results). A workflow is a
``ray_tpu_torch.dag`` graph executed step-by-step with every completed step's
result persisted; re-running (or ``resume``-ing after a crash) skips steps
whose results already exist on storage, so a workflow survives driver death
at the granularity of one step.

    from ray_tpu_torch import workflow

    dag = train.bind(prepare.bind(cfg))
    out = workflow.run(dag, workflow_id="exp1", storage="/data/wf")
    # crash anywhere -> workflow.resume("exp1", storage="/data/wf")

Storage layout (the reference's): ``<storage>/<workflow_id>/`` holds
``meta.json``, ``graph.pkl``, ``events.jsonl``, ``steps/<step id>.pkl``
and ``events_in/<name>.pkl``; virtual actors live under
``<storage>/virtual_actors/<actor id>/state.pkl``. The default root is
``~/ray_tpu_torch_workflows``, apart from the reference's: a stored graph
names its own package's functions.

**Tensors in checkpoints.** Step results, the output, event payloads,
the graph and virtual-actor state are pickled with the object plane's
tensor reduction (``_private.serialization.dumps_with_tensors``), so a
tensor comes back from storage as it arrives through the object plane: a
CPU tensor (bf16 included) on the CPU, a CUDA tensor on the loading
process's current CUDA device — the counterpart of a pickled jax array
coming back on its loader's default device. A loader with no card raises
rather than putting a CUDA tensor on the CPU; save ``t.cpu()`` to read it
anywhere.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import time
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch.dag import DAGNode, FunctionNode, InputNode, MultiOutputNode
from ray_tpu_torch.workflow.virtual_actor import (  # noqa: F401
    get_actor,
    readonly,
    virtual_actor,
)

_DEFAULT_STORAGE = os.path.expanduser("~/ray_tpu_torch_workflows")

STATUS_RUNNING = "RUNNING"
STATUS_SUCCESSFUL = "SUCCESSFUL"
STATUS_FAILED = "FAILED"


class _Store:
    def __init__(self, storage: str, workflow_id: str):
        self.dir = os.path.join(storage, workflow_id)

    def exists(self) -> bool:
        return os.path.isdir(self.dir)

    def _ensure(self):
        # lazy: read-only queries (get_status of a typo id, list_all over a
        # storage root with stray files) must not mutate storage
        os.makedirs(os.path.join(self.dir, "steps"), exist_ok=True)

    def _meta_path(self):
        return os.path.join(self.dir, "meta.json")

    def write_meta(self, **kwargs):
        self._ensure()
        meta = self.read_meta()
        meta.update(kwargs)
        meta["updated_at"] = time.time()
        with open(self._meta_path(), "w") as f:
            json.dump(meta, f)

    def read_meta(self) -> dict:
        try:
            with open(self._meta_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def step_path(self, step_id: str) -> str:
        # continuation steps namespace under their parent ("003_x/001_y"):
        # sub-workflow checkpoints live in a per-step subtree
        return os.path.join(self.dir, "steps", step_id + ".pkl")

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self.step_path(step_id))

    def save_step(self, step_id: str, value: Any):
        self._ensure()
        path = self.step_path(step_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(ser.dumps_with_tensors(value))
        os.replace(tmp, path)  # atomic commit

    def load_step(self, step_id: str) -> Any:
        with open(self.step_path(step_id), "rb") as f:
            return pickle.load(f)

    def save_graph(self, dag: DAGNode, input_args: tuple):
        self._ensure()
        with open(os.path.join(self.dir, "graph.pkl"), "wb") as f:
            # cloudpickle: graphs close over user functions
            f.write(ser.dumps_with_tensors((dag, input_args)))

    def load_graph(self):
        with open(os.path.join(self.dir, "graph.pkl"), "rb") as f:
            return pickle.load(f)

    def append_event(self, event: dict) -> None:
        """Durable event log (reference: workflow event system /
        workflow_executor status callbacks) — one JSON line per event.
        Callers pass events already carrying their ``time``."""
        self._ensure()
        with open(os.path.join(self.dir, "events.jsonl"), "a") as f:
            f.write(json.dumps(event) + "\n")

    def read_events(self) -> list[dict]:
        out = []
        try:
            with open(os.path.join(self.dir, "events.jsonl")) as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        break  # torn tail (crash mid-append): intact prefix wins
        except OSError:
            pass
        return out


class _PrefixStore:
    """Store view for a continuation: step ids namespace under the parent
    step, events share the root workflow's log."""

    def __init__(self, store, prefix: str):
        self._store = store
        self._prefix = prefix

    @property
    def dir(self):
        return self._store.dir

    def has_step(self, step_id: str) -> bool:
        return self._store.has_step(self._prefix + step_id)

    def save_step(self, step_id: str, value: Any):
        self._store.save_step(self._prefix + step_id, value)

    def load_step(self, step_id: str) -> Any:
        return self._store.load_step(self._prefix + step_id)

    def append_event(self, event: dict) -> None:
        self._store.append_event(event)


class Continuation:
    """A step's return value saying "the workflow continues with THIS DAG"
    (reference: ``workflow.continuation`` — dynamic/recursive workflows).
    The sub-DAG executes durably with its steps namespaced under the
    returning step; the step's checkpoint is the sub-workflow's result, so
    a resume never re-enters a finished continuation."""

    def __init__(self, dag: DAGNode, *input_args):
        if not isinstance(dag, DAGNode):
            raise TypeError("continuation(dag) takes a bound DAG node")
        self.dag = dag
        self.input_args = input_args


def continuation(dag: DAGNode, *input_args) -> Continuation:
    return Continuation(dag, *input_args)


class EventNode(DAGNode):
    """A workflow step that blocks until an external event arrives
    (reference: ``workflow.wait_for_event`` + the event-listener system).
    The event payload is the step's (checkpointed) value — a crash after
    the event committed never waits for it again."""

    def __init__(self, name: str, timeout_s: Optional[float] = None, poll_s: float = 0.2):
        super().__init__((), {})
        self.name = name
        self.timeout_s = timeout_s
        self.poll_s = poll_s


def wait_for_event(name: str, timeout_s: Optional[float] = None) -> EventNode:
    return EventNode(name, timeout_s)


def send_event(
    workflow_id: str, name: str, payload: Any = None, storage: Optional[str] = None
) -> None:
    """Deliver an external event to a (possibly not-yet-waiting) workflow.
    Durable: the payload commits to the workflow's storage, so delivery
    survives both driver and sender crashes."""
    store = _Store(storage or _DEFAULT_STORAGE, workflow_id)
    store._ensure()
    evdir = os.path.join(store.dir, "events_in")
    os.makedirs(evdir, exist_ok=True)
    tmp = os.path.join(evdir, name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(ser.dumps_with_tensors(payload))
    os.replace(tmp, os.path.join(evdir, name + ".pkl"))


@ray_tpu_torch.remote(num_cpus=0)
def _await_event(store_dir: str, name: str, timeout_s: Optional[float], poll_s: float):
    """The event-wait step body: poll the durable mailbox (num_cpus=0 — a
    parked waiter must not hold a CPU slot away from real steps)."""
    path = os.path.join(store_dir, "events_in", name + ".pkl")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not os.path.exists(path):
        if deadline is not None and time.monotonic() >= deadline:
            raise TimeoutError(f"workflow event {name!r} not delivered in {timeout_s}s")
        time.sleep(poll_s)
    with open(path, "rb") as f:
        return pickle.load(f)


def _step_ids(dag: DAGNode) -> dict[int, str]:
    """Deterministic id per node: function name + topological index +
    structure hash — stable across process restarts for the same graph."""
    order: list[DAGNode] = []
    seen: set[int] = set()

    def walk(node):
        if not isinstance(node, DAGNode) or id(node) in seen:
            return
        seen.add(id(node))
        for v in list(node._bound_args) + list(node._bound_kwargs.values()):
            walk(v)
        order.append(node)

    walk(dag)
    ids: dict[int, str] = {}
    for idx, node in enumerate(order):
        name = type(node).__name__
        if isinstance(node, FunctionNode):
            # RemoteFunction wraps the user function as ._fn (and
            # update_wrapper copies __name__ onto the wrapper itself)
            name = getattr(
                getattr(node._fn, "_fn", node._fn), "__name__", None
            ) or getattr(node._fn, "__name__", "fn")
        ids[id(node)] = f"{idx:03d}_{name}_{hashlib.sha1(name.encode()).hexdigest()[:6]}"
    return ids


def _execute_durable(
    dag: DAGNode, input_args: tuple, store: _Store, on_event=None
) -> Any:
    """Durable, CONCURRENT DAG execution.

    Steps are submitted eagerly with ObjectRef arguments, so independent
    branches run in parallel across the cluster (reference:
    workflow_executor's in-flight task set) — the scheduler, not this
    loop, decides concurrency. The driver persists each step's result as
    it completes (ray_tpu_torch.wait harvest): crash anywhere and resume()
    re-submits only steps without a checkpoint. Per-step retries are the
    underlying TASK's ``max_retries`` (set via ``.options`` on the remote
    function when binding the DAG). Events go to the durable per-workflow
    log and to ``on_event`` as they happen."""
    ids = _step_ids(dag)
    memo: dict = {}
    inputs = list(input_args)
    for node in dag._collect_inputs():
        memo[id(node)] = inputs.pop(0) if inputs else None

    # steps some OTHER node consumes: continuations are tail-position only
    # (reference semantics) — a mid-DAG consumer is submitted eagerly with
    # the producer's ref and would receive the raw Continuation object, so
    # that shape must fail loudly, not compute garbage
    steps_with_dependents: set[str] = set()
    _seen_dep: set[int] = set()

    def _mark_deps(node):
        if not isinstance(node, DAGNode) or id(node) in _seen_dep:
            return
        _seen_dep.add(id(node))
        for v in list(node._bound_args) + list(node._bound_kwargs.values()):
            if isinstance(v, DAGNode):
                steps_with_dependents.add(ids[id(v)])
                _mark_deps(v)

    _mark_deps(dag)

    def emit(event_type: str, step_id: str) -> None:
        event = {"type": event_type, "step_id": step_id, "time": time.time()}
        store.append_event(event)
        if on_event is not None:
            try:
                on_event(dict(event))
            except Exception:
                pass  # a broken listener must not kill the workflow

    pending: dict[Any, str] = {}  # ref -> step_id (awaiting checkpoint)
    resolved: dict[Any, Any] = {}  # ref -> final value (continuations differ
    # from the raw task result, so materialize must NOT re-get those refs)

    def _deref_lists(v):
        """A MultiOutputNode upstream produces a LIST of in-flight refs:
        nested refs would pickle by value with no dependency edge, so a
        consumer could run before its producers. Materialize list-shaped
        inputs here (only that branch blocks)."""
        from ray_tpu_torch._private.runtime import ObjectRef

        if isinstance(v, list):
            return [
                ray_tpu_torch.get(x) if isinstance(x, ObjectRef) else _deref_lists(x)
                for x in v
            ]
        return v

    def build(node: DAGNode):
        """Returns the node's value (checkpointed) or an ObjectRef
        (submitted, in flight) — WITHOUT blocking, so siblings overlap."""
        key = id(node)
        if key in memo:
            return memo[key]
        step_id = ids[key]
        if store.has_step(step_id):
            memo[key] = store.load_step(step_id)  # checkpointed — skip
            return memo[key]
        args = [_deref_lists(build(a)) if isinstance(a, DAGNode) else a for a in node._bound_args]
        kwargs = {
            k: (_deref_lists(build(v)) if isinstance(v, DAGNode) else v)
            for k, v in node._bound_kwargs.items()
        }
        if isinstance(node, MultiOutputNode):
            value = list(args)  # refs/values; materialized at harvest
        elif isinstance(node, EventNode):
            value = _await_event.remote(
                store.dir, node.name, node.timeout_s, node.poll_s
            )
            pending[value] = step_id
            emit("step_started", step_id)
        elif isinstance(node, FunctionNode):
            # submit, don't wait: ref args chain dependencies through the
            # scheduler; task max_retries = the step's retry budget
            value = node._fn.remote(*args, **kwargs)
            pending[value] = step_id
            emit("step_started", step_id)
        elif hasattr(node, "_cls"):  # ClassNode — uses the DURABLY computed
            # args, but actor handles themselves aren't durable: not
            # checkpointed (reference: virtual actors are a separate system)
            value = node._cls.remote(*args, **kwargs)
        else:
            raise TypeError(f"workflows cannot execute {type(node).__name__}")
        memo[key] = value
        return value

    def harvest(best_effort: bool = False) -> Optional[BaseException]:
        """Checkpoint step results AS THEY COMPLETE, whatever order the
        branches finish in; returns the first step failure (siblings are
        saved before it surfaces — resume then re-runs only the failure
        and its dependents)."""
        failure: Optional[BaseException] = None
        while pending:
            ready, _ = ray_tpu_torch.wait(list(pending), num_returns=1, timeout=None)
            for ref in ready:
                step_id = pending.pop(ref)
                try:
                    value = ray_tpu_torch.get(ref)
                except Exception as e:  # STEP failure (KeyboardInterrupt etc.
                    # propagate immediately — they are driver-level, not steps)
                    emit("step_failed", step_id)
                    if failure is None:
                        failure = e
                    continue
                if isinstance(value, Continuation) and not best_effort:
                    if step_id in steps_with_dependents:
                        emit("step_failed", step_id)
                        if failure is None:
                            failure = TypeError(
                                f"step {step_id!r} returned a continuation but "
                                "has downstream consumers — continuations are "
                                "tail-position only (its consumers were "
                                "submitted eagerly and would receive the raw "
                                "Continuation object)"
                            )
                        continue
                    # dynamic workflow: the step's "result" is a sub-DAG;
                    # execute it durably, namespaced under this step — the
                    # checkpoint below is the continuation's FINAL value
                    emit("continuation_started", step_id)
                    try:
                        value = _execute_durable(
                            value.dag,
                            value.input_args,
                            _PrefixStore(store, step_id + "/"),
                            on_event=on_event,
                        )
                    except Exception as e:  # sub-workflow failed
                        emit("step_failed", step_id)
                        if failure is None:
                            failure = e
                        continue
                resolved[ref] = value
                try:
                    # a save failure is a DRIVER/storage problem, not a step
                    # failure: surface it now rather than re-running a step
                    # that already succeeded on the cluster
                    store.save_step(step_id, value)
                except Exception:
                    if not best_effort:
                        raise
                    continue  # cleanup path: keep draining the other refs
                emit("step_completed", step_id)
        return failure

    try:
        root = build(dag)
    except Exception:
        # a build-phase failure (e.g. materializing a failed MultiOutput
        # branch) must still checkpoint completed siblings before raising —
        # best-effort, so a secondary storage error can't mask the root cause
        try:
            harvest(best_effort=True)
        except Exception:
            pass
        raise
    failure = harvest()
    if failure is not None:
        raise failure

    def materialize(v):
        if isinstance(v, list):
            return [materialize(x) for x in v]
        from ray_tpu_torch._private.runtime import ObjectRef

        if isinstance(v, ObjectRef):
            return resolved[v] if v in resolved else ray_tpu_torch.get(v)
        return v

    return materialize(root)


def _execute_with_retries(
    dag, input_args, store, on_event, max_step_retries: int
) -> Any:
    """Step retries, resume-style (reference: workflow max_retries): a
    failed round re-drives the DAG — checkpointed steps load instantly, so
    each extra round re-runs ONLY the failed step and its dependents.
    (Task-level ``max_retries`` still covers worker-death retries
    underneath; this layer covers application exceptions.)"""
    attempts = 0
    while True:
        try:
            return _execute_durable(dag, input_args, store, on_event=on_event)
        except Exception:
            attempts += 1
            if attempts > max_step_retries:
                raise
            event = {"type": "retry_round", "round": attempts, "time": time.time()}
            store.append_event(event)
            if on_event is not None:
                try:
                    on_event(dict(event))
                except Exception as e:
                    from ray_tpu_torch._private.log_util import warn_throttled

                    warn_throttled("workflow on_event callback", e)


def run(
    dag: DAGNode,
    *input_args,
    workflow_id: Optional[str] = None,
    storage: Optional[str] = None,
    on_event=None,
    max_step_retries: int = 0,
) -> Any:
    """Execute a DAG durably; returns the final result (reference:
    ``workflow.run``). Independent branches run CONCURRENTLY; ``on_event``
    receives {type, step_id, time} dicts live (also persisted — see
    ``get_events``). ``max_step_retries`` re-drives failed rounds
    (checkpointed steps are skipped) — opt-in, since retrying
    non-idempotent steps repeats their side effects."""
    workflow_id = workflow_id or f"wf_{int(time.time() * 1000):x}"
    store = _Store(storage or _DEFAULT_STORAGE, workflow_id)
    store.save_graph(dag, input_args)
    store.write_meta(status=STATUS_RUNNING, workflow_id=workflow_id)
    try:
        out = _execute_with_retries(dag, input_args, store, on_event, max_step_retries)
    except BaseException:
        store.write_meta(status=STATUS_FAILED)
        raise
    store.write_meta(status=STATUS_SUCCESSFUL)
    store.save_step("__output__", out)
    return out


def resume(
    workflow_id: str,
    storage: Optional[str] = None,
    on_event=None,
    max_step_retries: int = 0,
) -> Any:
    """Re-drive an interrupted workflow; completed steps are loaded from
    storage, remaining steps execute (reference: ``workflow.resume``)."""
    store = _Store(storage or _DEFAULT_STORAGE, workflow_id)
    if store.has_step("__output__"):
        return store.load_step("__output__")
    dag, input_args = store.load_graph()
    store.write_meta(status=STATUS_RUNNING)
    try:
        out = _execute_with_retries(dag, input_args, store, on_event, max_step_retries)
    except BaseException:
        store.write_meta(status=STATUS_FAILED)
        raise
    store.write_meta(status=STATUS_SUCCESSFUL)
    store.save_step("__output__", out)
    return out


def get_status(workflow_id: str, storage: Optional[str] = None) -> Optional[str]:
    store = _Store(storage or _DEFAULT_STORAGE, workflow_id)
    if not store.exists():
        return None
    return store.read_meta().get("status")


def get_output(workflow_id: str, storage: Optional[str] = None) -> Any:
    store = _Store(storage or _DEFAULT_STORAGE, workflow_id)
    if not store.has_step("__output__"):
        raise ValueError(f"workflow {workflow_id!r} has no output (not finished?)")
    return store.load_step("__output__")


def get_events(workflow_id: str, storage: Optional[str] = None) -> list[dict]:
    """The workflow's durable event log: step_started / step_completed /
    step_failed lines with timestamps (reference: the workflow event
    system's observable execution feed)."""
    return _Store(storage or _DEFAULT_STORAGE, workflow_id).read_events()


def list_all(storage: Optional[str] = None) -> list[tuple[str, Optional[str]]]:
    root = storage or _DEFAULT_STORAGE
    out = []
    if os.path.isdir(root):
        for wid in sorted(os.listdir(root)):
            if os.path.isdir(os.path.join(root, wid)):  # skip stray files
                out.append((wid, get_status(wid, root)))
    return out
