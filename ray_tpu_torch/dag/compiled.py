"""Compiled (accelerated) DAG execution over reusable shm channels.

Reference: ``python/ray/dag/compiled_dag_node.py:141`` — compiling a DAG of
actor-method calls replaces per-call task submission with persistent
executors connected by mutable plasma channels. Same shape here, TPU-host
style: each participating actor runs one long-lived "exec loop" task that
blocks on its input :class:`~ray_tpu_torch.experimental.channel.Channel`\\ s,
invokes the bound method, and pushes the result into its output channels.
After compile, ``execute(x)`` is: write x into the input-edge channels, read
the output-edge channel — no scheduler, no control-plane round-trips.

Restrictions (matching the reference's early accelerated-DAG rules):
every non-input node is an actor-method call, each actor appears in at most
one node, and values must fit the channel capacity.
"""

from __future__ import annotations

from typing import Any, Optional

from ray_tpu_torch.dag import DAGNode, InputNode, MultiOutputNode
from ray_tpu_torch.experimental.channel import Channel, ChannelClosed


class ClassMethodNode(DAGNode):
    """``actor.method.bind(...)`` — an actor-method call site in a DAG."""

    def __init__(self, handle, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._handle = handle
        self._method_name = method_name

    def _execute_impl(self, memo: dict):
        args, kwargs = self._resolved_args(memo)
        return getattr(self._handle, self._method_name).remote(*args, **kwargs)

    def experimental_compile(self, buffer_size_bytes: int = 1 << 20) -> "CompiledDAG":
        return CompiledDAG(self, buffer_size_bytes)


class CompiledDAGRef:
    """Result handle for one compiled execution (reference:
    CompiledDAGRef) — ``get()`` reads the output channel."""

    def __init__(self, channels: list[Channel], single: bool):
        self._channels = channels
        self._single = single
        self._consumed = False

    def get(self, timeout: Optional[float] = 30.0):
        if self._consumed:
            raise ValueError("CompiledDAGRef already consumed")
        self._consumed = True
        vals = [c.read(timeout=timeout) for c in self._channels]
        for v in vals:
            if isinstance(v, _WrappedError):
                raise v.error
        return vals[0] if self._single else vals


class _WrappedError:
    """Marks an executor-side exception traveling through a channel."""

    def __init__(self, error: BaseException):
        self.error = error


class CompiledDAG:
    def __init__(self, root: DAGNode, buffer_size_bytes: int = 1 << 20):
        self._buffer = buffer_size_bytes
        self._torn_down = False
        outputs = (
            list(root._bound_args) if isinstance(root, MultiOutputNode) else [root]
        )
        self._single_output = not isinstance(root, MultiOutputNode)

        # topo-walk: collect nodes, validate shape
        order: list[DAGNode] = []
        seen: set[int] = set()

        def walk(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for dep in list(node._bound_args) + list(node._bound_kwargs.values()):
                if isinstance(dep, DAGNode):
                    walk(dep)
            order.append(node)

        for out in outputs:
            if not isinstance(out, DAGNode):
                raise ValueError("compiled DAG outputs must be DAG nodes")
            walk(out)

        self._inputs = [n for n in order if isinstance(n, InputNode)]
        self._nodes = [n for n in order if isinstance(n, ClassMethodNode)]
        if len(self._nodes) != len([n for n in order if not isinstance(n, InputNode)]):
            raise ValueError(
                "compiled DAGs support actor-method nodes only "
                "(bind methods on actor handles; plain task nodes cannot hold "
                "a persistent executor)"
            )
        actors = [n._handle._actor_id for n in self._nodes]
        if len(set(actors)) != len(actors):
            raise ValueError("each actor may appear at most once in a compiled DAG")

        # one channel per EDGE OCCURRENCE (the same producer appearing twice
        # in one arg list gets two channels, one per position)
        self._input_edges: dict[int, list[Channel]] = {id(n): [] for n in self._inputs}
        self._output_channels: list[Channel] = []
        out_edges: dict[int, list[Channel]] = {}  # id(producer) -> channels
        all_edges: list[Channel] = []

        def make_edge(src: DAGNode) -> Channel:
            ch = Channel(self._buffer)
            out_edges.setdefault(id(src), []).append(ch)
            all_edges.append(ch)
            return ch

        plans = []
        for node in self._nodes:
            in_specs = []
            for dep in list(node._bound_args):
                if isinstance(dep, InputNode):
                    ch = make_edge(dep)
                    self._input_edges[id(dep)].append(ch)
                    in_specs.append(("chan", ch))
                elif isinstance(dep, ClassMethodNode):
                    in_specs.append(("chan", make_edge(dep)))
                elif isinstance(dep, DAGNode):
                    raise ValueError(f"unsupported node type in compiled DAG: {dep!r}")
                else:
                    in_specs.append(("const", dep))
            if node._bound_kwargs:
                raise ValueError("compiled DAGs support positional args only")
            plans.append({"node": node, "in": in_specs, "out": []})

        by_id = {id(p["node"]): p for p in plans}
        for src_id, chans in out_edges.items():
            p = by_id.get(src_id)
            if p is not None:
                p["out"].extend(chans)
        for out_node in outputs:
            ch = Channel(self._buffer)
            by_id[id(out_node)]["out"].append(ch)
            self._output_channels.append(ch)

        # launch one persistent exec-loop task per actor (the actor's
        # dispatch queue is owned by the loop until teardown, like the
        # reference's compiled-DAG executors)
        self._loop_refs = []
        for p in plans:
            node = p["node"]
            self._loop_refs.append(
                node._handle.__dag_exec__.remote(node._method_name, p["in"], p["out"])
            )
        self._all_channels = all_edges + self._output_channels

    def execute(self, *args) -> CompiledDAGRef:
        if self._torn_down:
            raise ValueError("compiled DAG was torn down")
        if len(args) != len(self._inputs):
            raise ValueError(
                f"dag has {len(self._inputs)} InputNode(s), got {len(args)} args"
            )
        for node, value in zip(self._inputs, args):
            for ch in self._input_edges[id(node)]:
                ch.write(value, timeout=30.0)
        return CompiledDAGRef(self._output_channels, self._single_output)

    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        for ch in self._all_channels:
            ch.close()
        import ray_tpu_torch

        for ref in self._loop_refs:
            try:
                ray_tpu_torch.get(ref, timeout=10)
            except Exception as e:
                from ray_tpu_torch._private.log_util import warn_throttled

                # expected when an exec-loop actor died mid-DAG, but a
                # teardown that ALWAYS fails here means loops leaking
                warn_throttled("compiled dag: exec-loop join", e)
        for ch in self._all_channels:
            ch.destroy()

    def __del__(self):
        # GC-safe: teardown blocks in ray_tpu_torch.get — never allowed from a GC
        # tick (could fire in a thread holding the head lock). Hand the whole
        # teardown to the context's gc-drain thread; resurrecting self via
        # the bound method is fine (PEP 442: __del__ runs at most once).
        if self._torn_down:
            return
        try:
            from ray_tpu_torch._private.runtime import _ctx

            if _ctx is not None and not _ctx.closed:
                _ctx.enqueue_gc("thunk", self.teardown)
                return
        except Exception:
            pass
        # no live context: skip the blocking exec-loop join but still unlink
        # the channels' shm segments (destroy needs no runtime) — GC-safe
        # because channel close/destroy touch no head or connection locks
        self._torn_down = True
        for ch in self._all_channels:
            try:
                ch.close()
                ch.destroy()
            except Exception as e:
                try:
                    from ray_tpu_torch._private.log_util import warn_throttled

                    warn_throttled("compiled dag: channel teardown", e)
                except Exception:  # raylint: disable=RL007
                    pass  # interpreter teardown: even logging can fail
