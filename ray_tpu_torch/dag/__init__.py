"""Lazy task DAGs (reference: ``python/ray/dag/dag_node.py``,
``input_node.py``, ``output_node.py``).

``f.bind(x)`` builds a DAG node; ``node.execute(input)`` walks the graph
submitting tasks with upstream ObjectRefs as args. Each ``execute`` call
evaluates every node exactly ONCE (diamond-shaped graphs don't double-submit)
and threads the runtime input through ``InputNode`` placeholders::

    with InputNode() as inp:
        a = preprocess.bind(inp)
        dag = combine.bind(a, postprocess.bind(a))
    ray_tpu_torch.get(dag.execute(x))

Compiled (accelerated) DAG execution over reusable channels is a later-round
feature; this module provides the lazy-graph surface.
"""

from __future__ import annotations

from typing import Any


class DAGNode:
    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- per-execution walk (memo: id(node) -> result) ---------------------

    def _resolve(self, v: Any, memo: dict):
        if isinstance(v, DAGNode):
            return v._execute_memo(memo)
        return v

    def _resolved_args(self, memo: dict):
        args = [self._resolve(a, memo) for a in self._bound_args]
        kwargs = {k: self._resolve(v, memo) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_memo(self, memo: dict):
        key = id(self)
        if key not in memo:
            memo[key] = self._execute_impl(memo)
        return memo[key]

    def _execute_impl(self, memo: dict):
        raise NotImplementedError

    def execute(self, *input_args):
        """Evaluate the graph. ``input_args`` feed the graph's InputNode(s):
        one positional value per distinct InputNode, in first-use order (the
        common case is a single InputNode)."""
        if isinstance(self, InputNode):
            raise RuntimeError(
                "InputNode has no value — call dag.execute(input_value) on a "
                "downstream node instead of executing the InputNode itself"
            )
        collected = self._collect_inputs()
        if len(input_args) != len(collected):
            raise ValueError(
                f"dag has {len(collected)} InputNode(s) but execute() got "
                f"{len(input_args)} argument(s)"
            )
        memo: dict = {
            id(node): value for node, value in zip(collected, input_args)
        }
        return self._execute_memo(memo)

    def experimental_compile(self, buffer_size_bytes: int = 1 << 20):
        """Compile this DAG for channel-based repeated execution
        (reference: ``dag_node.py:108`` experimental_compile)."""
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, buffer_size_bytes)

    def _collect_inputs(self) -> list["InputNode"]:
        inputs: list = []
        visited: set[int] = set()  # diamonds: walk each node once

        def walk(node):
            if not isinstance(node, DAGNode) or id(node) in visited:
                return
            visited.add(id(node))
            if isinstance(node, InputNode):
                inputs.append(node)
            for v in list(node._bound_args) + list(node._bound_kwargs.values()):
                walk(v)

        walk(self)
        return inputs


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._fn = remote_fn

    def _execute_impl(self, memo: dict):
        args, kwargs = self._resolved_args(memo)
        return self._fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._cls = actor_cls

    def _execute_impl(self, memo: dict):
        args, kwargs = self._resolved_args(memo)
        return self._cls.remote(*args, **kwargs)


class InputNode(DAGNode):
    """Placeholder for runtime input (reference: ``dag/input_node.py``);
    ``execute(x)`` on any downstream node substitutes ``x`` here."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_impl(self, memo: dict):
        raise RuntimeError(
            "InputNode has no value — call dag.execute(input_value) on a "
            "downstream node instead of executing the InputNode itself"
        )


class MultiOutputNode(DAGNode):
    """Bundle several leaves into one execute() (reference:
    ``dag/output_node.py``). ``execute`` returns a list of refs."""

    def __init__(self, outputs: list):
        super().__init__(tuple(outputs), {})

    def _execute_impl(self, memo: dict):
        args, _ = self._resolved_args(memo)
        return list(args)
