"""DAG IR (reference: python/ray/dag/dag_node.py, input_node.py,
class_node.py — InputNode/ClassMethodNode graph captured by .bind())."""

from __future__ import annotations

from typing import Any, List, Optional, Tuple


class DAGNode:
    def __init__(self):
        self._downstream: List["DAGNode"] = []

    def experimental_compile(self, max_buffer_size: int = 1 << 20):
        from ray_tpu_torch.dag.compiled import CompiledDAG
        return CompiledDAG(self, max_buffer_size=max_buffer_size)

    def _upstream(self) -> List["DAGNode"]:
        return []


class InputNode(DAGNode):
    """The driver-supplied input (context-manager idiom like the
    reference's `with InputNode() as inp:`)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return "InputNode()"


class ClassMethodNode(DAGNode):
    def __init__(self, actor_handle, method_name: str, args: Tuple,
                 kwargs: dict):
        super().__init__()
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs

    def _upstream(self) -> List[DAGNode]:
        ups = [a for a in self.args if isinstance(a, DAGNode)]
        ups += [v for v in self.kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def __repr__(self):
        return f"ClassMethodNode({self.method_name})"


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        super().__init__()
        self.outputs = list(outputs)

    def _upstream(self) -> List[DAGNode]:
        return list(self.outputs)
