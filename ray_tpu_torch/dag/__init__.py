from ray_tpu_torch.dag.nodes import (ClassMethodNode, DAGNode, InputNode,
                                     MultiOutputNode)
from ray_tpu_torch.dag.compiled import CompiledDAG

__all__ = ["InputNode", "DAGNode", "ClassMethodNode", "MultiOutputNode",
           "CompiledDAG"]
