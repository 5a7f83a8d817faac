"""Multi-node-on-one-machine test cluster (reference:
python/ray/cluster_utils.py:135 `Cluster`).

Starts one GCS plus N node managers as separate local processes, each with
its own shm store and arbitrary fake resources (e.g. {"TPU": 4} on a CPU
box) — the fixture that lets all distributed scheduling, placement-group,
and failover logic be exercised hermetically (reference conftest pattern:
python/ray/tests/conftest.py:500 ray_start_cluster)."""

from __future__ import annotations

import time
import uuid
from typing import Dict, List, Optional

from ray_tpu_torch._private import node as node_mod


class ClusterNode:
    def __init__(self, local: node_mod.LocalNode):
        self._local = local
        self.node_id = local.node_id
        self.address = local.node_address
        self.store_path = local.store_path

    def kill(self):
        self._local.kill()


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict] = None):
        self.session_name = f"c{uuid.uuid4().hex[:8]}"
        self.gcs_address: Optional[str] = None
        self.nodes: List[ClusterNode] = []
        self._gcs_handle = None
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def address(self) -> str:
        return self.gcs_address

    def add_node(self, num_cpus: float = 1,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: int = 128 * 1024 * 1024,
                 labels: Optional[Dict[str, str]] = None) -> ClusterNode:
        if self.gcs_address is None:
            head = node_mod.start_head(
                num_cpus=num_cpus, resources=resources,
                object_store_memory=object_store_memory, labels=labels,
                session_name=self.session_name)
            self.gcs_address = head.gcs_address
            self._gcs_handle = head.gcs_handle
            head.gcs_handle = None   # node.kill() must not take GCS down
            node = ClusterNode(head)
        else:
            ln = node_mod.start_node(
                self.gcs_address, num_cpus=num_cpus, resources=resources,
                object_store_memory=object_store_memory, labels=labels,
                session_name=self.session_name)
            node = ClusterNode(ln)
        self.nodes.append(node)
        return node

    def remove_node(self, node: ClusterNode):
        node.kill()
        self.nodes = [n for n in self.nodes if n is not node]

    def wait_for_nodes(self, timeout: float = 15.0):
        """Block until every added node is alive in the GCS view."""
        import ray_tpu_torch
        deadline = time.monotonic() + timeout
        want = {n.node_id for n in self.nodes}
        while time.monotonic() < deadline:
            alive = {n["node_id"] for n in ray_tpu_torch.nodes() if n["alive"]}
            if want <= alive:
                return
            time.sleep(0.1)
        raise TimeoutError(f"nodes never came up: {want - alive}")

    def shutdown(self):
        for node in self.nodes:
            node.kill()
        self.nodes = []
        if self._gcs_handle is not None:
            self._gcs_handle.kill()
            self._gcs_handle = None
