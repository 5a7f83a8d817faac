"""Autoscaler v2 instance manager: a reconciling per-instance state
machine between desired counts, the cloud provider, and the Ray cluster
(reference: python/ray/autoscaler/v2/instance_manager/instance_manager.py:29
and instance_storage — instances move QUEUED -> REQUESTED -> ALLOCATED ->
RAY_RUNNING -> TERMINATING -> TERMINATED with an auditable status
history; the reconciler converges the fleet instead of firing one-shot
launch/terminate calls).

The Autoscaler (autoscaler.py) answers "how many of each type" from
resource demand; this layer answers "which concrete cloud instances, in
what state, and what API call moves each one forward"."""

from __future__ import annotations

import dataclasses
import logging
import time
import uuid
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class Status:
    QUEUED = "QUEUED"                       # wanted, no cloud call yet
    REQUESTED = "REQUESTED"                 # create_node issued
    ALLOCATED = "ALLOCATED"                 # cloud reports it exists
    RAY_RUNNING = "RAY_RUNNING"             # node registered with GCS
    TERMINATING = "TERMINATING"             # delete issued
    TERMINATED = "TERMINATED"               # gone (terminal)
    ALLOCATION_FAILED = "ALLOCATION_FAILED"  # cloud lost/denied (terminal)

    TERMINAL = (TERMINATED, ALLOCATION_FAILED)


@dataclasses.dataclass
class Instance:
    instance_id: str
    node_type: str
    status: str = Status.QUEUED
    provider_id: Optional[str] = None       # cloud resource name
    ray_node_id: Optional[str] = None       # GCS node id once registered
    created_at: float = dataclasses.field(default_factory=time.monotonic)
    updated_at: float = dataclasses.field(default_factory=time.monotonic)
    history: List = dataclasses.field(default_factory=list)

    def transition(self, status: str, reason: str = ""):
        self.history.append((self.status, status, reason, time.time()))
        self.status = status
        self.updated_at = time.monotonic()


class InstanceManager:
    """Reconciles {node_type: target_count} against a NodeProvider and
    the cluster's registered nodes."""

    def __init__(self, provider, node_types: Dict[str, Dict],
                 request_timeout_s: float = 900.0):
        """node_types: name -> {"resources": {...}, "labels": {...}};
        request_timeout_s: a REQUESTED instance the cloud never lists
        within this window fails (the async create was accepted but its
        operation died — e.g. zone exhaustion — and nothing else would
        ever retry the deficit)."""
        self.provider = provider
        self.node_types = node_types
        self.request_timeout_s = request_timeout_s
        self.targets: Dict[str, int] = {}
        self.instances: Dict[str, Instance] = {}

    def set_target(self, node_type: str, count: int):
        if node_type not in self.node_types:
            raise ValueError(f"unknown node type {node_type!r}")
        self.targets[node_type] = max(0, int(count))

    # ------------------------------------------------------------- helpers
    def _live(self, node_type: Optional[str] = None) -> List[Instance]:
        return [i for i in self.instances.values()
                if i.status not in Status.TERMINAL
                and (node_type is None or i.node_type == node_type)]

    def _match_ray_nodes(self, ray_nodes: List[Dict]):
        """provider_id -> registered cluster node. Three channels:
        direct node-id match (fake/local providers), the
        ray-tpu-provider-id node label (VM providers — stamped by the
        startup script's `cli start --labels`), or a
        tpu-slice:{provider_id} resource (slice hosts)."""
        by_pid: Dict[str, Dict] = {}
        for n in ray_nodes:
            if not n.get("alive"):
                continue
            by_pid[n["node_id"]] = n
            pid_label = (n.get("labels") or {}).get("ray-tpu-provider-id")
            if pid_label:
                by_pid[pid_label] = n
            for res in n.get("total", {}):
                if res.startswith("tpu-slice:"):
                    by_pid[res[len("tpu-slice:"):]] = n
        return by_pid

    # ----------------------------------------------------------- reconcile
    def reconcile(self, ray_nodes: Optional[List[Dict]] = None) -> Dict:
        """One convergence step. Returns {launched, terminated, failed}."""
        ray_nodes = ray_nodes or []
        actions = {"launched": [], "terminated": [], "failed": []}
        try:
            cloud = set(self.provider.non_terminated_nodes())
        except Exception:
            logger.exception("provider listing failed; skipping step")
            return actions
        ray_by_pid = self._match_ray_nodes(ray_nodes)

        # 1. observe: move instances forward/mark failures from the two
        # sources of truth (cloud listing, GCS node table)
        now = time.monotonic()
        for inst in list(self.instances.values()):
            if inst.status == Status.REQUESTED:
                if inst.provider_id in cloud:
                    inst.transition(Status.ALLOCATED, "cloud lists it")
                elif now - inst.updated_at > self.request_timeout_s:
                    inst.transition(Status.ALLOCATION_FAILED,
                                    "request never materialized")
                    actions["failed"].append(inst.instance_id)
                    continue
            if inst.status in (Status.REQUESTED, Status.ALLOCATED):
                node = ray_by_pid.get(inst.provider_id)
                if node is not None:
                    inst.ray_node_id = node["node_id"]
                    inst.transition(Status.RAY_RUNNING, "node registered")
                elif inst.status == Status.ALLOCATED \
                        and inst.provider_id not in cloud:
                    inst.transition(Status.ALLOCATION_FAILED,
                                    "vanished from cloud")
                    actions["failed"].append(inst.instance_id)
            elif inst.status == Status.RAY_RUNNING \
                    and inst.provider_id not in cloud:
                inst.transition(Status.TERMINATED, "cloud terminated")
            elif inst.status == Status.TERMINATING \
                    and inst.provider_id not in cloud:
                inst.transition(Status.TERMINATED, "delete confirmed")

        # 2. converge counts per type
        for ntype, want in self.targets.items():
            live = self._live(ntype)
            # deficit: queue + request new instances
            for _ in range(want - len(live)):
                inst = Instance(instance_id=uuid.uuid4().hex[:12],
                                node_type=ntype)
                self.instances[inst.instance_id] = inst
            for inst in self._live(ntype):
                if inst.status == Status.QUEUED:
                    cfg = self.node_types[ntype]
                    try:
                        inst.provider_id = self.provider.create_node(
                            ntype, dict(cfg.get("resources") or {}),
                            dict(cfg.get("labels") or {}))
                    except Exception as e:
                        inst.transition(Status.ALLOCATION_FAILED,
                                        f"create failed: {e}")
                        actions["failed"].append(inst.instance_id)
                        continue
                    inst.transition(Status.REQUESTED, "create_node sent")
                    actions["launched"].append(inst.instance_id)
            # surplus: terminate — prefer instances that never joined the
            # cluster (cheapest to lose), then newest RAY_RUNNING
            live = self._live(ntype)
            surplus = len(live) - want
            if surplus > 0:
                def _rank(i: Instance):
                    order = {Status.QUEUED: 0, Status.REQUESTED: 1,
                             Status.ALLOCATED: 2, Status.RAY_RUNNING: 3,
                             Status.TERMINATING: 4}
                    return (order.get(i.status, 5), -i.created_at)
                for inst in sorted(live, key=_rank)[:surplus]:
                    if inst.status == Status.QUEUED:
                        inst.transition(Status.TERMINATED, "never requested")
                        continue
                    if inst.status == Status.TERMINATING:
                        continue
                    try:
                        self.provider.terminate_node(inst.provider_id)
                    except Exception:
                        logger.exception("terminate %s failed; retrying "
                                         "next step", inst.provider_id)
                        continue
                    inst.transition(Status.TERMINATING, "scale down")
                    actions["terminated"].append(inst.instance_id)
        return actions

    def summary(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for inst in self.instances.values():
            out.setdefault(inst.node_type, {})
            out[inst.node_type][inst.status] = \
                out[inst.node_type].get(inst.status, 0) + 1
        return out
