"""Cloud node providers (reference: python/ray/autoscaler/node_provider.py
ABC + _private/fake_multi_node/node_provider.py:236 FakeMultiNodeProvider).
The fake provider launches REAL node-manager processes locally so the whole
autoscaler loop is testable hermetically — same trick as the reference.

Counterpart of ``ray_tpu/autoscaler/node_provider.py``: the fake provider
and the GCE VM provider. A fake node declaring ``{"GPU": n}`` takes the
host's real GPU ids when it has that many (the node manager's
``detect_gpu_ids``), so a task it runs sees the card."""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional


class NodeProvider:
    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


def _sanitize(name: str) -> str:
    """GCE resource names: lowercase letters, digits, hyphens."""
    import re
    out = re.sub(r"[^a-z0-9-]", "-", name.lower())
    return out.strip("-") or "node"


def _metadata_token() -> str:
    import json
    import urllib.request
    req = urllib.request.Request(
        "http://metadata.google.internal/computeMetadata/v1/instance/"
        "service-accounts/default/token",
        headers={"Metadata-Flavor": "Google"})
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.loads(resp.read())["access_token"]


class FakeMultiNodeProvider(NodeProvider):
    """Launches local node managers against the current GCS."""

    def __init__(self, gcs_address: str, session_name: str = "fake",
                 detached: bool = False):
        self.gcs_address = gcs_address
        self.session_name = session_name
        self.detached = detached
        self.nodes: Dict[str, object] = {}

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        from ray_tpu_torch._private import node as node_mod
        res = dict(resources)
        num_cpus = res.pop("CPU", 1)
        ln = node_mod.start_node(
            self.gcs_address, num_cpus=num_cpus, resources=res,
            labels={**labels, "node_type": node_type},
            session_name=self.session_name,
            object_store_memory=64 * 1024 * 1024,
            detached=self.detached)
        self.nodes[ln.node_id] = ln
        return ln.node_id

    def terminate_node(self, provider_node_id: str) -> None:
        ln = self.nodes.pop(provider_node_id, None)
        if ln is not None:
            ln.kill()

    def non_terminated_nodes(self) -> List[str]:
        return list(self.nodes)


class GceVmNodeProvider(NodeProvider):
    """Plain GCE CPU VM provider (head / non-accelerator workers) over
    the Compute Engine instances API (reference:
    python/ray/autoscaler/_private/gcp/node_provider.py — the non-TPU
    half of the GCP integration). Same injectable-transport pattern as
    GcpTpuNodeProvider: ``api(method, path, body) -> dict`` so the state
    machine tests hermetically; the default transport talks to
    compute.googleapis.com with a metadata-server token."""

    _LIVE_STATES = ("PROVISIONING", "STAGING", "RUNNING", "REPAIRING")

    def __init__(self, project: str, zone: str, cluster_address: str,
                 machine_type: str = "n2-standard-8",
                 image: str = ("projects/debian-cloud/global/images/"
                               "family/debian-12"),
                 disk_gb: int = 100, api=None):
        self.project = project
        self.zone = zone
        self.cluster_address = cluster_address
        self.machine_type = machine_type
        self.image = image
        self.disk_gb = disk_gb
        self.api = api or self._default_api
        self.created: Dict[str, str] = {}    # name -> node_type
        self._token = None
        self._token_expiry = 0.0

    def _default_api(self, method: str, path: str, body=None):
        import json
        import time
        import urllib.request
        if self._token is None or time.monotonic() > self._token_expiry:
            self._token = _metadata_token()
            self._token_expiry = time.monotonic() + 45 * 60
        url = f"https://compute.googleapis.com/compute/v1/{path}"
        req = urllib.request.Request(
            url, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Authorization": f"Bearer {self._token}",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read() or b"{}")

    def _parent(self) -> str:
        return f"projects/{self.project}/zones/{self.zone}"

    def _startup_script(self, name: str) -> str:
        # the provider-id label is how the instance manager matches the
        # registered cluster node back to this VM (instance_manager
        # _match_ray_nodes reads node labels)
        return ("#!/bin/bash\n"
                "python -m ray_tpu_torch.scripts.cli start "
                f"--address {self.cluster_address} "
                f"--labels '{{\"ray-tpu-provider-id\": \"{name}\"}}'\n")

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        name = (f"rt-{_sanitize(node_type)}-"
                f"{uuid.uuid4().hex[:8]}")
        body = {
            "name": name,
            "machineType": (f"zones/{self.zone}/machineTypes/"
                            f"{self.machine_type}"),
            "disks": [{"boot": True, "autoDelete": True,
                       "initializeParams": {
                           "sourceImage": self.image,
                           "diskSizeGb": str(self.disk_gb)}}],
            "networkInterfaces": [{"network": "global/networks/default"}],
            "metadata": {"items": [
                {"key": "startup-script",
                 "value": self._startup_script(name)}]},
            "labels": {
                **{_sanitize(k):
                   _sanitize(str(v))
                   for k, v in labels.items()},
                "ray-tpu-node-type": _sanitize(
                    node_type)},
        }
        self.api("POST", f"{self._parent()}/instances", body)
        self.created[name] = node_type
        return name

    def terminate_node(self, provider_node_id: str) -> None:
        self.api("DELETE",
                 f"{self._parent()}/instances/{provider_node_id}")
        self.created.pop(provider_node_id, None)

    def non_terminated_nodes(self) -> List[str]:
        out = []
        token = None
        while True:
            path = (f"{self._parent()}/instances"
                    "?filter=labels.ray-tpu-node-type:*")
            if token:
                path += f"&pageToken={token}"
            try:
                info = self.api("GET", path)
            except Exception:
                return list(self.created)   # transient outage: last known
            for inst in info.get("items", []) or []:
                if inst.get("status") in self._LIVE_STATES:
                    out.append(inst["name"])
            # paginate: truncating at one page (500 VMs) would make the
            # instance manager mark live instances vanished and relaunch
            token = info.get("nextPageToken")
            if not token:
                return out


class GcpTpuNodeProvider(NodeProvider):
    """The JAX package's TPU-slice provider (Cloud TPU queued resources,
    one provider node per slice, hosts joined through ``tpu-slice:``
    resources) waits for the port's slice gangs: what a GPU slice is,
    and which resource the GPU accelerator manager injects for it, is
    ROADMAP.md Queue A item A3c-2's open question."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GcpTpuNodeProvider provisions TPU slices; a GPU slice provider "
            "is not ported yet (ROADMAP.md, Queue A item A3c-2)")
