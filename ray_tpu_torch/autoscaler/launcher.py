"""Cluster launcher: bring a cluster up/down from a YAML spec
(reference: `ray up` — python/ray/autoscaler/_private/commands.py with
schema ray-schema.json; the v2 instance-manager reconciler supplies the
runtime scaling here via autoscaler.Autoscaler).

Schema (YAML):

    cluster_name: my-cluster
    provider:
      type: fake              # gcp_tpu: not ported (ROADMAP A3c-2)
    head:
      num_cpus: 4
      resources: {}           # extra custom resources
    available_node_types:
      cpu_worker:
        resources: {CPU: 4}
        min_workers: 0
        max_workers: 10
      gpu_worker:
        resources: {CPU: 1, GPU: 1}
        min_workers: 0
        max_workers: 1
    idle_timeout_s: 60

`up()` starts the head in-process, pre-launches every type's min_workers
through the provider, and runs the demand-driven reconciler on a
background thread. `down()` terminates provider nodes and the head.

Counterpart of ``ray_tpu/autoscaler/launcher.py``. The provider's nodes
join the head's session, so the whole cluster is one session of the
runtime; the state file lives under the runtime's directory
(``proc_util.runtime_dir``) and names the session and the process that
runs the reconciler, which ``down_from_state`` stops first. The
``gcp_tpu`` provider waits for the port's slice gangs (ROADMAP.md, Queue
A item A3c-2).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.autoscaler.autoscaler import (Autoscaler, AutoscalerConfig,
                                           NodeTypeConfig)
from ray_tpu_torch.autoscaler.node_provider import FakeMultiNodeProvider

logger = logging.getLogger(__name__)


def state_file() -> str:
    from ray_tpu_torch._private.proc_util import runtime_dir
    return runtime_dir("cluster_launcher.json")


def load_config(path: str) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"{path}: expected a mapping at top level")
    cfg.setdefault("cluster_name", "ray-tpu")
    cfg.setdefault("head", {})
    cfg.setdefault("available_node_types", {})
    prov = cfg.get("provider") or {}
    if prov.get("type") == "gcp_tpu":
        raise NotImplementedError(
            "provider type gcp_tpu provisions TPU slices; a GPU slice "
            "provider is not ported yet (ROADMAP.md, Queue A item A3c-2)")
    if prov.get("type") != "fake":
        raise ValueError("provider.type must be 'fake'")
    for name, nt in cfg["available_node_types"].items():
        if "resources" not in nt:
            raise ValueError(f"node type {name!r} needs `resources`")
        nt.setdefault("min_workers", 0)
        nt.setdefault("max_workers", 10)
        nt.setdefault("labels", {})
    return cfg


def _make_provider(cfg: Dict, gcs_address: str, session_name: str,
                   detached: bool = False):
    return FakeMultiNodeProvider(gcs_address, session_name=session_name,
                                 detached=detached)


class ClusterHandle:
    """A launched cluster: head node + provider + reconciler thread."""

    def __init__(self, config: Dict, head, provider,
                 autoscaler: Optional[Autoscaler], stop: threading.Event,
                 thread: Optional[threading.Thread]):
        self.config = config
        self.head = head
        self.provider = provider
        self.autoscaler = autoscaler
        self._stop = stop
        self._thread = thread

    @property
    def gcs_address(self) -> str:
        return self.head.gcs_address

    def down(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for pid in list(self.provider.non_terminated_nodes()):
            try:
                self.provider.terminate_node(pid)
            except Exception:
                logger.exception("terminate %s failed", pid)
        self.head.kill()
        try:
            os.unlink(state_file())
        except OSError:
            pass


def up(config_path: str, start_autoscaler: bool = True,
       detached: bool = False) -> ClusterHandle:
    """Bring the cluster up: head + min_workers + reconciler.

    detached=True (the `ray_tpu_torch up` CLI) lets the cluster outlive this
    process; the default ties daemon lifetimes to the caller via
    PDEATHSIG, which is what tests want."""
    from ray_tpu_torch._private import node as node_mod

    cfg = load_config(config_path)
    head_cfg = cfg["head"]
    head = node_mod.start_head(
        num_cpus=head_cfg.get("num_cpus", 1),
        resources=dict(head_cfg.get("resources") or {}),
        detached=detached)
    provider = _make_provider(cfg, head.gcs_address, head.session_name,
                              detached=detached)
    for name, nt in cfg["available_node_types"].items():
        for _ in range(int(nt["min_workers"])):
            provider.create_node(name, dict(nt["resources"]),
                                 dict(nt["labels"]))

    stop = threading.Event()
    thread = None
    asc = None
    if start_autoscaler:
        def nodes_fn(addr=head.gcs_address):
            # standalone GCS query: the launcher process need not be a
            # ray_tpu_torch driver
            import asyncio

            from ray_tpu_torch._private import rpc

            async def go():
                conn = await rpc.connect(addr, name="launcher", retries=3)
                try:
                    return await conn.call("get_all_nodes")
                finally:
                    await conn.close()
            return asyncio.run(go())

        asc = Autoscaler(
            AutoscalerConfig(
                node_types={
                    name: NodeTypeConfig(resources=dict(nt["resources"]),
                                         max_workers=int(nt["max_workers"]),
                                         labels=dict(nt["labels"]))
                    for name, nt in cfg["available_node_types"].items()},
                idle_timeout_s=float(cfg.get("idle_timeout_s", 60.0))),
            provider, protected_node_ids=[head.node_id],
            nodes_fn=nodes_fn)
        thread = threading.Thread(target=asc.run, args=(stop,),
                                  name="cluster-autoscaler", daemon=True)
        thread.start()

    path = state_file()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"cluster_name": cfg["cluster_name"],
                   "gcs_address": head.gcs_address,
                   "session": head.session_name,
                   # the reconciler dies with a detached `up`'s CLI
                   "pid": (os.getpid() if start_autoscaler and not detached
                           else None),
                   "provider": cfg["provider"],
                   "config_path": os.path.abspath(config_path),
                   "started_at": time.time()}, f)
    logger.info("cluster %s up: GCS %s, %d node type(s)",
                cfg["cluster_name"], head.gcs_address,
                len(cfg["available_node_types"]))
    return ClusterHandle(cfg, head, provider, asc, stop, thread)


def down_from_state() -> Optional[str]:
    """`ray_tpu_torch down` from another process than `up`: stop the
    process that runs the reconciler (its ``ClusterHandle.down()``
    terminates the provider's nodes and the head). Returns the session
    for the caller to sweep, or None when no cluster was launched."""
    import signal
    path = state_file()
    try:
        with open(path) as f:
            st = json.load(f)
    except OSError:
        return None
    pid = st.get("pid")
    if pid and pid != os.getpid() and _alive(pid):
        os.kill(pid, signal.SIGTERM)
        deadline = time.monotonic() + 30.0
        while _alive(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
    try:
        os.unlink(path)
    except OSError:
        pass
    return st.get("session")


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (an exited child its parent has not reaped
    yet is a zombie, not alive)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False
