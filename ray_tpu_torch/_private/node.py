"""Node bootstrap: starts the GCS and node-manager daemons for a local
cluster and connects the driver (reference: python/ray/_private/node.py:37 and
services.py process launchers)."""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import time
import uuid
from typing import Dict, Optional

from ray_tpu_torch._private.proc_util import runtime_dir


class ProcessHandle:
    def __init__(self, proc: subprocess.Popen, announced: Dict[str, str]):
        self.proc = proc
        self.announced = announced

    def kill(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                self.proc.kill()


def _launch(cmd, keys, timeout=30.0, env=None,
            log_path: Optional[str] = None,
            detached: bool = False) -> ProcessHandle:
    """Start a daemon and read `KEY=value` announce lines from stdout.
    stderr goes to a session log file so daemons never hold the driver's
    (or pytest's) pipes open. Unless detached, the child arms
    PR_SET_PDEATHSIG so it dies with this process even on SIGKILL
    (otherwise daemons outlive a crashed driver forever)."""
    if log_path:
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        errf = open(log_path, "ab")
    else:
        errf = subprocess.DEVNULL
    if not detached:
        from ray_tpu_torch._private.proc_util import child_env
        env = child_env(env)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stdin=subprocess.DEVNULL, text=True, env=env,
                            stderr=errf, start_new_session=True)
    if log_path:
        errf.close()
    announced: Dict[str, str] = {}
    deadline = time.monotonic() + timeout
    remaining = set(keys)
    while remaining:
        if time.monotonic() > deadline:
            proc.kill()
            raise TimeoutError(f"{cmd[2]} did not announce {remaining}")
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"{' '.join(cmd[:4])} exited with {proc.returncode}")
            time.sleep(0.01)
            continue
        line = line.strip()
        if "=" in line:
            k, v = line.split("=", 1)
            if k in remaining:
                announced[k] = v
                remaining.discard(k)
    # stop consuming stdout; let the daemon write freely (pipe may fill
    # otherwise — redirect the rest to devnull via a drain thread)
    import threading

    def drain():
        try:
            for _ in proc.stdout:
                pass
        except Exception:
            pass

    threading.Thread(target=drain, daemon=True).start()
    return ProcessHandle(proc, announced)


class LocalNode:
    """A head node: GCS + node manager as subprocesses."""

    def __init__(self, gcs_handle: Optional[ProcessHandle],
                 nm_handle: ProcessHandle, gcs_address: str,
                 session_name: str):
        self.gcs_handle = gcs_handle
        self.nm_handle = nm_handle
        self.gcs_address = gcs_address
        self.session_name = session_name
        self.node_address = nm_handle.announced["NODE_ADDRESS"]
        self.node_id = nm_handle.announced["NODE_ID"]
        self.store_path = nm_handle.announced["STORE_PATH"]

    def kill(self):
        self.nm_handle.kill()
        if self.gcs_handle is not None:
            self.gcs_handle.kill()
        try:
            os.unlink(self.store_path)
        except OSError:
            pass


def start_head(num_cpus: Optional[float] = None,
               resources: Optional[Dict[str, float]] = None,
               object_store_memory: Optional[int] = None,
               labels: Optional[Dict[str, str]] = None,
               session_name: Optional[str] = None,
               gcs_port: int = 0, detached: bool = False) -> LocalNode:
    session_name = session_name or f"s{uuid.uuid4().hex[:8]}"
    gcs = _launch([sys.executable, "-m", "ray_tpu_torch._private.gcs",
                   "--port", str(gcs_port), "--session-name", session_name],
                  ["GCS_ADDRESS"],
                  log_path=runtime_dir(session_name, "logs", "gcs.err"),
                  detached=detached)
    gcs_address = gcs.announced["GCS_ADDRESS"]
    node = start_node(gcs_address, num_cpus=num_cpus, resources=resources,
                      object_store_memory=object_store_memory, labels=labels,
                      session_name=session_name, detached=detached)
    return LocalNode(gcs, node.nm_handle, gcs_address, session_name)


def start_node(gcs_address: str, num_cpus: Optional[float] = None,
               resources: Optional[Dict[str, float]] = None,
               object_store_memory: Optional[int] = None,
               labels: Optional[Dict[str, str]] = None,
               session_name: str = "session",
               gcs_address_source: Optional[str] = None,
               detached: bool = False) -> LocalNode:
    res = dict(resources or {})
    if num_cpus is not None:
        res["CPU"] = float(num_cpus)
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.node_manager",
           "--gcs-address", gcs_address,
           "--resources", json.dumps(res),
           "--labels", json.dumps(labels or {}),
           "--session-name", session_name]
    if gcs_address_source:
        cmd += ["--gcs-address-source", gcs_address_source]
    if not object_store_memory:
        from ray_tpu_torch._private.config import cfg
        object_store_memory = cfg.object_store_memory or None
    if object_store_memory:
        cmd += ["--store-bytes", str(int(object_store_memory))]
    nm = _launch(cmd, ["NODE_ADDRESS", "NODE_ID", "STORE_PATH"],
                 log_path=runtime_dir(session_name, "logs",
                                          "node_manager.err"),
                 detached=detached)
    return LocalNode(None, nm, gcs_address, session_name)
