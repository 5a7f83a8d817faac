"""Job submission: run driver scripts on the cluster (reference:
python/ray/dashboard/modules/job/ — JobManager :59, JobSupervisor actor
:53 runs the entrypoint as a subprocess and streams logs; SDK sdk.py).
The manager is a detached named actor; the REST surface lives in
ray_tpu_torch.dashboard.

Counterpart of ``ray_tpu/job_submission.py``. An entrypoint runs with
``RAY_TPU_TORCH_ADDRESS`` set, so its ``ray_tpu_torch.init()`` joins the
cluster that runs it."""

from __future__ import annotations

import os
import subprocess
import threading
import time
import uuid
from typing import Dict, List, Optional

JOB_MANAGER_NAME = "_JOB_MANAGER"

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


class JobSupervisor:
    """One actor per submitted job: runs the entrypoint subprocess."""

    def __init__(self, job_id: str, entrypoint: str,
                 runtime_env: Optional[Dict], gcs_address: str):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.status = PENDING
        self.logs: List[str] = []
        self.returncode: Optional[int] = None
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = gcs_address
        env.update((runtime_env or {}).get("env_vars", {}))
        cwd = (runtime_env or {}).get("working_dir")
        self._proc = subprocess.Popen(
            entrypoint, shell=True, env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.status = RUNNING
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self):
        for line in self._proc.stdout:
            self.logs.append(line.rstrip("\n"))
        self.returncode = self._proc.wait()
        if self.status != STOPPED:
            self.status = SUCCEEDED if self.returncode == 0 else FAILED

    def get_status(self) -> Dict:
        return {"job_id": self.job_id, "status": self.status,
                "returncode": self.returncode,
                "entrypoint": self.entrypoint}

    def get_logs(self, offset: int = 0) -> List[str]:
        return self.logs[offset:]

    def stop(self):
        self.status = STOPPED
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        return True


class JobManager:
    """Named detached actor tracking all submitted jobs."""

    def __init__(self):
        self.jobs: Dict[str, Dict] = {}   # job_id -> {supervisor, meta}

    def submit(self, entrypoint: str, runtime_env: Optional[Dict] = None,
               submission_id: Optional[str] = None,
               metadata: Optional[Dict] = None) -> str:
        import ray_tpu_torch
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        sup_cls = ray_tpu_torch.remote(JobSupervisor)
        sup = sup_cls.options(max_concurrency=4, num_cpus=0.1).remote(
            job_id, entrypoint, runtime_env, ray_tpu_torch.get_gcs_address())
        self.jobs[job_id] = {"supervisor": sup,
                             "metadata": metadata or {},
                             "submitted_at": time.time()}
        return job_id

    def status(self, job_id: str) -> Optional[Dict]:
        import ray_tpu_torch
        info = self.jobs.get(job_id)
        if info is None:
            return None
        try:
            st = ray_tpu_torch.get(info["supervisor"].get_status.remote(),
                             timeout=30)
        except Exception as e:
            st = {"job_id": job_id, "status": FAILED,
                  "error": f"supervisor lost: {e}"}
        return {**st, **info["metadata"],
                "submitted_at": info["submitted_at"]}

    def logs(self, job_id: str, offset: int = 0) -> List[str]:
        import ray_tpu_torch
        info = self.jobs.get(job_id)
        if info is None:
            return []
        try:
            return ray_tpu_torch.get(info["supervisor"].get_logs.remote(offset),
                               timeout=30)
        except Exception:
            return []

    def stop(self, job_id: str) -> bool:
        import ray_tpu_torch
        info = self.jobs.get(job_id)
        if info is None:
            return False
        return ray_tpu_torch.get(info["supervisor"].stop.remote(), timeout=30)

    def list(self) -> List[Dict]:
        return [self.status(j) for j in list(self.jobs)]


def _get_manager():
    import ray_tpu_torch
    try:
        return ray_tpu_torch.get_actor(JOB_MANAGER_NAME, namespace="_internal")
    except ValueError:
        cls = ray_tpu_torch.remote(JobManager)
        return cls.options(name=JOB_MANAGER_NAME, namespace="_internal",
                           lifetime="detached", max_concurrency=4,
                           num_cpus=0.1).remote()


class JobSubmissionClient:
    """Reference: python/ray/dashboard/modules/job/sdk.py — here speaking
    actor RPC instead of REST (the dashboard exposes the same over HTTP)."""

    def __init__(self, address: Optional[str] = None):
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address)
        self._mgr = _get_manager()

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict] = None) -> str:
        import ray_tpu_torch
        return ray_tpu_torch.get(self._mgr.submit.remote(
            entrypoint, runtime_env, submission_id, metadata), timeout=60)

    def get_job_status(self, job_id: str) -> str:
        import ray_tpu_torch
        st = ray_tpu_torch.get(self._mgr.status.remote(job_id), timeout=30)
        return st["status"] if st else "NOT_FOUND"

    def get_job_info(self, job_id: str) -> Optional[Dict]:
        import ray_tpu_torch
        return ray_tpu_torch.get(self._mgr.status.remote(job_id), timeout=30)

    def get_job_logs(self, job_id: str) -> str:
        import ray_tpu_torch
        return "\n".join(ray_tpu_torch.get(self._mgr.logs.remote(job_id),
                                     timeout=30))

    def stop_job(self, job_id: str) -> bool:
        import ray_tpu_torch
        return ray_tpu_torch.get(self._mgr.stop.remote(job_id), timeout=30)

    def list_jobs(self) -> List[Dict]:
        import ray_tpu_torch
        return ray_tpu_torch.get(self._mgr.list.remote(), timeout=60)

    def wait_until_finished(self, job_id: str, timeout: float = 300) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.get_job_status(job_id)
            if st in (SUCCEEDED, FAILED, STOPPED):
                return st
            time.sleep(0.5)
        raise TimeoutError(f"job {job_id} still {st} after {timeout}s")
