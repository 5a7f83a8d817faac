"""NVIDIA GPU accelerator manager: detection, CUDA_VISIBLE_DEVICES
isolation and the node's GPU id pool.

Counterpart of ``ray_tpu/_private/accelerators/tpu.py`` for the port,
following the public Ray manager (python/ray/_private/accelerators/
nvidia_gpu.py): the resource is ``"GPU"``, visibility is
``CUDA_VISIBLE_DEVICES``, and the count comes from that variable, else
the entries under ``/proc/driver/nvidia/gpus/``, else ``nvidia-smi -L``.
Detection never imports torch: the GCS and the node manager must not
initialise CUDA. ``RAY_TPU_TORCH_FAKE_GPUS`` advertises fake GPUs on a
machine without any (CPU tests).

Unlike TPU chips, GPUs are fractionally shareable: a request below 1
(``num_gpus=0.5``) shares one id with other fractions until they add up
to 1; a request of 1 or more takes whole ids. The GCE preemption notice
does not depend on the accelerator and lives here unchanged.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
FAKE_GPUS_ENV = "RAY_TPU_TORCH_FAKE_GPUS"
_NVIDIA_PROC_DIR = "/proc/driver/nvidia/gpus"
_SMI_TIMEOUT_S = 10.0


def _nvidia_smi(*args: str) -> Optional[List[str]]:
    try:
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=_SMI_TIMEOUT_S)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


# ------------------------------------------------------ preemption notice
# Spot/preemptible VMs get ~30s of warning: GCE flips the
# instance/preempted metadata attribute before the hard kill. Chaos tests
# inject the notice without a cloud through the env/file hooks below.
_GCE_METADATA_URL = "http://metadata.google.internal/computeMetadata/v1/"
_GCE_TIMEOUT_S = 0.5
PREEMPT_TEST_ENV = "RAY_TPU_TORCH_TESTING_PREEMPTED"
PREEMPT_TEST_FILE_ENV = "RAY_TPU_TORCH_TESTING_PREEMPT_FILE"


def _on_gce() -> bool:
    if os.environ.get("RAY_TPU_TORCH_DISABLE_GCE_METADATA"):
        return False
    try:
        with open("/sys/class/dmi/id/product_name") as f:
            return "Google" in f.read()
    except OSError:
        return False


def preemption_watch_enabled() -> bool:
    """Whether polling for preemption notices can ever observe one:
    on GCE, or when a chaos injection hook is armed."""
    return bool(os.environ.get(PREEMPT_TEST_ENV)
                or os.environ.get(PREEMPT_TEST_FILE_ENV)
                or _on_gce())


def check_preemption_notice() -> bool:
    """True once the platform announced this VM is being preempted.
    Not cached: callers poll on a ~1s cadence to observe the flip. The
    env flag arms a whole process at spawn; the marker file lets a test
    flip a live process from outside."""
    if os.environ.get(PREEMPT_TEST_ENV):
        return True
    marker = os.environ.get(PREEMPT_TEST_FILE_ENV)
    if marker:
        return os.path.exists(marker)
    if not _on_gce():
        return False
    try:
        import urllib.request
        req = urllib.request.Request(
            _GCE_METADATA_URL + "instance/preempted",
            headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=_GCE_TIMEOUT_S) as r:
            return r.read().decode().strip().upper() == "TRUE"
    except Exception:
        return False


class GPUAcceleratorManager(AcceleratorManager):
    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return CUDA_VISIBLE_DEVICES_ENV

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        if visible is not None:
            return len(visible)
        try:
            n = len(os.listdir(_NVIDIA_PROC_DIR))
        except OSError:
            n = 0
        if n == 0:
            rows = _nvidia_smi("-L")
            n = sum(1 for r in rows or () if r.startswith("GPU "))
        if n == 0 and os.environ.get(FAKE_GPUS_ENV):
            n = int(os.environ[FAKE_GPUS_ENV])
        return n

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        rows = _nvidia_smi("--query-gpu=name", "--format=csv,noheader")
        return rows[0] if rows else None

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]:
        v = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if v is None:
            return None
        if v in ("", "NoDevFiles"):
            return []
        return [x for x in v.split(",") if x != ""]

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        os.environ[CUDA_VISIBLE_DEVICES_ENV] = ",".join(str(i) for i in ids)

    @staticmethod
    def validate_resource_request_quantity(quantity: float):
        if quantity > 1 and quantity != int(quantity):
            return (False, "a GPU request above 1 must be a whole number "
                           "(fractions share one GPU, so only a request "
                           "below 1 may be fractional)")
        return (True, None)


class GpuIdPool:
    """The node's GPU ids and what is left of each, in fixed-point units
    (``UNITS`` per GPU, so fractions add up exactly). ``allocate`` claims
    ids for one request and returns the claim; ``release`` gives it back.
    Whole requests take ids that are wholly free; a fraction takes the
    first id with room for it (packing fractions onto one GPU, as Ray's
    per-instance GPU accounting does)."""

    UNITS = 10000

    def __init__(self, ids: List[str]):
        self.ids = list(ids)
        self.free: Dict[str, int] = {i: self.UNITS for i in self.ids}

    @classmethod
    def _units(cls, quantity: float) -> int:
        return int(round(quantity * cls.UNITS))

    def fits(self, quantity: float) -> bool:
        return self._pick(quantity) is not None

    def _pick(self, quantity: float) -> Optional[List[Tuple[str, int]]]:
        if quantity <= 0:
            return []
        if quantity >= 1:
            n = int(quantity)
            whole = [i for i in self.ids if self.free[i] == self.UNITS]
            if len(whole) < n:
                return None
            return [(i, self.UNITS) for i in whole[:n]]
        u = self._units(quantity)
        for i in self.ids:
            if self.free[i] >= u:
                return [(i, u)]
        return None

    def allocate(self, quantity: float) -> List[Tuple[str, int]]:
        claim = self._pick(quantity)
        if claim is None:
            # float accounting and the physical id pool diverged: never
            # grant a GPU lease without isolation
            raise RuntimeError(
                f"GPU pool exhausted: need {quantity}, free {self.free}")
        for i, u in claim:
            self.free[i] -= u
        return claim

    def release(self, claim) -> None:
        for i, u in claim or ():
            self.free[i] = min(self.UNITS, self.free[i] + u)

    @staticmethod
    def ids_of(claim) -> List[str]:
        return [i for i, _ in claim or ()]
