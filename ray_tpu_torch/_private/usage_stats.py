"""Opt-out usage stats (reference: python/ray/_private/usage/usage_lib.py —
record_extra_usage_tag :220, library usage tracking; reported by the
dashboard). Here tags accumulate in the GCS KV under the "usage" namespace;
nothing leaves the cluster (the reference's remote reporting endpoint has
no analogue), so this records *which* framework features a session used —
surfaced via `usage_report()` and the dashboard.
"""

from __future__ import annotations

import os
from typing import Dict

_local_tags: Dict[str, str] = {}


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "1") != "0"


def record_library_usage(library: str) -> None:
    record_extra_usage_tag(f"library_{library}", "1")


def record_extra_usage_tag(key: str, value: str) -> None:
    if not usage_stats_enabled():
        return
    _local_tags[key] = value
    try:
        import ray_tpu_torch
        if ray_tpu_torch.is_initialized():
            ray_tpu_torch._get_worker().gcs_call(
                "kv_put", ns="usage", key=key.encode(),
                value=str(value).encode(), overwrite=True)
    except Exception:
        pass


def usage_report() -> Dict[str, str]:
    """All tags recorded cluster-wide this session."""
    out = dict(_local_tags)
    try:
        import ray_tpu_torch
        if ray_tpu_torch.is_initialized():
            keys = ray_tpu_torch._get_worker().gcs_call("kv_keys", ns="usage",
                                                  prefix=b"")
            for k in keys:
                v = ray_tpu_torch._get_worker().gcs_call("kv_get", ns="usage",
                                                   key=k)
                if v is not None:
                    out[k.decode()] = v.decode()
    except Exception:
        pass
    return out
