"""Placement groups (reference: python/ray/util/placement_group.py:41,145;
GCS-side 2-phase reservation in _private/gcs.py)."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy

    def ready(self) -> bool:
        return self.wait(timeout=0)

    def wait(self, timeout: Optional[float] = 30.0) -> bool:
        from ray_tpu_torch import _get_worker
        w = _get_worker()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            info = w.gcs_call("get_placement_group", pg_id=self.id)
            if info is not None and info["state"] == "CREATED":
                return True
            if info is not None and info["state"] == "REMOVED":
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            # infeasible at creation time: ask GCS to try again
            w.gcs_call("create_placement_group", pg_id=self.id,
                       bundles=self.bundle_specs, strategy=self.strategy)
            time.sleep(0.2)

    def node_ids(self) -> Optional[List[str]]:
        from ray_tpu_torch import _get_worker
        info = _get_worker().gcs_call("get_placement_group", pg_id=self.id)
        return info["node_ids"] if info else None

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self.strategy))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    from ray_tpu_torch import _get_worker
    w = _get_worker()
    pg_id = os.urandom(8).hex()
    w.gcs_call("create_placement_group", pg_id=pg_id, bundles=bundles,
               strategy=strategy, name=name)
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch import _get_worker
    _get_worker().gcs_call("remove_placement_group", pg_id=pg.id)


def placement_group_table() -> List[Dict]:
    from ray_tpu_torch import _get_worker
    return _get_worker().gcs_call("get_all_placement_groups")
