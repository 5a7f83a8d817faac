"""Scheduling strategies (reference:
python/ray/util/scheduling_strategies.py:15,41)."""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group,
                 placement_group_bundle_index: int = 0,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = \
            placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class SpreadSchedulingStrategy:
    def __str__(self):
        return "SPREAD"
