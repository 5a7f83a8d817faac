"""Host-side utilities of the port: placement groups and scheduling
strategies (the runtime's public ``util`` exports), storage URIs, metrics,
chaos hooks and sanitizers. Imported from their own modules, as in the
JAX package: ``profiling`` (StepProfiler), ``tracing`` (chrome and OTLP
export, cluster stacks), ``state`` (the state API) and ``collective``."""

from ray_tpu_torch.util.placement_group import (placement_group,
                                                placement_group_table,
                                                remove_placement_group,
                                                PlacementGroup)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy)

__all__ = [
    "placement_group", "placement_group_table", "remove_placement_group",
    "PlacementGroup", "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy", "SpreadSchedulingStrategy",
]
