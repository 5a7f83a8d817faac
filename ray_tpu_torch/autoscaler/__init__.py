from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, AutoscalerConfig
from ray_tpu_torch.autoscaler.node_provider import (FakeMultiNodeProvider,
                                              NodeProvider)

__all__ = ["Autoscaler", "AutoscalerConfig", "NodeProvider",
           "FakeMultiNodeProvider"]
