"""Serve on the port's runtime: deployments, the controller, handles and
the router, replicas, the HTTP proxy, fleet admission, SLOs, the weight
plane and disaggregated prefill/decode. Importing it imports no torch:
only ``inference.LLMDeployment`` and the disaggregated tiers bring it in,
in the replica that builds them."""

from ray_tpu_torch.serve.api import (DEFAULT_HTTP_PORT,
                                     ShardedEngineReplica, batch,
                                     build_sharded_app, delete, deployment,
                                     fleet_status, get_app_handle,
                                     get_tenant_quotas, grpc_call, proxies,
                                     run, set_tenant_quota, shutdown,
                                     slo_status, start, status)
from ray_tpu_torch.serve.schema import deploy_from_config
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id,
                                           multiplexed)

__all__ = ["deployment", "run", "shutdown", "status", "batch", "delete",
           "get_app_handle", "Deployment", "Application",
           "DeploymentHandle", "DeploymentResponse", "multiplexed",
           "get_multiplexed_model_id", "start", "proxies", "grpc_call",
           "deploy_from_config", "slo_status", "fleet_status",
           "set_tenant_quota", "get_tenant_quotas",
           "ShardedEngineReplica", "build_sharded_app", "DEFAULT_HTTP_PORT"]
