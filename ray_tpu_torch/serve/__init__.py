"""Serve on the port's runtime: deployments, the controller, handles and
the router, replicas, the HTTP and gRPC proxies, fleet admission, SLOs,
the weight plane, disaggregated prefill/decode and sharded replicas (a
gang of ranks in lockstep). Importing it imports no torch: only
``inference.LLMDeployment``, the disaggregated tiers and
``ShardedEngineReplica`` bring it in, in the replica that builds them."""

from ray_tpu_torch.serve.api import (DEFAULT_HTTP_PORT, batch, delete,
                                     deployment, fleet_status,
                                     get_app_handle, get_tenant_quotas,
                                     proxies, run, set_tenant_quota,
                                     shutdown, slo_status, start, status)
from ray_tpu_torch.serve.grpc_proxy import grpc_call
from ray_tpu_torch.serve.schema import deploy_from_config
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id,
                                           multiplexed)
from ray_tpu_torch.serve.sharded import (ShardedEngineReplica,
                                         build_sharded_app)

__all__ = ["deployment", "run", "shutdown", "status", "batch", "delete",
           "get_app_handle", "Deployment", "Application",
           "DeploymentHandle", "DeploymentResponse", "multiplexed",
           "get_multiplexed_model_id", "start", "proxies", "grpc_call",
           "deploy_from_config", "slo_status", "fleet_status",
           "set_tenant_quota", "get_tenant_quotas",
           "ShardedEngineReplica", "build_sharded_app", "DEFAULT_HTTP_PORT"]
