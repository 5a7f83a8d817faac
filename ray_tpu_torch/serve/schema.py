"""Declarative (YAML / dict) Serve config (reference:
python/ray/serve/schema.py — ServeDeploySchema; `serve deploy config.yaml`).

Schema::

    http_options:
      port: 8100
    grpc_options:
      port: 9000
    applications:
      - name: my_app
        route_prefix: /app
        import_path: my_module:app_builder     # returns an Application
        args: {...}                            # passed to the builder
        deployments:                           # per-deployment overrides
          - name: MyDeployment
            num_replicas: 3
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional, Union


def _load_config(config: Union[str, Dict]) -> Dict:
    if isinstance(config, dict):
        return config
    import yaml
    with open(config) as f:
        return yaml.safe_load(f)


def _import_attr(path: str):
    if ":" in path:
        mod, attr = path.split(":", 1)
    else:
        mod, attr = path.rsplit(".", 1)
    target = importlib.import_module(mod)
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def deploy_from_config(config: Union[str, Dict]) -> List:
    """Deploy every application in a declarative config; returns the app
    handles in declaration order."""
    from ray_tpu_torch.serve import api

    conf = _load_config(config)
    http = conf.get("http_options") or {}
    grpc = conf.get("grpc_options") or {}
    if http.get("port") is not None or grpc.get("port") is not None:
        api.start(http_port=http.get("port"), grpc_port=grpc.get("port"),
                  grpc_servicer_functions=grpc.get(
                      "grpc_servicer_functions"))

    handles = []
    for app_conf in conf.get("applications", []):
        name = app_conf["name"]
        builder = _import_attr(app_conf["import_path"])
        args = app_conf.get("args") or {}
        app = builder(**args) if args else (
            builder() if callable(builder) else builder)
        overrides = {d["name"]: d for d in app_conf.get("deployments", [])}
        if overrides:
            _apply_overrides(app, overrides)
        handles.append(api.run(app, name=name,
                               route_prefix=app_conf.get("route_prefix",
                                                         f"/{name}")))
    return handles


def _apply_overrides(app, overrides: Dict[str, Dict]) -> None:
    """Apply per-deployment config overrides onto a built application
    graph (num_replicas, max_ongoing_requests, ray_actor_options,
    autoscaling_config), replacing each node's Deployment in place."""
    for node in app.flatten():
        ov = overrides.get(node.deployment.name)
        if ov:
            node.deployment = node.deployment.options(
                **{k: ov[k] for k in ("num_replicas",
                                      "max_ongoing_requests",
                                      "ray_actor_options",
                                      "autoscaling_config",
                                      "num_hosts", "topology") if k in ov})
