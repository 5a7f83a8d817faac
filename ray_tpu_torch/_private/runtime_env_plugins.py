"""Runtime-env plugin protocol (reference:
python/ray/_private/runtime_env/plugin.py RuntimeEnvPlugin +
plugin_schema_manager — each runtime_env dict key is owned by one plugin,
plugins run in priority order and stack their effects into one context).

Two plugin planes, mirroring where the reference applies them:

- **Worker-scope** plugins (env_vars / working_dir / py_modules / pip /
  user plugins) materialize INSIDE the worker at task setup and mutate a
  RuntimeEnvContext that the worker applies/restores around execution
  (reference: RuntimeEnvContext, runtime_env/context.py).
- **Process-scope** env kinds (container) shape the worker process
  itself, so they are resolved by the NODE MANAGER at spawn time into a
  command wrapper (reference: runtime_env/image_uri.py — worker command
  runs under `podman run`).

Third-party plugins load from the RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS env var as
comma-separated ``module:Class`` paths (reference:
RAY_RUNTIME_ENV_PLUGINS), or programmatically via register_plugin().
"""

from __future__ import annotations

import importlib
import logging
import os
import shlex
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


class RuntimeEnvContext:
    """Mutable effect accumulator a worker applies around execution."""

    def __init__(self):
        self.env_vars: Dict[str, str] = {}
        self.py_paths: List[str] = []          # restored after the task
        self.permanent_py_paths: List[str] = []  # pip site: worker-lifetime
        self.cwd: Optional[str] = None


class RuntimeEnvPlugin:
    """Worker-scope plugin: owns the runtime_env key `name`.

    setup() runs on the worker's executor thread (blocking IO is fine)
    with the key's value, the full runtime_env dict, the context to
    mutate, and the CoreWorker (for GCS KV access etc.)."""

    name: str = ""
    priority: int = 50     # lower runs first (reference: plugin priority)

    def setup(self, value: Any, renv: Dict, ctx: RuntimeEnvContext,
              worker) -> None:
        raise NotImplementedError


class EnvVarsPlugin(RuntimeEnvPlugin):
    name = "env_vars"
    priority = 10

    def setup(self, value, renv, ctx, worker):
        for k, v in (value or {}).items():
            ctx.env_vars[str(k)] = str(v)


class WorkingDirPlugin(RuntimeEnvPlugin):
    """Handles both a live local path and the packed working_dir_uri
    form produced at submission (worker.py _pack_runtime_env)."""
    name = "working_dir"
    priority = 20

    def setup(self, value, renv, ctx, worker):
        wd = value
        if not wd and renv.get("working_dir_uri"):
            wd = worker._materialize_uri(renv["working_dir_uri"],
                                         renv.get("working_dir_base", ""))
        if wd:
            ctx.cwd = wd
            ctx.py_paths.append(wd)


class PyModulesPlugin(RuntimeEnvPlugin):
    name = "py_modules"
    priority = 30

    def setup(self, value, renv, ctx, worker):
        for uri, base in renv.get("py_modules_uris") or []:
            root = worker._materialize_uri(uri, base)
            ctx.py_paths.append(os.path.dirname(root))


class PipPlugin(RuntimeEnvPlugin):
    name = "pip"
    priority = 40

    def setup(self, value, renv, ctx, worker):
        if not value:
            return
        if isinstance(value, dict):
            value = value.get("packages") or []
        site = worker._ensure_pip_env([str(x) for x in value])
        # worker-lifetime: the pool only reuses this worker for the same
        # env hash, so the site-dir stays correct (per-env worker pools)
        ctx.permanent_py_paths.append(site)


_BUILTIN = [EnvVarsPlugin(), WorkingDirPlugin(), PyModulesPlugin(),
            PipPlugin()]
_EXTRA: List[RuntimeEnvPlugin] = []
_LOADED_FROM_ENV = False


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    """Programmatic registration (dedup by plugin name)."""
    unregister_plugin(plugin.name)
    _EXTRA.append(plugin)


def unregister_plugin(name: str) -> None:
    _EXTRA[:] = [p for p in _EXTRA if p.name != name]


def _load_env_plugins() -> None:
    """RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS="pkg.mod:Class,..." (reference:
    RAY_RUNTIME_ENV_PLUGINS json spec; module:attr matches this repo's
    xlang convention). Loaded once, lazily, in the worker process."""
    global _LOADED_FROM_ENV
    if _LOADED_FROM_ENV:
        return
    _LOADED_FROM_ENV = True
    spec = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS", "")
    for path in filter(None, (s.strip() for s in spec.split(","))):
        try:
            mod, _, attr = path.partition(":")
            cls = getattr(importlib.import_module(mod), attr)
            register_plugin(cls())
        except Exception:
            logger.exception("failed to load runtime env plugin %r", path)


def plugins() -> List[RuntimeEnvPlugin]:
    _load_env_plugins()
    return sorted(_BUILTIN + _EXTRA, key=lambda p: p.priority)


def apply_worker_plugins(renv: Dict, worker) -> RuntimeEnvContext:
    """Dispatch every plugin whose key appears in `renv` (priority
    order), returning the accumulated context. Unknown renv keys without
    a plugin are ignored, matching the reference's pass-through for
    keys handled elsewhere (e.g. container at spawn time)."""
    ctx = RuntimeEnvContext()
    for p in plugins():
        if p.name in renv or (p.name == "working_dir"
                              and "working_dir_uri" in renv) \
                or (p.name == "py_modules" and "py_modules_uris" in renv):
            p.setup(renv.get(p.name), renv, ctx, worker)
    return ctx


def runtime_env_hash(renv: Optional[Dict]) -> Optional[str]:
    """Worker-pool key for a runtime env (reference: WorkerPool keyed by
    runtime-env hash, worker_pool.h:174): a pip env permanently shapes a
    worker's sys.path and a container permanently shapes the process, so
    such workers are never handed to tasks/actors of other envs. ONE
    hash scheme for both the task-lease and actor-creation paths —
    split schemes would let a container worker with one pip env be
    adopted for the same container with a different pip env."""
    if not renv:
        return None
    pip = renv.get("pip")
    proc = proc_env_of(renv)
    if not pip and not proc:
        return None
    import hashlib
    if isinstance(pip, dict):
        pip = pip.get("packages") or []
    parts = ["\n".join(sorted(map(str, pip or [])))]
    if proc:
        parts.append(repr(sorted(proc["container"].items())))
    return hashlib.sha1("\x00".join(parts).encode()).hexdigest()[:16]


# --------------------------------------------------- process-scope: container
def proc_env_of(renv: Optional[Dict]) -> Optional[Dict]:
    """The process-level subset of a runtime env — what the node manager
    needs at worker SPAWN time (today: container). Rides the lease
    request next to env_hash."""
    if not renv:
        return None
    container = renv.get("container") or (
        {"image": renv["image_uri"]} if renv.get("image_uri") else None)
    if not container:
        return None
    if isinstance(container, str):
        container = {"image": container}
    return {"container": container}


# env vars forwarded into the container (the worker needs its node/GCS
# wiring plus accelerator/runtime knobs, CUDA_VISIBLE_DEVICES among them;
# a blanket pass-through would leak host state the image should not see)
_FORWARD_PREFIXES = ("RAY_TPU_TORCH_", "CUDA_", "NCCL_", "TORCH_",
                     "PYTHON")


def container_command(proc_env: Dict, cmd: List[str],
                      env: Dict[str, str]) -> List[str]:
    """Wrap a worker command in `<runtime> run` (reference:
    runtime_env/image_uri.py _modify_context — worker under podman).
    --network=host keeps the RPC plane flat; the runtime's directory
    (``proc_util.runtime_dir()``: sockets, logs, runtime-env cache) is
    bind-mounted so the containered
    worker shares the node's data plane.

    The runtime binary defaults to podman, overridable via
    RAY_TPU_TORCH_CONTAINER_RUNTIME (also how tests inject a stub)."""
    spec = proc_env["container"]
    image = spec["image"]
    runtime = os.environ.get("RAY_TPU_TORCH_CONTAINER_RUNTIME",
                             spec.get("runtime", "podman"))
    from ray_tpu_torch._private.proc_util import runtime_dir
    root = runtime_dir()
    wrapped = [runtime, "run", "--rm", "--network=host",
               "-v", f"{root}:{root}"]
    for k, v in env.items():
        if k.startswith(_FORWARD_PREFIXES) or k == "PATH":
            wrapped += ["--env", f"{k}={v}"]
    for opt in spec.get("run_options") or []:
        wrapped += shlex.split(str(opt)) if isinstance(opt, str) else [opt]
    wrapped.append(image)
    wrapped += cmd
    return wrapped
