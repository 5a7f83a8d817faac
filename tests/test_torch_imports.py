"""The PyTorch port stands alone: no module of ray_tpu_torch, and not
chip_smoke.py, imports JAX, flax, optax or anything of ray_tpu. And the
two runtimes never meet: no string of the port names a ray_tpu module
(a launch string such as ``-m ray_tpu._private.worker_main`` would start
the JAX package's worker) or a ``RAY_TPU_`` environment variable of the
JAX package's, the port's control plane imports no torch, and every
process of a port session runs a ray_tpu_torch module."""

import ast
import os
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_ray_tpu():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {name}" for f in files
           for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


# what the mesh and pipeline tests' gloo ranks import: they must start
# without JAX
WORLD_FILES = ("tests/torch_world.py", "tests/torch_mesh_cases.py",
               "tests/torch_pipeline_cases.py")
MESH_MODULES = ("ray_tpu_torch.parallel.mesh",
                "ray_tpu_torch.parallel.sharding",
                "ray_tpu_torch.parallel.pipeline",
                "ray_tpu_torch.ops.ring_attention",
                "ray_tpu_torch.ops.dispatch", "ray_tpu_torch.models.axes",
                "ray_tpu_torch.train.config", "ray_tpu_torch.train.mpmd",
                "ray_tpu_torch.train.sharded_checkpoint",
                "ray_tpu_torch.util.storage")


def test_mesh_worlds_import_no_jax():
    bad = [f"{f}: {name}" for f in WORLD_FILES
           for name in _imports(ROOT / f)
           if name.split(".")[0] in FORBIDDEN[:4]
           or name.startswith("ray_tpu.")]
    assert not bad, bad


def test_every_module_imports_without_jax():
    """Import the whole package (the mesh modules by name) and the world
    helpers in a fresh interpreter: none of them pulls in JAX or the JAX
    package."""
    import subprocess
    import sys
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in (ROOT / "ray_tpu_torch").rglob("*.py")
                  if p.name != "__init__.py")
    assert set(MESH_MODULES) <= set(mods)
    mods += [f[:-3].replace("/", ".") for f in WORLD_FILES]
    code = (f"import importlib, sys\n"
            f"for m in {mods!r}:\n"
            f"    importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            f"print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _strings(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.lineno, node.value


# a ray_tpu module by dotted name, a `-m ray_tpu...` launch that is not
# the port's, and an env name of the JAX package's (RAY_TPU_ without
# TORCH_)
_JAX_MODULE = re.compile(r"\bray_tpu\.[A-Za-z_]|-m\s+ray_tpu(?!_torch)")
_JAX_ENV = re.compile(r"\bRAY_TPU_(?!TORCH_)")


@pytest.mark.parametrize("pattern", [_JAX_MODULE, _JAX_ENV],
                         ids=["module", "env"])
def test_port_strings_never_name_the_jax_runtime(pattern):
    bad = [f"{f.relative_to(ROOT)}:{line}: {s[:80]!r}"
           for f in _port_files() for line, s in _strings(f)
           if pattern.search(s)]
    assert not bad, bad


def test_name_rules_catch_the_reference_launch_strings():
    """The rules above flag what the JAX package's runtime spawns and
    reads (so a copy that kept them would fail)."""
    launch = [s for _, s in _strings(ROOT / "ray_tpu/_private/node_manager.py")
              if _JAX_MODULE.search(s)]
    assert "ray_tpu._private.worker_main" in launch
    env = [s for _, s in _strings(ROOT / "ray_tpu/__init__.py")
           if _JAX_ENV.search(s)]
    assert "RAY_TPU_ADDRESS" in env


# Serve: the port's own copy, whose actors (controller, proxy, replicas)
# are launched by the port's runtime from these modules
SERVE_MODULES = ("ray_tpu_torch.serve", "ray_tpu_torch.serve.api",
                 "ray_tpu_torch.serve.controller",
                 "ray_tpu_torch.serve.deployment",
                 "ray_tpu_torch.serve.fleet", "ray_tpu_torch.serve.handle",
                 "ray_tpu_torch.serve.long_poll",
                 "ray_tpu_torch.serve.multiplex",
                 "ray_tpu_torch.serve.proxy", "ray_tpu_torch.serve.replica",
                 "ray_tpu_torch.serve.schema", "ray_tpu_torch.serve.slo",
                 "ray_tpu_torch.serve.weights",
                 # sharded serving, the gRPC ingress and the chaos hooks:
                 # the controller, the gRPC proxy and every gang rank
                 # import them before any model is built
                 "ray_tpu_torch.serve.sharded",
                 "ray_tpu_torch.serve.sharded_replica",
                 "ray_tpu_torch.serve.grpc_proxy",
                 "ray_tpu_torch.util.serve_grpc_demo",
                 "ray_tpu_torch.util.chaos")


def test_serve_is_scanned_and_imports_no_torch():
    """Every Serve module is among the files the scans above read (so
    none imports JAX or names the JAX runtime), and importing Serve, with
    the modules its controller, proxy and replica actors run, loads no
    torch (only LLMDeployment and the disaggregated tiers do, in the
    replica that builds them)."""
    import subprocess
    import sys
    scanned = {".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in _port_files()}
    assert {m for m in SERVE_MODULES if m != "ray_tpu_torch.serve"} \
        | {"ray_tpu_torch.serve.disagg",
           "ray_tpu_torch.inference.api"} <= scanned
    launched = {"ServeController": "ray_tpu_torch.serve.controller",
                "HttpProxy": "ray_tpu_torch.serve.proxy",
                "Replica": "ray_tpu_torch.serve.replica",
                "GrpcProxy": "ray_tpu_torch.serve.grpc_proxy",
                "ReplicaShard": "ray_tpu_torch.serve.sharded_replica",
                "ShardedEngineReplica": "ray_tpu_torch.serve.sharded"}
    code = ("import importlib, sys\n"
            f"for m in {SERVE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            f"for cls, mod in {launched!r}.items():\n"
            "    assert getattr(sys.modules[mod], cls).__module__ == mod\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{('torch',) + FORBIDDEN[:4]!r} or m.startswith('ray_tpu.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_serve_stubs_are_gone_and_slice_gangs_name_a3c2():
    """No module of the port still raises for Serve's remaining pieces
    (ROADMAP item A3g-2 is ported: no file names it), and a gang on a
    slice topology, which waits for A3c-2, is refused naming it."""
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in _port_files()
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if "A3g-2" in line]
    assert not hits, hits
    from ray_tpu_torch.serve.sharded_replica import refuse_topology
    refuse_topology({"num_hosts": 2})
    with pytest.raises(NotImplementedError, match="A3c-2"):
        refuse_topology({"num_hosts": 2, "topology": "v4-16"})


CONTROL_PLANE = ("ray_tpu_torch/_private/gcs.py",
                 "ray_tpu_torch/_private/node_manager.py",
                 *sorted(str(p.relative_to(ROOT)) for p in
                         (ROOT / "ray_tpu_torch/_private/accelerators")
                         .glob("*.py")))


def test_control_plane_imports_no_torch():
    """The GCS, the node manager and GPU detection import no torch, in
    their source and in a fresh interpreter (importing ray_tpu_torch
    itself must not pull it in either)."""
    import subprocess
    import sys
    bad = [f"{f}: {name}" for f in CONTROL_PLANE
           for name in _imports(ROOT / f) if name.split(".")[0] == "torch"]
    assert not bad, bad
    mods = [f[:-3].replace("/", ".") for f in CONTROL_PLANE]
    code = ("import importlib, sys\n"
            "import ray_tpu_torch\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from ray_tpu_torch._private.accelerators import "
            "detect_node_accelerators\n"
            "detect_node_accelerators()\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _descendants(root_pid):
    children = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(pid))
    out, todo = [], [root_pid]
    while todo:
        for c in children.get(todo.pop(), []):
            out.append(c)
            todo.append(c)
    return out


def test_session_processes_run_port_modules():
    """After init() on the CPU (and a task and an actor, so workers
    exist), every process the session started (every descendant of this
    process whose command line carries the session's name) runs a
    ray_tpu_torch module: the GCS, the node manager and the workers."""
    import ray_tpu_torch as rt
    rt.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    session = rt._context.node.session_name.encode()
    try:
        @rt.remote
        def f():
            return os.getpid()

        @rt.remote
        class A:
            def pid(self):
                return os.getpid()

        a = A.remote()
        worker_pids = {rt.get(f.remote()), rt.get(a.pid.remote())}
        cmds = {}
        for pid in _descendants(os.getpid()):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as fh:
                    cmd = fh.read().split(b"\0")
            except OSError:
                continue
            if session in cmd:
                cmds[pid] = cmd
        mods = {pid: c[c.index(b"-m") + 1].decode() if b"-m" in c else ""
                for pid, c in cmds.items()}
        assert worker_pids <= set(mods)
        started = {m for m in mods.values()}
        assert {"ray_tpu_torch._private.gcs",
                "ray_tpu_torch._private.node_manager",
                "ray_tpu_torch._private.worker_main"} <= started, mods
        assert all(m.startswith("ray_tpu_torch.") for m in mods.values()), \
            mods
    finally:
        rt.shutdown()


# observability and the train executor: what a driver reading the state
# API or a train worker whose loop needs no torch imports
LIGHT_MODULES = ("ray_tpu_torch.train", "ray_tpu_torch.train.trainer",
                 "ray_tpu_torch.train.backend_executor",
                 "ray_tpu_torch.train.session",
                 "ray_tpu_torch.train.checkpoint",
                 "ray_tpu_torch.train.config",
                 "ray_tpu_torch.util.profiling",
                 "ray_tpu_torch.util.tracing", "ray_tpu_torch.util.state",
                 "ray_tpu_torch.util.collective")


def test_observability_and_train_executor_exist_and_load_no_torch():
    """The names of the slice exist, ``timeline`` no longer raises for
    want of a module, and importing the train executor, the profiler, the
    tracing export, the state API and the collectives loads no torch (the
    MPMD trainer loads on first touch, as in the JAX package)."""
    import subprocess
    import sys
    code = ("import importlib, inspect, sys\n"
            f"for m in {LIGHT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'torch' not in sys.modules, 'torch'\n"
            "import ray_tpu_torch\n"
            "from ray_tpu_torch import train\n"
            "from ray_tpu_torch.util import collective, profiling, state\n"
            "for n in ('TorchTrainer', 'Result', 'ScalingConfig', "
            "'RunConfig', 'CheckpointConfig', 'DataConfig', "
            "'FailureConfig', 'Checkpoint', 'report', 'get_context', "
            "'get_checkpoint', 'step_profiler', 'MPMDPipelineTrainer'):\n"
            "    assert getattr(train, n) is not None, n\n"
            "assert profiling.StepProfiler and profiling.decode_step_flops\n"
            "assert state.list_nodes and state.query_metrics\n"
            "assert collective.allreduce and collective.recv\n"
            "src = inspect.getsource(ray_tpu_torch.timeline)\n"
            "assert 'NotImplementedError' not in src\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# RL (ROADMAP A6): the port's counterpart of every module of ray_tpu/rl
RL_MODULES = ("ray_tpu_torch.rl", "ray_tpu_torch.rl.actor_manager",
              "ray_tpu_torch.rl.algorithm", "ray_tpu_torch.rl.appo",
              "ray_tpu_torch.rl.config", "ray_tpu_torch.rl.connectors",
              "ray_tpu_torch.rl.dqn", "ray_tpu_torch.rl.env_runner",
              "ray_tpu_torch.rl.envs", "ray_tpu_torch.rl.external",
              "ray_tpu_torch.rl.impala", "ray_tpu_torch.rl.learner",
              "ray_tpu_torch.rl.multi_agent", "ray_tpu_torch.rl.offline",
              "ray_tpu_torch.rl.replay_buffer", "ray_tpu_torch.rl.rl_module",
              "ray_tpu_torch.rl.sac", "ray_tpu_torch.rl.vtrace")


def test_rl_modules_mirror_jax_and_need_no_jax_or_gymnasium():
    """Every module of ray_tpu/rl has its namesake in ray_tpu_torch/rl,
    exporting the same public names; importing them all, in a fresh
    interpreter where gymnasium cannot be imported, loads no JAX (and no
    gymnasium: it is imported where an env is built)."""
    import subprocess
    import sys
    jax_mods = {p.stem for p in (ROOT / "ray_tpu/rl").glob("*.py")}
    port_mods = {p.stem for p in (ROOT / "ray_tpu_torch/rl").glob("*.py")}
    assert jax_mods == port_mods == {m.rsplit(".", 1)[-1] if m.count(".") > 1
                                     else "__init__" for m in RL_MODULES}
    jax_all = [n.id if isinstance(n, ast.Name) else n.value
               for node in ast.walk(ast.parse(
                   (ROOT / "ray_tpu/rl/__init__.py").read_text()))
               if isinstance(node, ast.Assign)
               and node.targets[0].id == "__all__"
               for n in node.value.elts]
    code = ("import importlib, sys\n"
            "sys.modules['gymnasium'] = None\n"
            f"for m in {RL_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import ray_tpu_torch.rl as rl\n"
            f"assert sorted(rl.__all__) == {sorted(jax_all)!r}, rl.__all__\n"
            "assert all(getattr(rl, n) for n in rl.__all__)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} or (m.startswith('gymnasium') and "
            f"sys.modules[m] is not None)]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# cluster services (ROADMAP A7c): the CLI, jobs, the dashboard, the
# autoscaler and usage stats run in processes that load no model
CLUSTER_SERVICES = ("ray_tpu_torch.job_submission", "ray_tpu_torch.dashboard",
                    "ray_tpu_torch.autoscaler",
                    "ray_tpu_torch.autoscaler.autoscaler",
                    "ray_tpu_torch.autoscaler.instance_manager",
                    "ray_tpu_torch.autoscaler.launcher",
                    "ray_tpu_torch.autoscaler.node_provider",
                    "ray_tpu_torch.scripts.cli",
                    "ray_tpu_torch._private.usage_stats")


def test_cluster_services_are_scanned_and_import_no_torch():
    """Every cluster-service module is among the files the scans above
    read, and importing them all loads no torch (nor JAX)."""
    import subprocess
    import sys
    scanned = {".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in _port_files()}
    assert {m for m in CLUSTER_SERVICES
            if m != "ray_tpu_torch.autoscaler"} <= scanned
    code = ("import importlib, sys\n"
            f"for m in {CLUSTER_SERVICES!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{('torch',) + FORBIDDEN[:4]!r} or m.startswith('ray_tpu.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a7c_a7d_are_ported_and_what_waits_names_its_item():
    """No module of the port still refuses a piece of A7c or A7d (the
    orbax half of the sharded checkpoint, checkpoint_weight_source);
    the TPU-slice provider waits for A3c-2 and `lint` for the last item of
    Queue A, and each says so."""
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in _port_files()
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if re.search(r"\bA7[cd]\b|orbax half .* not ported", line)]
    assert not hits, hits
    from ray_tpu_torch.serve.weights import checkpoint_weight_source
    assert callable(checkpoint_weight_source("/nonexistent"))
    from ray_tpu_torch.autoscaler.node_provider import GcpTpuNodeProvider
    with pytest.raises(NotImplementedError, match="A3c-2"):
        GcpTpuNodeProvider("p", "z", "10.0.0.1:6379")
    from ray_tpu_torch.scripts import cli
    with pytest.raises(NotImplementedError, match="devtools/lint"):
        cli.cmd_lint(None)
