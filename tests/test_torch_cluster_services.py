"""The port's cluster services on its own runtime, as the JAX package's
tests hold them: jobs, the dashboard's REST surface and usage stats
(tests/test_state_jobs.py:55, :67, :76, :164; tests/test_util_shims.py:29),
and the CLI (tests/test_serve_cli_grpc.py:45,
tests/test_control_plane_obs.py:323, tests/test_object_ledger.py:338-362),
plus what the port adds: the dashboard binds loopback unless told
otherwise, the CLI's head file lives under the runtime's directory, and
``start``/``submit``/``list``/``stop`` run as processes against one
session and leave none of it behind. The CLI's subcommands and the
dashboard's routes are the JAX package's, read from both sources.

The dashboard and the HTTP proxy bind port 0 (the JAX tests use fixed
ports, which parallel test files would share)."""

import ast
import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import yaml

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.util import state

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cluster():
    ctx = rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024,
                  _system_config={"serve_reconcile_period_s": 0.25})
    try:
        yield ctx
    finally:
        serve.shutdown()
        rt.shutdown()


@pytest.fixture(scope="module")
def dashboard(cluster):
    from ray_tpu_torch.dashboard import start_dashboard
    h = start_dashboard(port=0)
    return rt.get(h.url.remote(), timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_job_submission(cluster):
    from ray_tpu_torch.job_submission import JobSubmissionClient
    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('job says hi')\"")
    status = client.wait_until_finished(job_id, timeout=60)
    assert status == "SUCCEEDED"
    assert "job says hi" in client.get_job_logs(job_id)
    assert any(j["job_id"] == job_id for j in client.list_jobs())


def test_job_failure_status(cluster):
    from ray_tpu_torch.job_submission import JobSubmissionClient
    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import sys; sys.exit(3)\"")
    assert client.wait_until_finished(job_id, timeout=60) == "FAILED"
    assert client.get_job_info(job_id)["returncode"] == 3


def test_dashboard_rest(dashboard):
    assert len(_get(f"{dashboard}/api/nodes")) == 1
    assert _get(f"{dashboard}/api/cluster_status")["nodes_alive"] == 1
    assert _get(f"{dashboard}/api/version")["version"] == rt.__version__
    req = urllib.request.Request(
        f"{dashboard}/api/jobs",
        data=json.dumps({"entrypoint":
                         f"{sys.executable} -c \"print('rest job')\""}
                        ).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        job_id = json.loads(r.read())["job_id"]
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        info = _get(f"{dashboard}/api/jobs/{job_id}")
        if info["status"] in ("SUCCEEDED", "FAILED"):
            break
        time.sleep(0.5)
    assert info["status"] == "SUCCEEDED"
    assert "rest job" in _get(f"{dashboard}/api/jobs/{job_id}/logs")["logs"]
    assert any(j["job_id"] == job_id
               for j in _get(f"{dashboard}/api/jobs"))


def test_dashboard_index_and_timeline(dashboard, tmp_path):
    @rt.remote
    def traced_task(x):
        return x + 1

    assert rt.get(traced_task.remote(1), timeout=30) == 2
    with urllib.request.urlopen(f"{dashboard}/", timeout=10) as resp:
        body = resp.read().decode()
    assert "ray_tpu_torch dashboard" in body and "/api/" in body
    time.sleep(2.0)        # task-event buffers flush every 1s
    out = str(tmp_path / "trace.json")
    rt.timeline(out)
    trace = json.loads(open(out).read())
    assert any(ev.get("name") == "traced_task" for ev in trace)


def test_dashboard_binds_loopback_by_default(dashboard):
    """POST /api/jobs runs a shell entrypoint: the server listens on
    127.0.0.1 only, so the node's own address refuses it."""
    assert dashboard.startswith("http://127.0.0.1:")
    port = int(dashboard.rsplit(":", 1)[1])
    host = rt.get_gcs_address().split(":")[-2]
    assert host not in ("127.0.0.1", "localhost")
    with pytest.raises(OSError):
        socket.create_connection((host, port), timeout=5).close()


def test_usage_stats(cluster):
    from ray_tpu_torch._private import usage_stats
    usage_stats.record_library_usage("train")
    usage_stats.record_extra_usage_tag("topology", "h100-1")
    rep = usage_stats.usage_report()
    assert rep.get("library_train") == "1"
    assert rep.get("topology") == "h100-1"


def test_serve_cli_deploy_status_delete(cluster, tmp_path):
    """serve deploy from YAML → status shows the app → HTTP answers →
    delete removes it, through the CLI's functions in process."""
    from ray_tpu_torch.scripts import cli
    cfg = {
        "http_options": {"port": 0},
        "applications": [{
            "name": "cliapp", "route_prefix": "/cliapp",
            "import_path":
                "ray_tpu_torch.util.serve_grpc_demo:build_echo_app",
            "args": {"prefix": "cli"},
            "deployments": [{"name": "EchoDeployment",
                             "num_replicas": 2}]}]}
    path = tmp_path / "serve.yaml"
    path.write_text(yaml.safe_dump(cfg))

    class _A:
        config = str(path)
        address = rt.get_gcs_address()

    out = io.StringIO()
    with redirect_stdout(out):
        cli.cmd_serve_deploy(_A())
    assert "deployed 1 application(s)" in out.getvalue()
    assert serve.status()["cliapp"]["EchoDeployment"]["target"] == 2
    (addr,) = [p["http"] for p in serve.proxies().values()]
    req = urllib.request.Request(
        f"http://{addr}/cliapp", data=json.dumps("ping").encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert json.loads(resp.read()) == {"echo": "ping", "prefix": "cli"}
    out = io.StringIO()
    with redirect_stdout(out):
        cli.cmd_serve_status(_A())
    assert "cliapp" in json.loads(out.getvalue())["applications"]

    class _D:
        name = "cliapp"
        address = rt.get_gcs_address()
        all = False

    with redirect_stdout(io.StringIO()):
        cli.cmd_serve_delete(_D())
    assert "cliapp" not in serve.status()


def test_blackbox_cli_merge(tmp_path, capsys):
    from ray_tpu_torch._private import blackbox
    from ray_tpu_torch.scripts import cli
    box = blackbox.BlackBox(str(tmp_path / "gcs-7.bbox.ndjson"),
                            process="gcs")
    box.record("marker", event="startup")
    box.seal("signal_15")

    class Args:
        paths = [str(tmp_path)]
        json = True
        limit = 0
        max_skew = 0.0

    cli.cmd_blackbox(Args())
    out = json.loads(capsys.readouterr().out)
    assert out["boxes"][0]["seal_reason"] == "signal_15"
    assert [r["rec"]["kind"] for r in out["records"]][-1] == "seal"
    Args.json = False
    cli.cmd_blackbox(Args())
    text = capsys.readouterr().out
    assert "SEALED: signal_15" in text and "gcs" in text


def test_cli_memory_sort_group_format_and_pane():
    from ray_tpu_torch.scripts import cli
    rows = [
        {"object_id": "a" * 40, "kind": "owned+shm", "size_bytes": 10,
         "pins": 0, "age_s": 100.0, "is_span": False, "owner": "w:1",
         "node_id": "n1", "locations": ["n1"]},
        {"object_id": "b" * 40, "kind": "ledger", "size_bytes": 999,
         "pins": 2, "age_s": 1.0, "is_span": True, "owner": "w:2",
         "node_id": "n2", "locations": ["n1", "n2"], "leaked": True},
    ]
    assert [r["size_bytes"] for r in cli._memory_sorted(rows, "size")] \
        == [999, 10]
    assert [r["age_s"] for r in cli._memory_sorted(rows, "age")] \
        == [100.0, 1.0]
    assert [r["node_id"] for r in cli._memory_sorted(rows, "node")] \
        == ["n1", "n2"]
    groups = {g["group"]: g for g in cli._memory_grouped(rows, "owner")}
    assert groups["w:2"]["leaked_bytes"] == 999
    assert groups["w:1"]["bytes"] == 10
    text = cli._format_memory_rows(rows)
    assert "LEAK" in text and "yes" in text and "w:1" in text

    class FakeState:
        @staticmethod
        def query_metrics(name, window, agg):
            return {"value": {"store_bytes_in_use": 12345.0,
                              "data_plane_bytes_in_total": 1e6}.get(name)}
    pane = cli._memory_pane(FakeState, 30.0)
    assert "arena bytes in use" in pane and "data-plane B/s in" in pane
    assert "leaked" not in pane   # no value pushed -> row omitted


def test_lint_names_its_queue_item():
    from ray_tpu_torch.scripts import cli
    with pytest.raises(NotImplementedError, match="devtools/lint"):
        cli.main(["lint", "."])


def _subcommands(path):
    """The names passed to ``add_parser`` in a CLI source."""
    tree = ast.parse(Path(path).read_text())
    return sorted(n.args[0].value for n in ast.walk(tree)
                  if isinstance(n, ast.Call)
                  and getattr(n.func, "attr", "") == "add_parser")


def _routes(path):
    tree = ast.parse(Path(path).read_text())
    return sorted((n.func.attr, n.args[0].value) for n in ast.walk(tree)
                  if isinstance(n, ast.Call)
                  and getattr(n.func, "attr", "") in ("add_get", "add_post"))


def test_cli_and_dashboard_surface_match_the_jax_package():
    assert _subcommands(ROOT / "ray_tpu_torch/scripts/cli.py") == \
        _subcommands(ROOT / "ray_tpu/scripts/cli.py")
    assert _routes(ROOT / "ray_tpu_torch/dashboard.py") == \
        _routes(ROOT / "ray_tpu/dashboard.py")


def _cli(*argv, env, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_processes_start_submit_list_stop(tmp_path):
    """start --head --dashboard, submit --wait, list jobs and stop as
    processes, under a TMPDIR of their own: the head file is under the
    runtime's directory there, the job succeeds and lists, and stop
    leaves no process or arena of the session."""
    env = dict(os.environ, TMPDIR=str(tmp_path),
               PYTHONPATH=str(ROOT))
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    started = _cli("start", "--head", "--num-cpus", "1", "--dashboard",
                   "--dashboard-port", "0", env=env)
    head = tmp_path / "raytpu_torch" / "latest_head.json"
    session = json.loads(head.read_text())["session"]
    try:
        assert started.returncode == 0, started.stderr
        assert "dashboard at http://127.0.0.1:" in started.stdout
        sub = _cli("submit", "--wait",
                   f"{sys.executable} -c 'print(6*7)'", env=env)
        assert sub.returncode == 0, sub.stdout + sub.stderr
        assert "42" in sub.stdout and "SUCCEEDED" in sub.stdout
        jobs = json.loads(_cli("list", "jobs", env=env).stdout)
        assert [j["status"] for j in jobs
                if str(j["job_id"]).startswith("raysubmit_")] \
            == ["SUCCEEDED"]
    finally:
        stopped = _cli("stop", env=env)
        from ray_tpu_torch.scripts.cli import stop_session
        left = stop_session(session)        # what stop missed, if anything
    assert stopped.returncode == 0 and not head.exists()
    assert left == 0
    assert not list(Path("/dev/shm").glob(f"raytpu_torch_{session}_*"))
