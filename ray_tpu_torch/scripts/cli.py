"""CLI: `python -m ray_tpu_torch.scripts.cli <cmd>` (reference:
python/ray/scripts/scripts.py — ray start/stop/status/submit/list).

Counterpart of ``ray_tpu/scripts/cli.py``, with every subcommand but
``lint`` (the JAX package's linter; ROADMAP.md Queue A, last item). The
head file and the black boxes live under the runtime's directory
(``proc_util.runtime_dir``). ``stop`` stops the session that ``start
--head`` recorded in the head file, and ``down`` the one ``up`` started:
the processes whose command line names the session, never another
runtime's on the same host."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def head_file() -> str:
    from ray_tpu_torch._private.proc_util import runtime_dir
    return runtime_dir("latest_head.json")


def _save_head(info):
    path = head_file()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(info, f)


def _load_address(args) -> str:
    addr = getattr(args, "address", None) or \
        os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if addr:
        return addr
    try:
        with open(head_file()) as f:
            return json.load(f)["gcs_address"]
    except OSError:
        print("no running cluster found (ray_tpu_torch start --head first)",
              file=sys.stderr)
        sys.exit(1)


def cmd_start(args):
    from ray_tpu_torch._private import node as node_mod
    if args.head:
        head = node_mod.start_head(
            num_cpus=args.num_cpus,
            resources=json.loads(args.resources),
            object_store_memory=args.object_store_memory or None,
            detached=True)
        _save_head({"gcs_address": head.gcs_address,
                    "node_id": head.node_id,
                    "session": head.session_name})
        print(f"head started; GCS at {head.gcs_address}")
        print(f"connect with: ray_tpu_torch.init(address={head.gcs_address!r})")
        if args.dashboard:
            import ray_tpu_torch
            from ray_tpu_torch.dashboard import start_dashboard
            ray_tpu_torch.init(address=head.gcs_address)
            dash = start_dashboard(args.dashboard_port, args.dashboard_host)
            print(f"dashboard at "
                  f"{ray_tpu_torch.get(dash.url.remote(), timeout=30)}")
    else:
        addr = _load_address(args)
        node = node_mod.start_node(
            addr, num_cpus=args.num_cpus,
            resources=json.loads(args.resources),
            labels=json.loads(args.labels),
            object_store_memory=args.object_store_memory or None,
            detached=True)
        print(f"node {node.node_id[:12]} joined {addr}")


def stop_session(session: str, timeout: float = 10.0) -> int:
    """SIGTERM the runtime's processes of ``session`` (those whose
    command line names it), SIGKILL what is left after ``timeout``, and
    remove the session's arenas. Returns how many processes it
    signalled."""
    import glob
    import signal
    import subprocess

    def procs():
        out = subprocess.run(["ps", "-eo", "pid,args"], capture_output=True,
                             text=True).stdout
        found = []
        for line in out.splitlines():
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            pid, cmd = parts
            args = cmd.split()
            if any(m in cmd for m in ("ray_tpu_torch._private.gcs",
                                      "ray_tpu_torch._private.node_manager",
                                      "ray_tpu_torch._private.worker_main")) \
                    and (session in args
                         or f"/raytpu_torch_{session}_" in cmd):
                found.append(int(pid))
        return found

    first = procs()
    for pid in first:
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
    deadline = time.monotonic() + timeout
    left = first
    while left and time.monotonic() < deadline:
        time.sleep(0.2)
        left = procs()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    for path in glob.glob(f"/dev/shm/raytpu_torch_{session}_*"):
        try:
            os.unlink(path)
        except OSError:
            pass
    return len(first)


def cmd_stop(args):
    try:
        with open(head_file()) as f:
            session = json.load(f)["session"]
    except (OSError, KeyError, ValueError):
        print("no running cluster found (ray_tpu_torch start --head first)",
              file=sys.stderr)
        return
    print(f"stopped {stop_session(session)} processes")
    try:
        os.unlink(head_file())
    except OSError:
        pass


def _status_summary(ray_tpu_torch, state):
    summary = state.cluster_summary()
    # autoscaler view: aggregate queued lease demand per resource shape
    # (reference: `ray status` resource demand section)
    demand = {}
    for n in ray_tpu_torch.nodes():
        for d in n.get("pending_demand") or []:
            key = json.dumps(d, sort_keys=True)
            demand[key] = demand.get(key, 0) + 1
    summary["pending_demand"] = [
        {"shape": json.loads(k), "count": v} for k, v in demand.items()]
    return summary


def _fmt_metric(v):
    if v is None:
        return "-"
    if abs(v) >= 1e6:
        return f"{v:,.0f}"
    if abs(v) >= 100:
        return f"{v:.1f}"
    return f"{v:.3f}"


def _metrics_table(state, window: float, max_rows: int = 40) -> str:
    """One line per live metric: counters show rate, gauges latest+avg,
    histograms p50/p95 + observation rate — all windowed over the GCS
    time-series plane."""
    lines = [f"{'METRIC':<40} {'KIND':<10} {'WINDOW':>7}  VALUES"]
    for row in state.list_metric_series()[:max_rows]:
        name, kind = row["name"], row["kind"]
        try:
            if kind == "counter":
                rate = state.query_metrics(name, window, "rate")["value"]
                vals = f"rate/s={_fmt_metric(rate)}"
            elif kind == "histogram":
                p50 = state.query_metrics(name, window, "p50")["value"]
                p95 = state.query_metrics(name, window, "p95")["value"]
                rate = state.query_metrics(name, window, "rate")["value"]
                vals = (f"p50={_fmt_metric(p50)} p95={_fmt_metric(p95)} "
                        f"obs/s={_fmt_metric(rate)}")
            else:
                cur = state.query_metrics(name, window, "latest")["value"]
                avg = state.query_metrics(name, window, "avg")["value"]
                vals = f"latest={_fmt_metric(cur)} avg={_fmt_metric(avg)}"
        except Exception as e:
            vals = f"<query failed: {e}>"
        lines.append(f"{name:<40} {kind:<10} {window:>6.0f}s  {vals}")
    if len(lines) == 1:
        lines.append("  (no metrics pushed yet)")
    return "\n".join(lines)


# (metric, agg, label) rows of the --watch memory pane: arena occupancy
# + span/stripe stats + leak gauge + the data-plane counters
# (previously these reached only /metrics and get_node_info)
_MEMORY_PANE_ROWS = [
    ("store_bytes_in_use", "latest", "arena bytes in use"),
    ("store_capacity_bytes", "latest", "arena capacity"),
    ("store_objects", "latest", "live objects"),
    ("store_live_spans", "latest", "spanning objects"),
    ("store_span_bytes", "latest", "bytes in spans"),
    ("store_stripes_claimed", "latest", "stripes claimed by spans"),
    ("store_stripe_max_utilization", "latest", "fullest stripe fraction"),
    ("store_largest_hole_bytes", "latest", "largest free hole"),
    ("store_leaked_bytes", "latest", "leaked bytes (ledger sweep)"),
    ("store_leaked_objects", "latest", "leaked objects"),
    ("data_plane_bytes_in_total", "rate", "data-plane B/s in"),
    ("data_plane_bytes_out_total", "rate", "data-plane B/s out"),
    ("data_plane_chunks_in_total", "rate", "data-plane chunks/s in"),
    ("data_plane_chunks_out_total", "rate", "data-plane chunks/s out"),
    ("data_plane_active_conns", "latest", "data-plane connections"),
    ("data_plane_receiving", "latest", "receives in progress"),
]


def _memory_pane(state, window: float) -> str:
    """Memory/data-plane pane for `status --watch`: windowed values of
    the store + transfer gauges over the GCS time-series plane."""
    lines = [f"{'MEMORY / DATA PLANE':<40} {'AGG':<7} {'VALUE':>14}"]
    shown = 0
    for name, agg, label in _MEMORY_PANE_ROWS:
        try:
            v = state.query_metrics(name, window, agg)["value"]
        except Exception:
            v = None
        if v is None:
            continue
        shown += 1
        lines.append(f"{label:<40} {agg:<7} {_fmt_metric(v):>14}")
    if not shown:
        lines.append("  (no store metrics pushed yet)")
    return "\n".join(lines)


def _control_pane(state) -> str:
    """Control-plane pane for `status --watch`: GCS RPC p99 by the
    top-3 handlers, in-flight launches with their current phase, pubsub
    backlog, and black boxes on disk — straight from the GCS's live
    handler stats (control_plane_stats), not the windowed TS plane."""
    try:
        stats = state.control_plane_stats(top_n=3)
    except Exception as e:
        return f"CONTROL PLANE\n  (unavailable: {e})"
    lines = [f"{'CONTROL PLANE':<40} "
             f"rpc in-flight={stats.get('rpc_inflight', 0)}  "
             f"pubsub backlog={stats.get('pubsub', {}).get('backlog', 0)}  "
             f"black boxes={stats.get('blackboxes', 0)}"]
    for h in stats.get("handlers") or []:
        lines.append(
            f"  rpc {h['handler']:<28} p50={_fmt_metric(h['p50_ms'])}ms "
            f"p99={_fmt_metric(h['p99_ms'])}ms calls={h['calls']} "
            f"slow={h['slow']} err={h['errors']}")
    launches = stats.get("launches") or []
    for ln in launches[:5]:
        lines.append(
            f"  launch {ln.get('actor', '?'):<24} phase={ln['phase']} "
            f"({_fmt_metric(ln['phase_age_s'])}s) "
            f"total={_fmt_metric(ln['age_s'])}s retries={ln['retries']}")
    if not launches:
        recent = stats.get("recent_launch_ms") or []
        if recent:
            lines.append(
                f"  (no launches in flight; last "
                f"{len(recent)} took {_fmt_metric(min(recent))}-"
                f"{_fmt_metric(max(recent))}ms)")
        else:
            lines.append("  (no launches in flight)")
    return "\n".join(lines)


def cmd_status(args):
    import ray_tpu_torch
    from ray_tpu_torch.util import state
    ray_tpu_torch.init(address=_load_address(args))
    if not getattr(args, "watch", False):
        print(json.dumps(_status_summary(ray_tpu_torch, state), indent=2,
                         default=str))
        return
    # --watch: live terminal view over the time-series plane (reference:
    # `ray status` is point-in-time; the TS plane makes a refresh loop
    # show windowed rates/percentiles instead of instants)
    interval = max(0.5, float(getattr(args, "interval", 2.0)))
    window = float(getattr(args, "window", 30.0))
    try:
        while True:
            summary = _status_summary(ray_tpu_torch, state)
            table = _metrics_table(state, window)
            sys.stdout.write("\x1b[2J\x1b[H")   # clear + home
            print(f"ray_tpu_torch status --watch  (refresh {interval:.1f}s, "
                  f"window {window:.0f}s, ctrl-c to exit)\n")
            print(json.dumps(summary, default=str))
            print()
            print(_control_pane(state))
            print()
            print(_memory_pane(state, window))
            print()
            print(table)
            sys.stdout.flush()
            time.sleep(interval)
    except KeyboardInterrupt:
        pass


def cmd_up(args):
    from ray_tpu_torch.autoscaler import launcher
    # --block keeps this CLI alive as the cluster's supervisor; without
    # it the cluster must outlive the CLI (no PDEATHSIG)
    handle = launcher.up(args.config, detached=not args.block)
    _save_head({"gcs_address": handle.gcs_address,
                "node_id": handle.head.node_id,
                "session": handle.head.session_name})
    print(f"cluster {handle.config['cluster_name']} up; "
          f"GCS at {handle.gcs_address}")
    print(f"connect with: ray_tpu_torch.init(address={handle.gcs_address!r})")
    if args.block:
        import signal
        stop = False

        def _sig(*_):
            nonlocal stop
            stop = True
        signal.signal(signal.SIGINT, _sig)
        signal.signal(signal.SIGTERM, _sig)
        while not stop:
            time.sleep(1)
        handle.down()
        print("cluster down")


def cmd_down(args):
    from ray_tpu_torch.autoscaler import launcher
    session = launcher.down_from_state()
    if session is None:
        print("no launched cluster found", file=sys.stderr)
        return
    print(f"cluster down; stopped {stop_session(session)} more processes")
    try:
        with open(head_file()) as f:
            if json.load(f).get("session") == session:
                os.unlink(head_file())
    except (OSError, ValueError):
        pass


def cmd_list(args):
    import ray_tpu_torch
    from ray_tpu_torch.util import state
    ray_tpu_torch.init(address=_load_address(args))
    fn = {"nodes": state.list_nodes, "actors": state.list_actors,
          "tasks": state.list_tasks, "jobs": _jobs,
          "placement-groups": state.list_placement_groups}[args.kind]
    print(json.dumps(fn(), indent=2, default=str))


def _jobs():
    """The drivers the GCS knows, then the submitted jobs (their
    entrypoint, status and return code) when a job manager runs."""
    import ray_tpu_torch
    from ray_tpu_torch.job_submission import JOB_MANAGER_NAME
    from ray_tpu_torch.util import state
    rows = state.list_jobs()
    try:
        mgr = ray_tpu_torch.get_actor(JOB_MANAGER_NAME,
                                      namespace="_internal")
    except ValueError:
        return rows
    return rows + ray_tpu_torch.get(mgr.list.remote(), timeout=60)


def cmd_timeline(args):
    """Export the task timeline as a chrome://tracing JSON (reference:
    `ray timeline`)."""
    import ray_tpu_torch
    ray_tpu_torch.init(address=_load_address(args))
    out = args.output or "ray-tpu-timeline.json"
    ray_tpu_torch.timeline(out)
    print(f"wrote {out} (open in chrome://tracing or Perfetto)")


def cmd_blackbox(args):
    """Stitch surviving crash black boxes into one cross-node
    post-mortem timeline. Needs no live cluster — it reads the NDJSON
    boxes off disk, which is the point: the GCS/node that would answer
    RPCs is exactly what died."""
    from ray_tpu_torch._private import blackbox as bb
    paths = []
    for p in args.paths or []:
        if os.path.isdir(p):
            paths.extend(bb.scan_boxes(p))
        else:
            paths.append(p)
    if not args.paths:
        import glob

        from ray_tpu_torch._private.proc_util import runtime_dir
        for d in sorted(glob.glob(runtime_dir("*", "blackbox"))):
            paths.extend(bb.scan_boxes(d))
    if not paths:
        print("no black boxes found (pass a session blackbox dir or "
              "box files)", file=sys.stderr)
        sys.exit(1)
    merged = bb.stitch(paths, max_skew_s=args.max_skew)
    if args.json:
        print(json.dumps(merged, indent=2, default=str))
        return
    print(f"{len(merged['boxes'])} black boxes:")
    for b in merged["boxes"]:
        print(f"  {b['process']:<24} node={b['node_id'][:12] or '-':<12} "
              f"records={b['records']:<6} "
              f"offset={b['clock_offset_s']:+.3f}s  seal={b['seal_reason']}")
    print()
    rows = merged["records"]
    shown = rows[-args.limit:] if args.limit and len(rows) > args.limit \
        else rows
    if len(shown) < len(rows):
        print(f"(showing last {len(shown)} of {len(rows)} records)")
    for m in shown:
        rec = m["rec"]
        kind = rec.get("kind", "?")
        t = time.strftime("%H:%M:%S",
                          time.localtime(m["adj_ts"])) + \
            f".{int((m['adj_ts'] % 1) * 1000):03d}"
        if kind == "event":
            dur = ""
            if rec.get("start") and rec.get("end"):
                dur = f" {1e3 * (rec['end'] - rec['start']):.1f}ms"
            detail = f"{rec.get('name')}{dur}"
            attrs = rec.get("attrs") or {}
            if attrs:
                detail += " " + json.dumps(attrs, default=str)[:80]
        elif kind == "metrics":
            detail = f"snapshot ({len(rec.get('metrics') or [])} metrics)"
        elif kind == "seal":
            detail = f"SEALED: {rec.get('reason')}"
        elif kind == "marker":
            detail = " ".join(f"{k}={v}" for k, v in rec.items()
                              if k not in ("kind", "ts", "seq"))
        elif kind == "header":
            detail = (f"pid={rec.get('pid')}"
                      + (" (rotated)" if rec.get("rotated") else ""))
        else:
            detail = json.dumps(rec, default=str)[:100]
        print(f"{t} {m['process']:<24} {kind:<8} {detail}")


def _fmt_bytes(n) -> str:
    n = n or 0
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TB"


def _memory_sorted(rows, sort: str):
    """Deterministic ordering for the memory table. sort: size (desc),
    age (desc — oldest first is what a leak hunt wants), node."""
    if sort == "age":
        return sorted(rows, key=lambda r: -(r.get("age_s") or 0.0))
    if sort == "node":
        return sorted(rows, key=lambda r: (str(r.get("node_id") or "~"),
                                           -(r.get("size_bytes") or 0)))
    return sorted(rows, key=lambda r: -(r.get("size_bytes") or 0))


def _memory_grouped(rows, by: str):
    """Aggregate object rows by owner | node | kind: object count,
    total bytes, pinned count, leaked bytes per group."""
    groups = {}
    for r in rows:
        if by == "node":
            key = str(r.get("node_id") or "-")
        elif by == "owner":
            key = str(r.get("owner") or "-")
        else:
            key = str(r.get("kind") or "-")
        g = groups.setdefault(key, {"group": key, "objects": 0,
                                    "bytes": 0, "pinned": 0,
                                    "leaked_bytes": 0})
        g["objects"] += 1
        g["bytes"] += r.get("size_bytes") or 0
        if r.get("pins"):
            g["pinned"] += 1
        if r.get("leaked"):
            g["leaked_bytes"] += r.get("size_bytes") or 0
    return sorted(groups.values(), key=lambda g: -g["bytes"])


def _format_memory_rows(rows) -> str:
    lines = [f"{'OBJECT ID':<34} {'KIND':<10} {'SIZE':>10} {'PINS':>5} "
             f"{'AGE':>8} {'SPAN':>5} {'LEAK':>5}  OWNER / NODES"]
    for r in rows:
        age = r.get("age_s")
        owner = r.get("owner") or r.get("location") or "-"
        nodes = ",".join(n[:8] for n in r.get("locations") or ())
        if not nodes and r.get("node_id"):
            nodes = str(r["node_id"])[:8]
        lines.append(
            f"{r.get('object_id', '?'):<34} {r.get('kind', '?'):<10} "
            f"{_fmt_bytes(r.get('size_bytes')):>10} "
            f"{r.get('pins') if r.get('pins') is not None else '-':>5} "
            f"{f'{age:.0f}s' if age is not None else '-':>8} "
            f"{'yes' if r.get('is_span') else '-':>5} "
            f"{'LEAK' if r.get('leaked') else '-':>5}  "
            f"{str(owner)[:24]} @{nodes or '-'}")
    return "\n".join(lines)


def cmd_memory(args):
    """Cluster memory observability (reference: `ray memory` + the state
    observability object table): every live object with owner, size,
    placement (stripe/span), pin count, and age — local arena truth
    joined with GCS object-ledger provenance. `--leaked` shows only
    objects flagged by the leak detector; `--group-by owner|node|kind`
    aggregates; `--nodes` appends per-node occupancy/fragmentation."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state
    ray_tpu_torch.init(address=_load_address(args))
    rows = state.list_objects(limit=args.limit)
    if args.leaked:
        rows = [r for r in rows if r.get("leaked")]
    total = sum(r.get("size_bytes") or 0 for r in rows)
    leaked = sum(r.get("size_bytes") or 0 for r in rows if r.get("leaked"))
    if args.group_by:
        groups = _memory_grouped(rows, args.group_by)
        print(f"{'GROUP':<40} {'OBJECTS':>8} {'BYTES':>12} "
              f"{'PINNED':>7} {'LEAKED':>12}")
        for g in groups:
            print(f"{g['group'][:40]:<40} {g['objects']:>8} "
                  f"{_fmt_bytes(g['bytes']):>12} {g['pinned']:>7} "
                  f"{_fmt_bytes(g['leaked_bytes']):>12}")
    else:
        print(_format_memory_rows(_memory_sorted(rows, args.sort)))
    print(f"-- {len(rows)} objects, {_fmt_bytes(total)} total"
          + (f", {_fmt_bytes(leaked)} leaked" if leaked else ""))
    if getattr(args, "nodes", False):
        summary = state.memory_summary()
        for n in summary["nodes"]:
            st = n.get("store") or {}
            print(f"\nnode {n['node_id'][:12]}: "
                  f"{_fmt_bytes(st.get('bytes_in_use'))} / "
                  f"{_fmt_bytes(st.get('capacity'))} in use, "
                  f"{st.get('num_objects', '?')} objects, "
                  f"{st.get('num_spans', 0)} spans, "
                  f"{st.get('spilled_objects', 0)} spilled")
            for s in (st.get("fragmentation") or {}).get("stripes", []):
                print(f"  stripe {s['stripe']}: live "
                      f"{_fmt_bytes(s['live'])} / "
                      f"{_fmt_bytes(s['capacity'])}, free "
                      f"{_fmt_bytes(s['free'])}, largest hole "
                      f"{_fmt_bytes(s['largest_hole'])}, "
                      f"{s['objects']} objects")
        led = summary.get("ledger")
        if led:
            print(f"ledger: {led['entries']} rows, "
                  f"{led['leaked_objects']} leaked "
                  f"({_fmt_bytes(led['leaked_bytes'])})")


def cmd_submit(args):
    import ray_tpu_torch
    from ray_tpu_torch.job_submission import JobSubmissionClient
    ray_tpu_torch.init(address=_load_address(args))
    client = JobSubmissionClient()
    words = args.entrypoint[1:] if args.entrypoint[:1] == ["--"] \
        else args.entrypoint
    job_id = client.submit_job(entrypoint=" ".join(words))
    print(f"submitted {job_id}")
    if args.wait:
        status = client.wait_until_finished(job_id, timeout=args.timeout)
        print(client.get_job_logs(job_id))
        print(f"job {job_id}: {status}")
        sys.exit(0 if status == "SUCCEEDED" else 1)


def cmd_stack(args):
    """Live Python stacks of every cluster process (reference:
    `ray stack` — py-spy over local PIDs; here each daemon serves its
    own frames over RPC, so it works cluster-wide without ptrace)."""
    import ray_tpu_torch
    from ray_tpu_torch.util.tracing import cluster_stacks, format_cluster_stacks
    ray_tpu_torch.init(address=_load_address(args), ignore_reinit_error=True)
    text = format_cluster_stacks(cluster_stacks())
    if getattr(args, "output", None):
        with open(args.output, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.output}")
    else:
        print(text)


def cmd_export_traces(args):
    """Export spans as OTLP JSON (file and/or OTLP/HTTP collector)."""
    import ray_tpu_torch
    from ray_tpu_torch.util.tracing import export_otlp
    ray_tpu_torch.init(address=_load_address(args), ignore_reinit_error=True)
    payload = export_otlp(filename=args.output, endpoint=args.endpoint)
    n = sum(len(ss["spans"]) for rs in payload["resourceSpans"]
            for ss in rs["scopeSpans"])
    where = args.output or args.endpoint or "stdout"
    if not args.output and not args.endpoint:
        print(json.dumps(payload))
    print(f"exported {n} spans to {where}", file=sys.stderr)


def cmd_serve_deploy(args):
    """Deploy applications from a declarative YAML config (reference:
    python/ray/serve/scripts.py `serve deploy`)."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.schema import deploy_from_config
    ray_tpu_torch.init(address=_load_address(args), ignore_reinit_error=True)
    handles = deploy_from_config(args.config)
    print(f"deployed {len(handles)} application(s)")
    from ray_tpu_torch import serve
    print(json.dumps(serve.status(), indent=2))


def cmd_serve_status(args):
    import ray_tpu_torch
    from ray_tpu_torch import serve
    ray_tpu_torch.init(address=_load_address(args), ignore_reinit_error=True)
    out = {"applications": serve.status(), "proxies": serve.proxies()}
    try:
        slo = serve.slo_status()
        if any(slo.values()):
            out["slo"] = slo
    except Exception:
        pass
    print(json.dumps(out, indent=2, default=str))


def cmd_serve_fleet(args):
    """Fleet-plane view (serve/fleet.py): per-deployment scale-to-zero
    state, shell-pool occupancy, revival counts + cold-start
    percentiles, and configured tenant quotas."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    ray_tpu_torch.init(address=_load_address(args), ignore_reinit_error=True)
    out = serve.fleet_status()
    try:
        quotas = serve.get_tenant_quotas()
        if quotas:
            out["tenant_quotas"] = quotas
    except Exception:
        pass
    print(json.dumps(out, indent=2, default=str))


def cmd_serve_delete(args):
    import ray_tpu_torch
    from ray_tpu_torch import serve
    ray_tpu_torch.init(address=_load_address(args), ignore_reinit_error=True)
    if getattr(args, "all", False):
        serve.shutdown()
        print("serve shut down")
        return
    if not args.name:
        print("serve delete: provide an application name or --all",
              file=sys.stderr)
        sys.exit(2)
    serve.delete(args.name)
    print(f"deleted application {args.name!r}")


def cmd_serve_shutdown(args):
    import ray_tpu_torch
    from ray_tpu_torch import serve
    ray_tpu_torch.init(address=_load_address(args), ignore_reinit_error=True)
    serve.shutdown()
    print("serve shut down")


def cmd_lint(args):
    """The JAX package's runtime-aware linter (rtlint) is not ported."""
    raise NotImplementedError(
        "lint runs the JAX package's rtlint (devtools/lint/), which is not "
        "ported (ROADMAP.md, Queue A, its last item)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("start")
    ps.add_argument("--head", action="store_true")
    ps.add_argument("--address", default=None)
    ps.add_argument("--num-cpus", type=float, default=None)
    ps.add_argument("--resources", default="{}")
    ps.add_argument("--labels", default="{}",
                    help="node labels JSON (e.g. the autoscaler's "
                         "ray-tpu-provider-id)")
    ps.add_argument("--object-store-memory", type=int, default=0)
    ps.add_argument("--dashboard", action="store_true")
    ps.add_argument("--dashboard-port", type=int, default=8265,
                    help="0 takes a free port")
    ps.add_argument("--dashboard-host", default="127.0.0.1",
                    help="the interface the dashboard binds (it runs the "
                         "jobs it is sent)")
    ps.set_defaults(fn=cmd_start)

    pstop = sub.add_parser("stop")
    pstop.set_defaults(fn=cmd_stop)

    pu = sub.add_parser("up", help="bring up a cluster from a YAML spec")
    pu.add_argument("config")
    pu.add_argument("--block", action="store_true",
                    help="stay attached; ctrl-c tears the cluster down")
    pu.set_defaults(fn=cmd_up)

    pd = sub.add_parser("down", help="tear down the launched cluster")
    pd.set_defaults(fn=cmd_down)

    pst = sub.add_parser("status")
    pst.add_argument("--address", default=None)
    pst.add_argument("--watch", "-w", action="store_true",
                     help="live view: refresh cluster summary + windowed "
                          "metrics (rates / p50 / p95) until ctrl-c")
    pst.add_argument("--interval", type=float, default=2.0,
                     help="--watch refresh cadence in seconds")
    pst.add_argument("--window", type=float, default=30.0,
                     help="--watch metric aggregation window in seconds")
    pst.set_defaults(fn=cmd_status)

    pl = sub.add_parser("list")
    pl.add_argument("kind", choices=["nodes", "actors", "tasks", "jobs",
                                     "placement-groups"])
    pl.add_argument("--address", default=None)
    pl.set_defaults(fn=cmd_list)

    pt = sub.add_parser("timeline")
    pt.add_argument("--address", default=None)
    pt.add_argument("--output", "-o", default=None)
    pt.set_defaults(fn=cmd_timeline)

    pbb = sub.add_parser(
        "blackbox", help="stitch crash black boxes into one cross-node "
        "post-mortem timeline (reads NDJSON off disk; no cluster needed)")
    pbb.add_argument("paths", nargs="*",
                     help="box files or session blackbox dirs; default "
                          "scans every session's blackbox dir under "
                          "the runtime directory")
    pbb.add_argument("--json", action="store_true",
                     help="emit the merged timeline as JSON")
    pbb.add_argument("--limit", type=int, default=200,
                     help="max records to print (newest kept; 0 = all)")
    pbb.add_argument("--max-skew", type=float, default=0.0,
                     help="clamp clock offsets larger than this many "
                          "seconds to 0 (implausible-skew guard)")
    pbb.set_defaults(fn=cmd_blackbox)

    pm = sub.add_parser(
        "memory", help="cluster object/memory observability "
        "(arena truth joined with object-ledger provenance)")
    pm.add_argument("--address", default=None)
    pm.add_argument("--sort", choices=["size", "age", "node"],
                    default="size",
                    help="row ordering (size desc, age desc, node)")
    pm.add_argument("--group-by", dest="group_by",
                    choices=["owner", "node", "kind"], default=None,
                    help="aggregate instead of listing per object")
    pm.add_argument("--leaked", action="store_true",
                    help="only objects flagged by the leak detector")
    pm.add_argument("--limit", type=int, default=1000)
    pm.add_argument("--nodes", action="store_true",
                    help="append per-node occupancy + per-stripe "
                         "fragmentation (live/free/largest hole)")
    pm.set_defaults(fn=cmd_memory)

    pj = sub.add_parser("submit")
    pj.add_argument("--address", default=None)
    pj.add_argument("--wait", action="store_true")
    pj.add_argument("--timeout", type=float, default=600)
    pj.add_argument("entrypoint", nargs=argparse.REMAINDER)
    pj.set_defaults(fn=cmd_submit)

    pstack = sub.add_parser("stack",
                            help="dump live Python stacks cluster-wide")
    pstack.add_argument("--address", default=None)
    pstack.add_argument("--output", "-o", default=None,
                        help="write the dump to a file instead of stdout")
    pstack.set_defaults(fn=cmd_stack)

    ptr = sub.add_parser("export-traces",
                         help="export spans as OTLP JSON")
    ptr.add_argument("--address", default=None)
    ptr.add_argument("--output", "-o", default=None)
    ptr.add_argument("--endpoint", default=None,
                     help="OTLP/HTTP collector base URL")
    ptr.set_defaults(fn=cmd_export_traces)

    psrv = sub.add_parser("serve", help="serve control plane")
    srv_sub = psrv.add_subparsers(dest="serve_cmd", required=True)
    sd = srv_sub.add_parser("deploy",
                            help="deploy apps from a YAML config")
    sd.add_argument("config")
    sd.add_argument("--address", default=None)
    sd.set_defaults(fn=cmd_serve_deploy)
    ss = srv_sub.add_parser("status")
    ss.add_argument("--address", default=None)
    ss.set_defaults(fn=cmd_serve_status)
    sf = srv_sub.add_parser(
        "fleet", help="fleet plane: scale-to-zero state, shell pool, "
                      "cold-start percentiles, tenant quotas")
    sf.add_argument("--address", default=None)
    sf.set_defaults(fn=cmd_serve_fleet)
    sdel = srv_sub.add_parser("delete")
    sdel.add_argument("name", nargs="?", default=None)
    sdel.add_argument("--all", action="store_true",
                      help="delete every application (serve shutdown)")
    sdel.add_argument("--address", default=None)
    sdel.set_defaults(fn=cmd_serve_delete)
    ssh = srv_sub.add_parser("shutdown")
    ssh.add_argument("--address", default=None)
    ssh.set_defaults(fn=cmd_serve_shutdown)

    plint = sub.add_parser(
        "lint", help="the JAX package's rtlint (not ported)")
    plint.add_argument("paths", nargs="*")
    plint.set_defaults(fn=cmd_lint)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
