"""Dashboard: REST API over cluster state + jobs (reference:
python/ray/dashboard/head.py — aiohttp REST; the web UI is not replicated,
the API surface is). Runs as an actor on the cluster.

Counterpart of ``ray_tpu/dashboard.py``. ``POST /api/jobs`` runs the
shell entrypoint it is sent, so the server binds 127.0.0.1 unless
``host=`` names another interface; ``port=0`` takes a free port, which
``url()`` reports."""

from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional

DASHBOARD_NAME = "_DASHBOARD"


class DashboardServer:
    def __init__(self, port: int = 8265, host: str = "127.0.0.1"):
        self.port = port
        self.host = host
        self._ready = False
        from ray_tpu_torch._private.worker import global_worker
        asyncio.run_coroutine_threadsafe(
            self._start(), global_worker.core.loop).result(timeout=30)

    async def _start(self):
        from aiohttp import web

        app = web.Application()
        r = app.router
        r.add_get("/api/cluster_status", self._cluster_status)
        r.add_get("/api/nodes", self._nodes)
        r.add_get("/api/actors", self._actors)
        r.add_get("/api/tasks", self._tasks)
        r.add_get("/api/timeline", self._timeline)
        r.add_get("/api/memory", self._memory)
        r.add_get("/api/fleet", self._fleet)
        r.add_get("/api/runtime_events", self._runtime_events)
        r.add_get("/api/placement_groups", self._pgs)
        r.add_get("/api/jobs", self._jobs)
        r.add_post("/api/jobs", self._submit_job)
        r.add_get("/api/jobs/{job_id}", self._job_status)
        r.add_get("/api/jobs/{job_id}/logs", self._job_logs)
        r.add_post("/api/jobs/{job_id}/stop", self._job_stop)
        r.add_get("/api/version", self._version)
        r.add_get("/api/metrics/query", self._metrics_query)
        r.add_get("/api/metrics/series", self._metrics_series)
        r.add_get("/metrics", self._metrics)
        r.add_get("/healthz", self._healthz)
        r.add_get("/", self._index)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, self.host, self.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        self._ready = True

    async def _index(self, request):
        """Single-page UI over the JSON API (reference: the dashboard
        frontend, python/ray/dashboard/ — a full React app there; a
        dependency-free live table view here)."""
        from aiohttp import web
        return web.Response(text=_INDEX_HTML, content_type="text/html")

    def ready(self):
        return self._ready

    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def _in_thread(self, fn, *args):
        return await asyncio.get_event_loop().run_in_executor(
            None, fn, *args)

    async def _healthz(self, request):
        from aiohttp import web
        return web.Response(text="ok")

    async def _metrics(self, request):
        """Prometheus scrape endpoint aggregating every process's pushed
        metrics (reference: prometheus_exporter.py on the metrics agent)."""
        from aiohttp import web

        from ray_tpu_torch.util.metrics import render_prometheus

        def fetch():
            import ray_tpu_torch
            return ray_tpu_torch._get_worker().gcs_call("get_metrics")
        all_metrics = await self._in_thread(fetch)
        return web.Response(text=render_prometheus(all_metrics),
                            content_type="text/plain")

    async def _metrics_query(self, request):
        """Windowed time-series query: ?name=serve_llm_ttft_ms&window=30
        &agg=p95[&threshold=...][&tags={"k":"v"}] — the HTTP face of the
        GCS query_metrics call (util/state.query_metrics)."""
        from aiohttp import web
        from ray_tpu_torch.util import state
        name = request.query.get("name")
        if not name:
            return web.json_response({"error": "name is required"},
                                     status=400)
        try:
            window = float(request.query.get("window", 60.0))
            agg = request.query.get("agg", "avg")
            threshold = request.query.get("threshold")
            threshold = float(threshold) if threshold is not None else None
            tags = request.query.get("tags")
            tags = json.loads(tags) if tags else None
        except (ValueError, json.JSONDecodeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        out = await self._in_thread(
            lambda: state.query_metrics(name, window=window, agg=agg,
                                        tags=tags, threshold=threshold))
        return web.json_response(out)

    async def _metrics_series(self, request):
        from aiohttp import web
        from ray_tpu_torch.util import state
        return web.json_response(
            await self._in_thread(state.list_metric_series))

    async def _version(self, request):
        from aiohttp import web
        import ray_tpu_torch
        return web.json_response({"version": ray_tpu_torch.__version__})

    async def _cluster_status(self, request):
        from aiohttp import web
        from ray_tpu_torch.util import state
        return web.json_response(
            await self._in_thread(state.cluster_summary))

    async def _nodes(self, request):
        from aiohttp import web
        from ray_tpu_torch.util import state
        return web.json_response(await self._in_thread(state.list_nodes))

    async def _actors(self, request):
        from aiohttp import web
        from ray_tpu_torch.util import state
        return web.json_response(await self._in_thread(state.list_actors))

    async def _tasks(self, request):
        from aiohttp import web
        from ray_tpu_torch.util import state
        return web.json_response(await self._in_thread(state.list_tasks))

    async def _timeline(self, request):
        """Unified chrome-trace timeline (tasks + flight-recorder
        runtime events as per-subsystem tracks): save the body to a
        file and open it in chrome://tracing or Perfetto."""
        from aiohttp import web

        def fetch():
            import ray_tpu_torch
            return ray_tpu_torch.timeline()
        return web.json_response(await self._in_thread(fetch))

    async def _memory(self, request):
        """Cluster memory observability: object rows (arena truth joined
        with object-ledger provenance — owner, size, stripe/span
        placement, pins, age, leak flag) plus per-node occupancy/
        fragmentation and ledger totals. ?limit=N bounds the object
        list; ?leaked=1 restricts it to leak-detector hits."""
        from aiohttp import web
        from ray_tpu_torch.util import state
        try:
            limit = int(request.query.get("limit", 1000))
        except ValueError:
            return web.json_response({"error": "bad limit"}, status=400)
        leaked_only = request.query.get("leaked") in ("1", "true", "yes")

        def fetch():
            rows = state.list_objects(limit=limit)
            if leaked_only:
                rows = [r for r in rows if r.get("leaked")]
            return {"objects": rows, "summary": state.memory_summary()}
        return web.json_response(await self._in_thread(fetch))

    async def _fleet(self, request):
        """Fleet-plane view (serve/fleet.py): scale-to-zero state per
        deployment, shell-pool occupancy, cold-start percentiles, and
        configured tenant quotas. 404s when serve isn't running."""
        from aiohttp import web

        def fetch():
            import ray_tpu_torch
            from ray_tpu_torch import serve
            # probe, don't create: fleet_status() via _get_controller
            # would START a serve controller on a serve-less cluster
            ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
            out = serve.fleet_status()
            try:
                quotas = serve.get_tenant_quotas()
                if quotas:
                    out["tenant_quotas"] = quotas
            except Exception:
                pass
            return out
        try:
            return web.json_response(await self._in_thread(fetch))
        except Exception as e:
            return web.json_response(
                {"error": f"{type(e).__name__}: {e}"}, status=404)

    async def _runtime_events(self, request):
        """Raw flight-recorder rows; ?category=engine|store|data|serve
        filters by subsystem."""
        from aiohttp import web
        from ray_tpu_torch.util import state
        category = request.query.get("category") or None
        rows = await self._in_thread(
            lambda: state.list_runtime_events(category=category))
        return web.json_response(rows)

    async def _pgs(self, request):
        from aiohttp import web
        from ray_tpu_torch.util import state
        return web.json_response(
            await self._in_thread(state.list_placement_groups))

    def _client(self):
        from ray_tpu_torch.job_submission import JobSubmissionClient
        return JobSubmissionClient()

    async def _jobs(self, request):
        from aiohttp import web
        return web.json_response(
            await self._in_thread(lambda: self._client().list_jobs()))

    async def _submit_job(self, request):
        from aiohttp import web
        body = await request.json()
        job_id = await self._in_thread(
            lambda: self._client().submit_job(
                entrypoint=body["entrypoint"],
                runtime_env=body.get("runtime_env"),
                metadata=body.get("metadata")))
        return web.json_response({"job_id": job_id})

    async def _job_status(self, request):
        from aiohttp import web
        job_id = request.match_info["job_id"]
        info = await self._in_thread(
            lambda: self._client().get_job_info(job_id))
        if info is None:
            return web.Response(status=404)
        return web.json_response(info)

    async def _job_logs(self, request):
        from aiohttp import web
        job_id = request.match_info["job_id"]
        logs = await self._in_thread(
            lambda: self._client().get_job_logs(job_id))
        return web.json_response({"logs": logs})

    async def _job_stop(self, request):
        from aiohttp import web
        job_id = request.match_info["job_id"]
        ok = await self._in_thread(
            lambda: self._client().stop_job(job_id))
        return web.json_response({"stopped": ok})


def start_dashboard(port: int = 8265, host: str = "127.0.0.1"):
    """Start (or find) the dashboard actor; returns its handle (its
    ``url`` method says where it listens)."""
    import ray_tpu_torch
    try:
        return ray_tpu_torch.get_actor(DASHBOARD_NAME, namespace="_internal")
    except ValueError:
        cls = ray_tpu_torch.remote(DashboardServer)
        h = cls.options(name=DASHBOARD_NAME, namespace="_internal",
                        lifetime="detached", max_concurrency=16,
                        num_cpus=0.1).remote(port, host)
        ray_tpu_torch.get(h.ready.remote(), timeout=60)
        return h


_INDEX_HTML = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title><style>
body{font-family:system-ui,sans-serif;margin:1.5rem;background:#fafafa}
h1{font-size:1.2rem} h2{font-size:1rem;margin:1.2rem 0 .4rem}
table{border-collapse:collapse;width:100%;background:#fff;font-size:.85rem}
th,td{border:1px solid #ddd;padding:.3rem .5rem;text-align:left}
th{background:#f0f0f0} .ALIVE{color:#0a7d34} .DEAD,.FAILED{color:#c0322f}
#err{color:#c0322f}
</style></head><body>
<h1>ray_tpu_torch dashboard</h1><div id="err"></div>
<h2>Cluster</h2><div id="cluster"></div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Jobs</h2><table id="jobs"></table>
<h2>Recent tasks</h2><table id="tasks"></table>
<script>
function esc(s){return s.replace(/[&<>"']/g,
 m=>({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[m]))}
function cell(v){if(v===null||v===undefined)return"";
 if(typeof v==="object")return JSON.stringify(v);return String(v)}
function render(id, rows, cols){const t=document.getElementById(id);
 if(!rows||!rows.length){t.innerHTML="<tr><td>none</td></tr>";return}
 cols=cols||Object.keys(rows[0]);
 t.innerHTML="<tr>"+cols.map(c=>"<th>"+esc(c)+"</th>").join("")+"</tr>"+
  rows.map(r=>"<tr>"+cols.map(c=>{const v=cell(r[c]);
   let cls="";
   if(c==="state"||c==="status"){cls=" class='"+esc(v).replace(/[^A-Za-z]/g,"")+"'"}
   if(c==="alive"){cls=v==="true"?" class='ALIVE'":" class='DEAD'"}
   return "<td"+cls+">"+esc(v)+"</td>"}).join("")+"</tr>").join("")}
async function refresh(){try{
 const [cl,no,ac,jo,ta]=await Promise.all(
  ["cluster_status","nodes","actors","jobs","tasks"].map(
   p=>fetch("/api/"+p).then(r=>r.json())));
 document.getElementById("cluster").textContent=JSON.stringify(cl);
 render("nodes",no,["node_id","alive","node_ip","total","available"]);
 render("actors",ac,["actor_id","state","name","node_id","num_restarts"]);
 render("jobs",jo);
 render("tasks",(ta||[]).slice(0,50),
        ["task_id","name","state","type","node_id"]);
 document.getElementById("err").textContent="";
}catch(e){document.getElementById("err").textContent="refresh failed: "+e}}
refresh();setInterval(refresh,2000);
</script></body></html>"""
