"""HTTP ingress proxy actor, one per node (reference:
python/ray/serve/_private/proxy.py HTTPProxy :779 — uvicorn/ASGI there;
aiohttp here, same role: terminate HTTP, route by prefix, forward to the
ingress deployment handle). Routing state arrives by long-poll push from
the controller (reference: LongPollClient, _private/long_poll.py:64), so
a config change is visible here within one notify, not a poll interval.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Dict, Optional


class HttpProxy:
    def __init__(self, port: int, controller):
        self.port = port
        self.controller = controller
        self.routes: Dict[str, str] = {}      # route_prefix -> app_name
        self.ingress: Dict[str, str] = {}     # app_name -> deployment
        self._versions = {"routes": 0}
        self._handles = {}
        self._adm = None                       # lazy TenantAdmission
        self._lease = None                     # lazy QuotaLeaseClient
        self._ttft_hist = None                 # lazy per-tenant TTFT
        self._addr: Optional[str] = None
        from ray_tpu_torch._private.worker import global_worker
        asyncio.run_coroutine_threadsafe(
            self._start(), global_worker.core.loop).result(timeout=30)
        self._prime_routes()
        self._poller = threading.Thread(target=self._longpoll_loop,
                                        daemon=True)
        self._poller.start()

    def _prime_routes(self):
        from ray_tpu_torch.serve.long_poll import prime_snapshot
        prime_snapshot(self.controller, self._versions, self._on_update)

    async def _start(self):
        from aiohttp import web

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        runner = web.AppRunner(app)
        await runner.setup()
        try:
            site = web.TCPSite(runner, "0.0.0.0", self.port)
            await site.start()
        except OSError:
            # port taken (several proxies share a host in tests / when
            # multiple nodes run on one machine): fall back to ephemeral
            site = web.TCPSite(runner, "0.0.0.0", 0)
            await site.start()
        # the port actually bound: port 0 asks the kernel for one
        bound = site._server.sockets[0].getsockname()[1]
        from ray_tpu_torch._private.rpc import node_ip_address
        self._addr = f"{node_ip_address()}:{bound}"

    def _longpoll_loop(self):
        from ray_tpu_torch.serve.long_poll import run_longpoll_loop
        run_longpoll_loop(lambda: self.controller, self._versions,
                          self._on_update)

    def _on_update(self, key: str, data):
        if key != "routes":
            return
        self.routes = data["routes"]
        new_ingress = data["ingress"]
        # drop cached handles whose app's ingress deployment changed —
        # a stale handle would keep routing to the old deployment
        for app, dep in list(self._handles.items()):
            if new_ingress.get(app) != dep.deployment_name:
                self._handles.pop(app, None)
        self.ingress = new_ingress

    def ready(self) -> str:
        return self._addr

    def admission_stats(self) -> Dict:
        """Admission + lease state for probes/tests (reports/edge_probe
        asserts zero over-admission across proxies from these)."""
        out = {"admission": None, "lease": None}
        if self._adm is not None:
            out["admission"] = self._adm.stats()
        if self._lease is not None:
            out["lease"] = self._lease.stats()
        return out

    def _handle_for(self, app_name: str):
        h = self._handles.get(app_name)
        if h is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle
            h = DeploymentHandle(self.ingress[app_name], app_name)
            self._handles[app_name] = h
        return h

    # ------------------------------------------------- tenant admission
    def _admission(self):
        if self._adm is None:
            from ray_tpu_torch.serve.fleet import TenantAdmission
            self._adm = TenantAdmission()
            lease = self._lease_client()
            if lease is not None:
                self._adm.retry_hint = lease.retry_hint
        return self._adm

    def _lease_client(self):
        """Lazy QuotaLeaseClient (serve/fleet.py): this proxy's share of
        every tenant's CLUSTER admission rate, leased from the GCS so N
        proxies enforce one fair-share policy. None when the worker is
        not connected (hermetic tests drive TenantAdmission directly)."""
        if self._lease is None:
            try:
                import ray_tpu_torch
                from ray_tpu_torch.serve.fleet import QuotaLeaseClient
                w = ray_tpu_torch._get_worker()
                ctx = ray_tpu_torch.get_runtime_context()
                pid = str(ctx.get("actor_id") or f"proxy:{id(self):x}")
                self._lease = QuotaLeaseClient(
                    pid, w.gcs_call,
                    on_quotas=lambda rows: self._adm.apply_quotas(rows)
                    if self._adm is not None else None)
                self._lease.acquire()
            except Exception:
                return None
        return self._lease

    @staticmethod
    def _fetch_quotas():
        import ray_tpu_torch
        return ray_tpu_torch._get_worker().gcs_call("get_tenant_quotas")

    @staticmethod
    def _tenant_of(request, payload) -> str:
        """X-RayTPU-Tenant header, falling back to a `tenant` field in a
        JSON payload (forwarded untouched either way)."""
        t = request.headers.get("X-RayTPU-Tenant", "")
        if not t and isinstance(payload, dict):
            t = str(payload.get("tenant") or "")
        return t

    def _acquire_tenant(self, tenant: str):
        """Blocking fair-share admission (serve/fleet.py): runs on an
        executor thread, never this event loop. Raises
        TenantQuotaExceeded for over-quota work — mapped to 429 +
        Retry-After by the caller. Two gates in order: this proxy's
        leased share of the tenant's CLUSTER rate (token bucket, the
        cheap check), then the local concurrency quota + DRR queue."""
        adm = self._admission()
        lease = self._lease_client()
        if lease is not None and tenant:
            wait = lease.admit(tenant)
            if wait is not None:
                from ray_tpu_torch.serve.fleet import TenantQuotaExceeded
                adm.shed_total[tenant] += 1
                raise TenantQuotaExceeded(tenant, wait)
        adm.maybe_refresh(self._fetch_quotas)
        return adm.acquire(tenant)

    @staticmethod
    def _shed_response(e):
        from aiohttp import web
        # sub-second precision: the refill-deficit hint loses its
        # de-herding value if every response rounds up to the same
        # integer second
        retry = max(0.05, float(e.retry_after_s))
        return web.Response(
            status=429,
            text=f"tenant {e.tenant!r} over quota",
            headers={"Retry-After": f"{retry:.3f}"})

    def _record_ttft(self, tenant: str, dt_s: float):
        """Per-tenant time-to-first-byte as THIS tenant experienced it
        at the ingress (queueing + routing + prefill included) — the
        observation series the per-tenant SLO burn rows (serve/slo.py
        evaluate_tenant_slo) are evaluated against."""
        try:
            if self._ttft_hist is None:
                from ray_tpu_torch.util.metrics import Histogram
                self._ttft_hist = Histogram(
                    "serve_tenant_ttft_ms",
                    "ingress-observed time to first byte per tenant",
                    boundaries=[1.0, 5.0, 25.0, 100.0, 500.0, 2000.0],
                    tag_keys=("tenant",))
            self._ttft_hist.observe(dt_s * 1000.0,
                                    tags={"tenant": tenant or "default"})
        except Exception:
            pass

    @staticmethod
    def _incoming_trace(request):
        """W3C traceparent (`00-<trace32>-<span16>-<flags>`): an
        upstream client's trace continues through the proxy instead of
        rooting a fresh one."""
        parts = request.headers.get("traceparent", "").split("-")
        if len(parts) == 4 and len(parts[1]) == 32 and len(parts[2]) == 16:
            return parts[1], parts[2]
        return None, None

    async def _handle(self, request):
        from aiohttp import web

        from ray_tpu_torch._private import events

        path = "/" + request.match_info["tail"]
        app_name = None
        for prefix, name in sorted(self.routes.items(),
                                   key=lambda kv: -len(kv[0])):
            if path.startswith(prefix):
                app_name = name
                break
        if app_name is None:
            return web.Response(status=404, text="no route")
        if request.content_type == "application/json":
            try:
                payload = await request.json()
            except json.JSONDecodeError:
                payload = await request.text()
        else:
            payload = await request.text()
        handle = self._handle_for(app_name)
        # session affinity: an explicit header (or a session_id field in
        # a JSON payload) pins this request's routing to the replica the
        # session hashes to — repeat prompts land where their prefix KV
        # is cached (the payload is forwarded untouched)
        session_id = request.headers.get("X-RayTPU-Session", "")
        if not session_id and isinstance(payload, dict):
            session_id = str(payload.get("session_id") or "")
        if session_id:
            handle = handle.options(session_id=session_id)
        # per-tenant fair-share admission (serve/fleet.py): DRR queueing
        # under concurrency quotas, over-quota work shed with 429 +
        # Retry-After BEFORE it can collapse the replica queues. The
        # blocking acquire runs on an executor thread.
        loop = asyncio.get_event_loop()
        tenant = self._tenant_of(request, payload)
        from ray_tpu_torch.serve.fleet import TenantQuotaExceeded
        try:
            lease = await loop.run_in_executor(
                None, self._acquire_tenant, tenant)
        except TenantQuotaExceeded as e:
            return self._shed_response(e)
        if tenant:
            handle = handle.options(tenant=tenant)
        # the request's root span: every downstream phase (replica task,
        # engine slot, first token) parents under it because the handle
        # call below submits inside its trace context
        trace_id, parent = self._incoming_trace(request)
        span = events.start_span("proxy.request", category="serve",
                                 trace_id=trace_id, parent_span_id=parent,
                                 method=request.method, path=path,
                                 app=app_name, tenant=tenant or None)
        t0 = time.monotonic()
        if (request.headers.get("X-RayTPU-Stream") == "1"
                or "text/event-stream" in request.headers.get("Accept", "")):
            try:
                return await self._handle_streaming(request, handle,
                                                    payload, span,
                                                    tenant=tenant, t0=t0)
            finally:
                lease.release()

        def _call():
            # routing + submit use the sync API; keep them off this loop.
            # trace_context makes the replica task a child of this span.
            with events.trace_context(span.trace_id, span.span_id):
                return handle.remote(payload).result(timeout=60)

        try:
            result = await loop.run_in_executor(None, _call)
        except Exception as e:
            span.end(status=500, error=type(e).__name__)
            return web.Response(status=500, text=f"{type(e).__name__}: {e}")
        finally:
            lease.release()
        self._record_ttft(tenant, time.monotonic() - t0)
        span.end(status=200)
        if isinstance(result, (dict, list)):
            return web.json_response(result)
        return web.Response(text=str(result))

    async def _handle_streaming(self, request, handle, payload, span,
                                tenant: str = "",
                                t0: Optional[float] = None):
        """Streaming ingress: drive the deployment's streaming handle on
        an executor thread and relay each chunk as one NDJSON line. A
        client that disconnects mid-stream closes the replica-side
        generator (its finally runs — engine slots free immediately)."""
        import threading

        from aiohttp import web

        from ray_tpu_torch._private import events

        loop = asyncio.get_event_loop()
        q: asyncio.Queue = asyncio.Queue()
        cancelled = threading.Event()

        def _produce():
            gen = None
            try:
                with events.trace_context(span.trace_id, span.span_id):
                    gen = handle.options(stream=True).remote(payload)
                n = 0
                # frame-granular drain: next_batch() hands back every
                # item already buffered from one coalesced wire frame,
                # so the writer emits a frame's NDJSON lines in ONE
                # write instead of a syscall per token
                while True:
                    try:
                        batch = gen.next_batch()
                    except StopIteration:
                        break
                    if cancelled.is_set():
                        gen.close()
                        loop.call_soon_threadsafe(q.put_nowait,
                                                  ("end", n))
                        return
                    loop.call_soon_threadsafe(q.put_nowait,
                                              ("batch", batch))
                    n += len(batch)
                loop.call_soon_threadsafe(q.put_nowait, ("end", n))
            except Exception as e:
                if gen is not None:
                    try:
                        gen.close()
                    except Exception:
                        pass
                loop.call_soon_threadsafe(q.put_nowait, ("error", e))

        resp = web.StreamResponse()
        resp.content_type = "application/x-ndjson"
        await resp.prepare(request)
        producer = loop.run_in_executor(None, _produce)
        try:
            first = True
            while True:
                kind, item = await q.get()
                if kind == "batch":
                    if first and t0 is not None:
                        self._record_ttft(tenant, time.monotonic() - t0)
                        first = False
                    # one write per coalesced frame, one NDJSON line per
                    # item — the client-visible protocol is unchanged
                    await resp.write("".join(
                        json.dumps(v, default=str) + "\n"
                        for v in item).encode())
                elif kind == "error":
                    span.end(status=500, error=type(item).__name__)
                    await resp.write(
                        (json.dumps({"error": f"{type(item).__name__}: "
                                              f"{item}"}) + "\n").encode())
                    break
                else:
                    span.end(status=200, chunks=item)
                    break
        except (ConnectionResetError, ConnectionError):
            cancelled.set()
            span.end(status=499, error="client_disconnected")
        finally:
            cancelled.set()
            await producer
        try:
            await resp.write_eof()
        except (ConnectionResetError, ConnectionError):
            pass
        return resp
