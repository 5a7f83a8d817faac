"""Remote client sessions ("Ray Client" equivalent).

The reference runs a gRPC proxy on the head node that muxes remote
interactive drivers into the cluster (reference: python/ray/util/client/ —
server/proxier.py per-job servers, client worker.py, `ray://` addresses;
client_mode_hook wraps the public API). Here the proxy is an asyncio RPC
server (same msgpack transport as the rest of the control plane) hosting
one real in-cluster driver; each connected client gets a session that
ships pickled functions/classes once, submits tasks/actor calls by id,
and fetches results by object id. `ray_tpu_torch.init("ray://host:port")`
(or `ray_tpu_torch.client.connect("host:port")`) flips the public API
into client mode: the process holds no runtime of its own.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import cloudpickle

_client: Optional["ClientContext"] = None


def current_client() -> Optional["ClientContext"]:
    return _client


# --------------------------------------------------------------- server side
class ClientProxyServer:
    """Runs inside (or next to) the cluster head: a driver that executes
    API calls on behalf of remote clients."""

    def __init__(self, gcs_address: Optional[str] = None, port: int = 0,
                 host: str = "127.0.0.1"):
        self.gcs_address = gcs_address
        self.port = port
        # The proxy unpickles and runs what its clients send, so it binds
        # loopback unless the deployment names another interface.
        self.host = host
        self.address: Optional[str] = None
        # Per-CONNECTION sessions (reference: proxier.py runs one server
        # per job; here sessions share the proxy driver process but each
        # client gets its OWN function table / ref table / actor table,
        # and disconnect frees the session's refs and kills its
        # non-detached actors — one client's leaks cannot pin another's
        # objects or grow its tables).
        self._sessions: Dict[int, Dict[str, Dict]] = {}
        self._lock = threading.Lock()
        self._next = 0

    def _session(self, conn) -> Dict[str, Dict]:
        key = conn.peer_info.setdefault("client_session", id(conn))
        st = self._sessions.get(key)
        if st is None:
            st = self._sessions[key] = {"funcs": {}, "objects": {},
                                        "actors": {}}
        return st

    def _on_disconnect(self, conn):
        key = conn.peer_info.get("client_session")
        st = self._sessions.pop(key, None) if key is not None else None
        if not st:
            return
        st["objects"].clear()     # drop the session's ref pins
        detached = st.get("detached") or set()
        victims = [h for aid, h in st["actors"].items()
                   if aid not in detached]
        if victims:
            import asyncio

            import ray_tpu_torch

            def _reap(handles):
                for h in handles:
                    try:
                        ray_tpu_torch.kill(h)
                    except Exception:
                        pass
            asyncio.get_event_loop().run_in_executor(None, _reap, victims)

    def _new_id(self) -> bytes:
        import os
        with self._lock:
            self._next += 1
            return self._next.to_bytes(8, "little") + os.urandom(8)

    def _track(self, conn, ref) -> bytes:
        oid = self._new_id()
        self._session(conn)["objects"][oid] = ref
        return oid

    # -- handlers (run on the proxy's rpc loop; blocking work uses the
    #    driver's own bridge thread through executors)
    async def h_put(self, conn, payload: bytes):
        import asyncio

        import ray_tpu_torch
        value = cloudpickle.loads(payload)
        ref = await asyncio.get_event_loop().run_in_executor(
            None, ray_tpu_torch.put, value)
        return self._track(conn, ref)

    async def h_get(self, conn, oids: List[bytes], timeout=None):
        import asyncio

        import ray_tpu_torch
        objects = self._session(conn)["objects"]
        refs = [objects[o] for o in oids]

        def fetch():
            vals = ray_tpu_torch.get(refs, timeout=timeout)
            return cloudpickle.dumps(vals)
        try:
            return {"ok": True,
                    "payload": await asyncio.get_event_loop()
                    .run_in_executor(None, fetch)}
        except Exception as e:
            return {"ok": False, "error": cloudpickle.dumps(e)}

    async def h_wait(self, conn, oids: List[bytes], num_returns: int,
                     timeout=None):
        import asyncio

        import ray_tpu_torch
        objects = self._session(conn)["objects"]
        refs = [objects[o] for o in oids]
        by_ref = {id(objects[o]): o for o in oids}
        ready, rest = await asyncio.get_event_loop().run_in_executor(
            None, lambda: ray_tpu_torch.wait(refs, num_returns=num_returns,
                                             timeout=timeout))
        return {"ready": [by_ref[id(r)] for r in ready],
                "not_ready": [by_ref[id(r)] for r in rest]}

    def h_register_function(self, conn, func_id: bytes, payload: bytes):
        funcs = self._session(conn)["funcs"]
        if func_id not in funcs:
            funcs[func_id] = cloudpickle.loads(payload)
        return True

    def _decode_args(self, conn, args_payload: bytes):
        args, kwargs = cloudpickle.loads(args_payload)
        objects = self._session(conn)["objects"]

        def resolve(v):
            if isinstance(v, _ServerRefMarker):
                return objects[v.oid]
            return v
        return ([resolve(a) for a in args],
                {k: resolve(v) for k, v in kwargs.items()})

    async def h_submit_task(self, conn, func_id: bytes, args_payload: bytes,
                            opts: Dict):
        import asyncio

        import ray_tpu_torch
        fn = self._session(conn)["funcs"][func_id]
        args, kwargs = self._decode_args(conn, args_payload)
        rf = ray_tpu_torch.remote(fn)
        if opts:
            rf = rf.options(**opts)
        refs = await asyncio.get_event_loop().run_in_executor(
            None, lambda: rf.remote(*args, **kwargs))
        refs = refs if isinstance(refs, list) else [refs]
        return [self._track(conn, r) for r in refs]

    async def h_create_actor(self, conn, func_id: bytes, args_payload: bytes,
                             opts: Dict):
        import asyncio

        import ray_tpu_torch
        cls = self._session(conn)["funcs"][func_id]
        args, kwargs = self._decode_args(conn, args_payload)
        ac = ray_tpu_torch.remote(cls)
        if opts:
            ac = ac.options(**opts)
        handle = await asyncio.get_event_loop().run_in_executor(
            None, lambda: ac.remote(*args, **kwargs))
        actor_id = handle._actor_id
        st = self._session(conn)
        st["actors"][actor_id] = handle
        if (opts or {}).get("lifetime") == "detached":
            # detached actors outlive their creator BY CONTRACT — track
            # for calls but exclude from disconnect reaping
            st.setdefault("detached", set()).add(actor_id)
        return actor_id

    async def h_call_actor(self, conn, actor_id: str, method_name: str,
                           args_payload: bytes):
        import asyncio

        import ray_tpu_torch
        handle = self._session(conn)["actors"][actor_id]
        args, kwargs = self._decode_args(conn, args_payload)
        ref = await asyncio.get_event_loop().run_in_executor(
            None, lambda: getattr(handle, method_name).remote(
                *args, **kwargs))
        return self._track(conn, ref)

    async def h_get_actor(self, conn, name: str, namespace: str = "default"):
        """Look up a (typically detached) named actor and attach its
        handle to THIS session — the path by which a reconnecting client
        regains access to actors that outlived its previous session
        (reference: ray.get_actor through the client proxy)."""
        import asyncio

        import ray_tpu_torch
        handle = await asyncio.get_event_loop().run_in_executor(
            None, lambda: ray_tpu_torch.get_actor(name, namespace))
        st = self._session(conn)
        st["actors"][handle._actor_id] = handle
        # looked-up actors are never reaped on disconnect: this session
        # did not create them
        st.setdefault("detached", set()).add(handle._actor_id)
        return handle._actor_id

    async def h_kill_actor(self, conn, actor_id: str):
        import asyncio

        import ray_tpu_torch
        handle = self._session(conn)["actors"].pop(actor_id, None)
        if handle is not None:
            # blocking bridge must not run on this loop (it IS the
            # driver's loop) — executor thread instead
            await asyncio.get_event_loop().run_in_executor(
                None, ray_tpu_torch.kill, handle)
        return True

    def h_free(self, conn, oids: List[bytes]):
        objects = self._session(conn)["objects"]
        for o in oids:
            objects.pop(o, None)
        return True

    async def h_cluster_resources(self, conn):
        import asyncio

        import ray_tpu_torch
        return await asyncio.get_event_loop().run_in_executor(
            None, ray_tpu_torch.cluster_resources)

    async def start(self) -> str:
        from ray_tpu_torch._private import rpc
        handlers = {
            "put": self.h_put, "get": self.h_get, "wait": self.h_wait,
            "register_function": self.h_register_function,
            "submit_task": self.h_submit_task,
            "create_actor": self.h_create_actor,
            "call_actor": self.h_call_actor,
            "kill_actor": self.h_kill_actor,
            "get_actor": self.h_get_actor,
            "free": self.h_free,
            "cluster_resources": self.h_cluster_resources,
            "ping": lambda conn: "pong",
        }
        self.server = rpc.Server(handlers, name="client-proxy")
        self.server.on_disconnect = self._on_disconnect
        self.address = await self.server.listen_tcp(self.host, self.port)
        return self.address


def serve_proxy(port: int = 0, host: str = "127.0.0.1") -> str:
    """Start a proxy server on the connected cluster; returns its address.
    Runs on the driver's existing event loop thread. It listens on `host`
    (loopback by default: a client's payloads are unpickled and run)."""
    import asyncio

    import ray_tpu_torch
    w = ray_tpu_torch._get_worker()
    proxy = ClientProxyServer(port=port, host=host)
    return asyncio.run_coroutine_threadsafe(
        proxy.start(), w.core.loop).result(30)


# --------------------------------------------------------------- client side
class _ServerRefMarker:
    """Placeholder for a ClientObjectRef inside pickled task args."""

    def __init__(self, oid: bytes):
        self.oid = oid


class ClientObjectRef:
    __slots__ = ("id", "_ctx")

    def __init__(self, oid: bytes, ctx: "ClientContext"):
        self.id = oid
        self._ctx = ctx

    def __repr__(self):
        return f"ClientObjectRef({self.id.hex()[:16]})"

    def __reduce__(self):
        return (_ServerRefMarker, (self.id,))


class ClientRemoteFunction:
    def __init__(self, ctx: "ClientContext", fn, opts: Optional[Dict] = None):
        self._ctx = ctx
        self._fn = fn
        self._opts = opts or {}
        import hashlib
        self._func_id = hashlib.sha1(
            cloudpickle.dumps(fn)).digest()[:16]

    def options(self, **opts):
        return ClientRemoteFunction(self._ctx, self._fn,
                                    {**self._opts, **opts})

    def remote(self, *args, **kwargs):
        ctx = self._ctx
        ctx._ensure_function(self._func_id, self._fn)
        oids = ctx._call("submit_task", func_id=self._func_id,
                         args_payload=cloudpickle.dumps((args, kwargs)),
                         opts=self._opts)
        refs = [ClientObjectRef(o, ctx) for o in oids]
        return refs[0] if len(refs) == 1 else refs


class ClientActorMethod:
    def __init__(self, ctx, actor_id, name):
        self._ctx = ctx
        self._actor_id = actor_id
        self._name = name

    def remote(self, *args, **kwargs):
        oid = self._ctx._call(
            "call_actor", actor_id=self._actor_id, method_name=self._name,
            args_payload=cloudpickle.dumps((args, kwargs)))
        return ClientObjectRef(oid, self._ctx)


class ClientActorHandle:
    def __init__(self, ctx, actor_id: str):
        self._ctx = ctx
        self._actor_id = actor_id

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self._ctx, self._actor_id, name)


class ClientActorClass:
    def __init__(self, ctx, cls, opts: Optional[Dict] = None):
        self._ctx = ctx
        self._cls = cls
        self._opts = opts or {}
        import hashlib
        self._func_id = hashlib.sha1(cloudpickle.dumps(cls)).digest()[:16]

    def options(self, **opts):
        return ClientActorClass(self._ctx, self._cls,
                                {**self._opts, **opts})

    def remote(self, *args, **kwargs):
        ctx = self._ctx
        ctx._ensure_function(self._func_id, self._cls)
        actor_id = ctx._call(
            "create_actor", func_id=self._func_id,
            args_payload=cloudpickle.dumps((args, kwargs)),
            opts=self._opts)
        return ClientActorHandle(ctx, actor_id)


class ClientContext:
    """One remote session; owns a background event loop + connection."""

    def __init__(self, address: str):
        import asyncio

        from ray_tpu_torch._private import rpc
        self.address = address
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="client-loop", daemon=True)
        self._thread.start()
        self._conn = self._submit(rpc.connect(address, name="client",
                                              retries=10))
        self._shipped: set = set()

    def _submit(self, coro, timeout: float = 600):
        import asyncio
        return asyncio.run_coroutine_threadsafe(
            coro, self._loop).result(timeout)

    def _call(self, _method, **kw):
        return self._submit(self._conn.call(_method, **kw))

    def _ensure_function(self, func_id: bytes, fn):
        if func_id not in self._shipped:
            self._call("register_function", func_id=func_id,
                       payload=cloudpickle.dumps(fn))
            self._shipped.add(func_id)

    # public surface (mirrors ray_tpu_torch.*)
    def remote(self, target=None, **opts):
        import inspect
        if target is None:
            return lambda t: (self.remote(t, **opts))
        if inspect.isclass(target):
            return ClientActorClass(self, target, opts or None)
        return ClientRemoteFunction(self, target, opts or None)

    def put(self, value) -> ClientObjectRef:
        oid = self._call("put", payload=cloudpickle.dumps(value))
        return ClientObjectRef(oid, self)

    def get(self, refs, timeout=None):
        single = isinstance(refs, ClientObjectRef)
        if single:
            refs = [refs]
        resp = self._call("get", oids=[r.id for r in refs],
                          timeout=timeout)
        if not resp["ok"]:
            raise cloudpickle.loads(resp["error"])
        vals = cloudpickle.loads(resp["payload"])
        return vals[0] if single else vals

    def wait(self, refs, num_returns=1, timeout=None):
        by_id = {r.id: r for r in refs}
        resp = self._call("wait", oids=[r.id for r in refs],
                          num_returns=num_returns, timeout=timeout)
        return ([by_id[o] for o in resp["ready"]],
                [by_id[o] for o in resp["not_ready"]])

    def kill(self, actor: ClientActorHandle):
        self._call("kill_actor", actor_id=actor._actor_id)

    def get_actor(self, name: str,
                  namespace: str = "default") -> ClientActorHandle:
        actor_id = self._call("get_actor", name=name, namespace=namespace)
        return ClientActorHandle(self, actor_id)

    def cluster_resources(self):
        return self._call("cluster_resources")

    def disconnect(self):
        global _client
        try:
            self._submit(self._conn.close(), timeout=5)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        if _client is self:
            _client = None


def connect(address: str) -> ClientContext:
    """Connect this process to a remote cluster through its client proxy.
    Accepts "host:port" or "ray://host:port"."""
    global _client
    if address.startswith("ray://"):
        address = address[len("ray://"):]
    ctx = ClientContext(address)
    _client = ctx
    return ctx
