"""gRPC ingress proxy actor, one per node (reference:
python/ray/serve/_private/proxy.py gRPCProxy :558; the JAX package's
serve/grpc_proxy.py). ``grpcio`` is imported where a proxy starts or a
client calls, never at import.

Schema-free generic service so users need no protoc step: requests call
``/rayserve.Ingress/Call`` with metadata ``("application", name)`` (and
optionally ``("method", name)``); request bodies are msgpack (falling
back to raw bytes), response bodies msgpack or, for what msgpack cannot
carry, cloudpickle behind a marker. ``grpc_call()`` is the matching
client helper. Routing state is long-poll-pushed from the controller
like the HTTP proxy's.

Unlike the JAX package's proxy, the ingress never unpickles: a request
body with the pickle marker is refused (INVALID_ARGUMENT), since any
client that reaches the port could otherwise run code in the proxy, and
``grpc_call`` sends msgpack only. Only the client unpickles, what the
proxy it called sent back.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Dict, Optional

import msgpack

SERVICE = "rayserve.Ingress"
METHOD = "Call"


_PICKLED = b"\x00PKL"


def _encode(obj) -> bytes:
    """A response body: msgpack, else cloudpickle behind the marker."""
    try:
        return msgpack.packb(obj, use_bin_type=True)
    except (TypeError, ValueError):
        import cloudpickle
        return _PICKLED + cloudpickle.dumps(obj)


def _decode(data: bytes):
    """A response body, on the client."""
    if data[:4] == _PICKLED:
        import cloudpickle
        return cloudpickle.loads(data[4:])
    return _decode_request(data)


def _encode_request(obj) -> bytes:
    try:
        return msgpack.packb(obj, use_bin_type=True)
    except (TypeError, ValueError) as e:
        raise TypeError(f"a gRPC request body must be msgpack: {e}") \
            from None


def _decode_request(data: bytes):
    """A request body, at the ingress: msgpack, else the raw bytes. A
    pickled body is refused before this (``GrpcProxy._call``)."""
    try:
        return msgpack.unpackb(data, raw=False)
    except Exception:
        return data


class _DynamicServicer:
    """Servicer stand-in handed to user `add_X_to_server` functions
    (reference: proxy.py:558 gRPCProxy — the generated registration code
    reads one attribute per proto method; every method routes into serve
    with the DESERIALIZED protobuf request as the payload, and the
    deployment returns the protobuf response message)."""

    def __init__(self, proxy: "GrpcProxy"):
        self._proxy = proxy

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        proxy = self._proxy

        def handler(request, context):
            return proxy._typed_call(method, request, context)

        return handler


class GrpcProxy:
    def __init__(self, port: int, controller, servicer_functions=None):
        import importlib

        import grpc

        self.controller = controller
        self.ingress: Dict[str, str] = {}
        self._versions = {"routes": 0}
        self._handles = {}

        proxy = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if handler_call_details.method != f"/{SERVICE}/{METHOD}":
                    return None
                return grpc.unary_unary_rpc_method_handler(
                    proxy._call,
                    request_deserializer=None,
                    response_serializer=None)

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16),
            handlers=(_Handler(),),
            # REUSEPORT off: several per-node proxies share a host in
            # tests; each must get its own distinct listener
            options=(("grpc.so_reuseport", 0),))
        # typed protobuf services (reference: grpc_servicer_functions):
        # each entry is the import path of a generated add_X_to_server;
        # protobuf (de)serialization stays in grpc's layer, the routed
        # payload is the real request message
        for path in servicer_functions or []:
            mod, _, attr = path.partition(":")
            if not attr:
                mod, attr = path.rsplit(".", 1)
            add_fn = getattr(importlib.import_module(mod), attr)
            add_fn(_DynamicServicer(self), self._server)
        try:
            bound = self._server.add_insecure_port(f"0.0.0.0:{port}")
        except RuntimeError:
            bound = 0
        if bound == 0:
            # port taken (several per-node proxies share a host in tests):
            # fall back to an ephemeral port
            bound = self._server.add_insecure_port("0.0.0.0:0")
        self._server.start()
        from ray_tpu_torch._private.rpc import node_ip_address
        self._addr = f"{node_ip_address()}:{bound}"
        self._prime_routes()
        self._poller = threading.Thread(target=self._longpoll_loop,
                                        daemon=True)
        self._poller.start()

    def _prime_routes(self):
        from ray_tpu_torch.serve.long_poll import prime_snapshot
        prime_snapshot(self.controller, self._versions, self._on_update)

    def _longpoll_loop(self):
        from ray_tpu_torch.serve.long_poll import run_longpoll_loop
        run_longpoll_loop(lambda: self.controller, self._versions,
                          self._on_update)

    def _on_update(self, key: str, data):
        if key != "routes":
            return
        new_ingress = data["ingress"]
        for app, dep in list(self._handles.items()):
            if new_ingress.get(app) != dep.deployment_name:
                self._handles.pop(app, None)
        self.ingress = new_ingress

    def ready(self) -> str:
        return self._addr

    def _handle_for(self, context):
        import grpc
        meta = dict(context.invocation_metadata())
        app_name = meta.get("application", "default")
        dep = self.ingress.get(app_name)
        if dep is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no application {app_name!r}")
        h = self._handles.get(app_name)
        if h is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle
            h = DeploymentHandle(dep, app_name)
            self._handles[app_name] = h
        return h, meta

    def _call(self, request: bytes, context) -> bytes:
        import grpc
        if request[:4] == _PICKLED:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "a pickled request body is refused: send msgpack")
        h, meta = self._handle_for(context)
        method = meta.get("method")
        payload = _decode_request(request)
        try:
            target = getattr(h, method) if method else h
            result = target.remote(payload).result(timeout=60)
        except Exception as e:
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")
        return _encode(result)

    def _typed_call(self, method: str, request, context):
        """Typed-service path: the deployment method named after the
        proto rpc receives the protobuf request message and returns the
        protobuf response message."""
        import grpc
        h, _ = self._handle_for(context)
        try:
            return getattr(h, method).remote(request).result(timeout=60)
        except Exception as e:
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")


def grpc_call(address: str, payload, application: str = "default",
              method: Optional[str] = None, timeout: float = 60.0):
    """Client helper for the generic ingress. ``payload`` must be
    msgpack-serializable (TypeError otherwise)."""
    import grpc

    metadata = [("application", application)]
    if method:
        metadata.append(("method", method))
    with grpc.insecure_channel(address) as channel:
        fn = channel.unary_unary(f"/{SERVICE}/{METHOD}",
                                 request_serializer=None,
                                 response_deserializer=None)
        out = fn(_encode_request(payload), metadata=metadata,
                 timeout=timeout)
    return _decode(out)
