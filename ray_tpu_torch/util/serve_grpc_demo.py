"""Serve test targets importable by worker processes (xlang_demo
pattern): a hand-written equivalent of protoc-generated registration
code for a tiny Echo service, plus an app builder for `serve deploy`
configs (tests/test_torch_serve_grpc.py).

`add_EchoServicer_to_server` has exactly the shape protoc emits — a
method-handlers dict with per-method (de)serializers registered through
`grpc.method_handlers_generic_handler`. A UTF-8 codec stands in for the
protobuf message classes; the proxy treats messages as opaque objects
either way (reference: python/ray/serve/_private/proxy.py:558 gRPCProxy
consumes generated add_*_to_server functions the same way)."""

from __future__ import annotations

SERVICE_NAME = "raytpu.demo.Echo"


def add_EchoServicer_to_server(servicer, server):   # noqa: N802
    import grpc
    rpc_method_handlers = {
        "Echo": grpc.unary_unary_rpc_method_handler(
            servicer.Echo,
            request_deserializer=lambda b: b.decode("utf-8"),
            response_serializer=lambda s: s.encode("utf-8")),
        "Reverse": grpc.unary_unary_rpc_method_handler(
            servicer.Reverse,
            request_deserializer=lambda b: b.decode("utf-8"),
            response_serializer=lambda s: s.encode("utf-8")),
    }
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(SERVICE_NAME,
                                             rpc_method_handlers),))


def echo_client(address: str, method: str, payload: str,
                application: str = "default", timeout: float = 60.0) -> str:
    """Typed-service client (the shape a generated stub produces)."""
    import grpc
    with grpc.insecure_channel(address) as channel:
        fn = channel.unary_unary(
            f"/{SERVICE_NAME}/{method}",
            request_serializer=lambda s: s.encode("utf-8"),
            response_deserializer=lambda b: b.decode("utf-8"))
        return fn(payload, metadata=[("application", application)],
                  timeout=timeout)


def build_echo_app(prefix: str = "echo"):
    """App builder for declarative configs (import_path target)."""
    from ray_tpu_torch import serve

    @serve.deployment
    class EchoDeployment:
        def __init__(self, prefix: str):
            self.prefix = prefix

        def __call__(self, payload):
            return {"echo": payload, "prefix": self.prefix}

        def Echo(self, request: str) -> str:        # noqa: N802
            return f"{self.prefix}:{request}"

        def Reverse(self, request: str) -> str:     # noqa: N802
            return request[::-1]

    return EchoDeployment.bind(prefix)
