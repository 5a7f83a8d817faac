"""The port's gRPC ingress (``serve/grpc_proxy.py``,
``util/serve_grpc_demo.py``, the controller's proxy lifecycle), as the
JAX package's ``tests/test_serve_cli_grpc.py`` and
``tests/test_serve_harden.py`` drive it.

One runtime: the untyped ``/rayserve.Ingress/Call`` path
(``serve.grpc_call``) returns what the deployment handle returns, for
msgpack payloads and a named method, and a one-rank
``ShardedEngineReplica``'s greedy tokens through ``generate``; an unknown
application is NOT_FOUND; a pickled request body is refused unread
(INVALID_ARGUMENT), and the client sends msgpack only. The typed path
(the demo's protoc-shaped Echo servicer) equals the handle's calls, and
the proxies are rebuilt when the servicer list changes, and only
then."""

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve

SERVICER = "ray_tpu_torch.util.serve_grpc_demo:add_EchoServicer_to_server"


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024,
            _system_config={"serve_reconcile_period_s": 0.25})
    yield
    serve.shutdown()
    rt.shutdown()


def _grpc_addr():
    (addr,) = [p["grpc"] for p in serve.proxies().values()]
    return addr


class _WritesFile:
    """Unpickling this writes a file: the proof that a body was
    unpickled."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


def test_untyped_calls_equal_the_handles(runtime, tmp_path):
    import cloudpickle
    import grpc

    from ray_tpu_torch.serve.grpc_proxy import METHOD, SERVICE

    from ray_tpu_torch.serve.sharded import build_sharded_app
    from ray_tpu_torch.util.serve_grpc_demo import build_echo_app
    handle = serve.run(build_echo_app("u"), name="untyped",
                       route_prefix=None)
    serve.start(grpc_port=0)
    addr = _grpc_addr()
    for payload in ({"k": 1, "v": [1, 2.5, "x"]}, "text", [3, 4]):
        assert serve.grpc_call(addr, payload, application="untyped") == \
            handle.remote(payload).result(timeout=60)
    with pytest.raises(TypeError, match="msgpack"):
        serve.grpc_call(addr, {1, 2}, application="untyped")   # a set
    marker = tmp_path / "unpickled"
    with grpc.insecure_channel(addr) as channel:
        call = channel.unary_unary(f"/{SERVICE}/{METHOD}")
        with pytest.raises(grpc.RpcError) as err:
            call(b"\x00PKL" + cloudpickle.dumps(_WritesFile(str(marker))),
                 metadata=[("application", "untyped")], timeout=60)
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert not marker.exists()
    assert serve.grpc_call(addr, "abc", application="untyped",
                           method="Reverse") == \
        handle.Reverse.remote("abc").result(timeout=60) == "cba"
    with pytest.raises(grpc.RpcError) as err:
        serve.grpc_call(addr, 1, application="nowhere")
    assert err.value.code() == grpc.StatusCode.NOT_FOUND

    # a one-rank sharded LLM replica: a JSON-like request through the
    # non-streaming generate, the tokens the handle's
    llm = serve.run(build_sharded_app(
        "llama-debug", name="llm", n_slots=2, max_len=64, prefill_chunk=16,
        prefill_budget=32, device="cpu"), name="llm", route_prefix=None)
    req = {"prompt_tokens": [3, 1, 4, 1, 5, 9, 2, 6], "max_new_tokens": 6}
    want = llm.generate.remote(req).result(timeout=120)
    assert len(want) == 6
    assert serve.grpc_call(addr, req, application="llm",
                           method="generate") == want
    serve.delete("llm")
    serve.delete("untyped")


def test_typed_servicer_and_proxy_restart(runtime):
    """Registering a servicer list rebuilds the gRPC proxies: a new proxy
    listens on a new port and the old one no longer answers. The typed
    rpcs then route to the same-named deployment methods; the same list
    again keeps the proxy."""
    import grpc

    from ray_tpu_torch.util.serve_grpc_demo import build_echo_app, echo_client
    handle = serve.run(build_echo_app("svc"), name="typed",
                       route_prefix=None)
    serve.start(grpc_port=0)
    before = _grpc_addr()
    assert serve.grpc_call(before, "p", application="typed") == \
        handle.remote("p").result(timeout=60)
    serve.start(grpc_port=0, grpc_servicer_functions=[SERVICER])
    addr = _grpc_addr()
    assert addr != before
    with pytest.raises(grpc.RpcError) as err:
        serve.grpc_call(before, "p", application="typed", timeout=10)
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    assert echo_client(addr, "Echo", "hello", application="typed") == \
        handle.Echo.remote("hello").result(timeout=60) == "svc:hello"
    assert echo_client(addr, "Reverse", "abc", application="typed") == \
        handle.Reverse.remote("abc").result(timeout=60) == "cba"
    # the untyped ingress still serves beside the typed service
    assert serve.grpc_call(addr, "p", application="typed") == \
        handle.remote("p").result(timeout=60)
    serve.start(grpc_port=0, grpc_servicer_functions=[SERVICER])
    assert _grpc_addr() == addr
    serve.delete("typed")
