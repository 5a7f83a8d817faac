"""The port's LLMDeployment (ray_tpu_torch.inference.api) against the JAX
package's, and on the port's Serve.

- In process (no cluster): JAX's LLMDeployment and the port's on the same
  weights (the JAX init of a seed, through params_fn; the port's take
  params_from_jax of the same arrays) give equal greedy streams, token for
  token once the coalesced chunks are flattened, equal stats() counters
  and the same metric names.
- tests/test_serve_streaming.py's cases on the port: a streaming handle
  with an error mid-stream, the replica closing a dropped stream's user
  generator, a dropped LLMDeployment generator freeing its slot (in
  process and over Serve), and a replica killed mid-stream by
  ServeReplicaKiller: the stream resumes on the survivor with no token
  lost or doubled.
- The weight plane: the second replica of a deployment reads the weights
  from the object store; params_fn runs once.

fp32 and a tiny model throughout, on the CPU (device="cpu")."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import ray_tpu_torch as rt
from ray_tpu.inference import LLMDeployment as JaxLLMDeployment
from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.models.transformer import TransformerLM as JaxLM
from ray_tpu_torch import serve
from ray_tpu_torch.inference import LLMDeployment
from ray_tpu_torch.models import TransformerConfig, params_from_jax
from ray_tpu_torch.util.chaos import ServeReplicaKiller

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=128, max_seq_len=512)
ENGINE = dict(n_slots=2, max_len=256, prefill_chunk=8, prefill_budget=16)
CFG = TransformerConfig(**SHAPE, dtype=torch.float32)


def _jax_params(seed):
    model = JaxLM(JaxConfig(**SHAPE, dtype=jnp.float32,
                            param_dtype=jnp.float32, remat=False))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, meta.unbox(params))


@pytest.fixture(scope="module")
def weights():
    """The JAX init of seed 3 as numpy arrays, and the same as a state
    dict for the port."""
    tree = _jax_params(3)
    return tree, {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _state_dict(arrays):
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


PROMPTS = [[5, 6, 7], list(range(20, 37)), [int(t) for t in
                                             np.random.RandomState(1)
                                             .randint(0, 128, 29)]]


def _chunks(dep, prompt, n):
    return [list(c) for c in dep(prompt, max_new_tokens=n)]


@pytest.fixture(scope="module")
def cluster():
    ctx = rt.init(num_cpus=6, object_store_memory=128 * 1024 * 1024,
                  _system_config={"serve_reconcile_period_s": 0.25})
    try:
        yield ctx
    finally:
        serve.shutdown()
        rt.shutdown()


def test_streaming_handle(cluster, pair):
    # asks for the pair first: its replicas build while this and the
    # in-process cases below run
    @serve.deployment
    class Streamer:
        def __call__(self, n):
            for i in range(n):
                yield {"token": i}

        def fail_midway(self, n):
            for i in range(n):
                if i == 3:
                    raise ValueError("midstream boom")
                yield i

    serve.run(Streamer.bind(), name="stream-app")
    h = serve.get_app_handle("stream-app").options(stream=True)
    assert list(h.remote(5)) == [{"token": i} for i in range(5)]
    got = []
    with pytest.raises(ValueError, match="midstream boom"):
        for c in h.fail_midway.remote(10):
            got.append(c)
    assert got == [0, 1, 2]
    serve.delete("stream-app")


@pytest.fixture(scope="module")
def pair(cluster, weights, tmp_path_factory):
    """Two replicas of one LLMDeployment, built together, whose params_fn
    leaves a mark in a file each time it runs."""
    marks = tmp_path_factory.mktemp("llm") / "params_fn_calls"
    arrays = weights[1]

    def params_fn():
        # self-contained: a module-level helper would make the replica
        # import this test module, and JAX with it
        with open(marks, "a") as f:
            f.write("called\n")
        return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}

    dep = serve.deployment(LLMDeployment, num_replicas=2)
    serve.run(dep.bind(CFG, params_fn=params_fn, weights_key="test/pair",
                       stream_coalesce_tokens=4, stream_coalesce_ms=10.0,
                       device="cpu", **ENGINE), name="llm-pair")
    h = serve.get_app_handle("llm-pair")
    deadline = time.monotonic() + 60
    while len(h._router.replicas) < 2 and time.monotonic() < deadline:
        h._router.refresh(force=True)
        time.sleep(0.1)
    return h, marks


def test_llm_deployment_tokens_equal_jax(weights):
    tree, arrays = weights
    jdep = JaxLLMDeployment(
        JaxConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32,
                  remat=False), params_fn=lambda: tree,
        stream_coalesce_tokens=4, **ENGINE)
    tdep = LLMDeployment(CFG, params_fn=lambda: _state_dict(arrays),
                         stream_coalesce_tokens=4, device="cpu", **ENGINE)
    try:
        for prompt, n in zip(PROMPTS, (12, 9, 20)):
            want = _chunks(jdep, prompt, n)
            got = _chunks(tdep, prompt, n)
            assert [t for c in got for t in c] == \
                [t for c in want for t in c]
            assert len(got[0]) == 1          # the eager first token
            assert sum(map(len, got)) == n
        # a repeat of a cached prompt: a prefix-cache hit on both
        assert tdep.generate(PROMPTS[1], max_new_tokens=9) == \
            jdep.generate(PROMPTS[1], max_new_tokens=9)
        js, ts = jdep.stats(), tdep.stats()
        assert set(js) - {"decode_compile_count"} == set(ts)
        # steps count idle loop turns too: timing, not a counter
        assert {k: v for k, v in ts.items() if k != "steps"} == \
            {k: js[k] for k in ts if k != "steps"}
        assert ts["prefix_hits"] == 1

        def names(dep):
            return sorted(m.name for m in vars(dep._metrics).values()
                          if hasattr(m, "name"))
        assert names(tdep) == names(jdep)
    finally:
        jdep.engine.stop()
        tdep.engine.stop()


def test_mesh_and_device_arguments(weights):
    """A ``mesh`` that is not a mesh fails as in the JAX deployment (its
    engine's AttributeError); the device defaults to the card."""
    tree, arrays = weights
    with pytest.raises(AttributeError):
        JaxLLMDeployment(JaxConfig(**SHAPE, dtype=jnp.float32,
                                   param_dtype=jnp.float32, remat=False),
                         params_fn=lambda: tree, weights_key=None,
                         mesh=object())
    with pytest.raises(AttributeError):
        LLMDeployment(CFG, params_fn=lambda: arrays, weights_key=None,
                      mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMDeployment(CFG)        # device defaults to "cuda"


class _Tracker:
    """Counts generator entry and exit, to see whether the replica-side
    finally ran."""

    def __init__(self):
        self.active = 0
        self.closed = 0

    def stream(self, n):
        self.active += 1
        try:
            for i in range(n):
                yield i
        finally:
            self.active -= 1
            self.closed += 1

    def state(self):
        return (self.active, self.closed)


def test_replica_stream_close_runs_user_finally():
    """Closing the replica's handle_stream generator mid-iteration closes
    the user generator (GeneratorExit through its finally) and releases
    the ongoing count."""
    import cloudpickle

    from ray_tpu_torch.serve.replica import Replica
    r = Replica(cloudpickle.dumps(_Tracker), (), {}, False)
    g = r.handle_stream("stream", (1000,), {})
    assert next(g) == 0 and next(g) == 1
    assert r.handle_request("state", (), {}) == (1, 0)
    g.close()
    assert r.handle_request("state", (), {}) == (0, 1)
    assert r.get_queue_len() == 0


def _wait_free(stats_fn, timeout_s=30):
    deadline = time.monotonic() + timeout_s
    st = {}
    while time.monotonic() < deadline:
        st = stats_fn()
        if st.get("slots_free") == st.get("n_slots") and \
                st.get("queue_depth") == 0:
            break
        time.sleep(0.02)
    return st


def test_llm_deployment_generator_exit_frees_slot(weights):
    """Dropping LLMDeployment's streaming generator mid-generation
    cancels the engine request: the slot returns to the pool."""
    dep = LLMDeployment(CFG, params_fn=lambda: _state_dict(weights[1]),
                        device="cpu", **ENGINE)
    try:
        gen = dep([1, 2, 3, 4], max_new_tokens=200)
        assert len([next(gen) for _ in range(3)]) == 3
        assert dep.stats()["slots_occupied"] == 1
        gen.close()                      # GeneratorExit -> cancel
        st = _wait_free(dep.stats)
        assert st["slots_free"] == 2 and st["queue_depth"] == 0, st
        assert len(dep.generate([5, 6], max_new_tokens=4)) == 4
    finally:
        dep.engine.stop()


def test_second_replica_attaches_weights_from_the_store(pair, weights):
    """One replica runs params_fn and publishes the weights; the other
    waits for that publish and reads them from the store."""
    h, marks = pair
    assert len(h._router.replicas) == 2
    local = LLMDeployment(CFG, params_fn=lambda: _state_dict(weights[1]),
                          device="cpu", **ENGINE)
    try:
        want = local.generate(PROMPTS[2], max_new_tokens=10)
    finally:
        local.engine.stop()
    got = [rt.get(r.handle_request.remote(
        "generate", (PROMPTS[2],), {"max_new_tokens": 10}), timeout=60)
        for r in h._router.replicas]
    assert got == [want, want]
    assert marks.read_text().splitlines() == ["called"]


def test_stream_cancellation_frees_slot_over_serve(pair):
    """A client drops a Serve streaming iterator mid-generation: the
    engine slot frees and the queue drains."""
    h, _ = pair
    stream = h.options(stream=True)
    gen = stream.remote([1, 2, 3, 4], max_new_tokens=200)
    got = []
    for tok in gen:
        got.append(tok)
        if len(got) >= 3:
            break
    gen.close()                          # the client walks away
    for r in h._router.replicas:
        st = _wait_free(lambda: rt.get(r.handle_request.remote(
            "stats", (), {}), timeout=30))
        assert st["slots_free"] == st["n_slots"], st
        assert st["queue_depth"] == 0, st
    assert len(list(stream.remote([9, 8, 7], max_new_tokens=5))) == 5


def test_kill_replica_mid_stream_resumes_on_survivor(pair):
    """A replica killed mid-stream (past the first coalesced chunk): the
    handle resubmits with the tokens already delivered, the survivor
    continues, and the stream equals an uninterrupted one, with no token
    lost or doubled."""
    h, _ = pair
    stream = h.options(stream=True)
    oracle = list(stream.remote(PROMPTS[1], max_new_tokens=32))
    assert len(oracle) == 32
    killer = ServeReplicaKiller("llm-pair", "LLMDeployment")
    gen = stream.remote(PROMPTS[1], max_new_tokens=32)
    got = [next(gen) for _ in range(6)]      # > one coalesced chunk
    assert killer.kill_one(prefer_busy=True)
    got.extend(gen)
    assert got == oracle
    assert killer.killed == 1


def test_router_prefers_started_replicas(monkeypatch):
    """A replica still in its constructor (a replacement loading its
    weights) takes a request only when no started replica can: a stream
    resumed after a kill goes to the survivor, not to the replacement."""
    from ray_tpu_torch.serve import handle as handle_mod

    def no_long_poll():
        raise RuntimeError("no controller here")
    monkeypatch.setattr(handle_mod._LongPollClient, "get",
                        staticmethod(no_long_poll))
    router = handle_mod._Router("LLMDeployment", "app")
    info = {"version": 1, "replicas": ["survivor", "replacement"],
            "started": [True, False]}

    def picks(version, started, avoid=None):
        router._ingest(dict(info, version=version, started=started),
                       time.monotonic())
        return {router.pick(avoid=avoid)[1] for _ in range(20)}

    assert picks(1, [True, False]) == {"survivor"}
    assert picks(2, [False, False]) == {"survivor", "replacement"}
    # the started one failed this call: the starting one takes it
    assert picks(3, [True, False], avoid={0}) == {"replacement"}
