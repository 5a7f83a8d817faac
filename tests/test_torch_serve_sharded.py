"""Sharded serving in the port (``serve/sharded.py``,
``serve/sharded_replica.py``) against the JAX package's.

Unit tier, in process (a world of one rank over gloo): the port's
``ShardedEngineReplica`` and JAX's on the same weights give the same
streams and the same stream digests (blake2b of the int32 tokens, so
replicas agree), a resumed stream returns exactly the missing suffix
(with spec decoding), the first chunk is its own; a digest divergence
wedges the gang; the drain covers the whole gang; ``build_sharded_app``'s
shape; ``ShellPool.checkout_many`` is atomic; ``GangRankKiller``'s spec
and environment variable, and rank 0's immunity (``os.kill`` patched).
These mirror ``tests/test_sharded_serving.py``.

The cluster tier (a ``num_hosts=2`` gang on a runtime, a rank killed
mid-decode) is ``tests/test_torch_serve_gang.py``, so each file stays
short alone."""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax.core import meta

from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.models.transformer import TransformerLM as JaxLM
from ray_tpu.serve.sharded import ShardedEngineReplica as JaxReplica
from ray_tpu_torch.models import TransformerConfig, params_from_jax

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
DRAFT = dict(vocab_size=128, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=128)
REPLICA = dict(n_slots=2, max_len=64, prefill_chunk=4, prefill_budget=8,
               seed=0)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


def _jax(shape, seed):
    cfg = JaxConfig(**shape, dtype=jnp.float32, param_dtype=jnp.float32,
                    remat=False)
    params = jax.jit(JaxLM(cfg).init)(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg, params


def _sd(params):
    return params_from_jax(jax.tree.map(np.asarray, meta.unbox(params)))


@pytest.fixture(scope="module")
def world_of_one():
    """The port's replicas start a gloo world of one rank in this process
    (``default_serving_mesh``); it goes with the module."""
    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def weights():
    cfg, params = _jax(SHAPE, 0)
    dcfg, dparams = _jax(DRAFT, 3)
    return cfg, params, dcfg, dparams


def _port(weights, spec=False, **kw):
    from ray_tpu_torch.serve.sharded import ShardedEngineReplica
    _, params, _, dparams = weights
    sd, dsd = _sd(params), _sd(dparams)
    if spec:
        kw["spec_decode"] = {
            "draft_model": TransformerConfig(**DRAFT, dtype=torch.float32),
            "k": 4, "draft_params_fn": lambda: dsd}
    return ShardedEngineReplica(
        TransformerConfig(**SHAPE, dtype=torch.float32),
        params_fn=lambda: sd, device="cpu", **{**REPLICA, **kw})


def _jax_replica(weights, spec=False, **kw):
    """JAX's replica on a one-device mesh (the port's runs on a world of
    one rank; a mesh over the 8 host devices only compiles longer)."""
    from ray_tpu.parallel import MeshConfig, make_mesh
    cfg, params, dcfg, dparams = weights
    if spec:
        kw["spec_decode"] = {"draft_model": dcfg, "k": 4,
                             "draft_params_fn": lambda: dparams}
    mesh = make_mesh(MeshConfig(fsdp=1), devices=jax.devices()[:1])
    return JaxReplica(JaxLM(cfg), params_fn=lambda: params, mesh=mesh,
                      **{**REPLICA, **kw})


def _streams(rep):
    """What the JAX tests ask of a replica: two streams with the digest
    after each, then a spec-free coalesced stream's chunks."""
    out = {"a": rep.generate(PROMPT, max_new_tokens=12)}
    out["digest_a"] = rep.last_stream_digest()
    out["b"] = rep.generate([9, 9], max_new_tokens=4)
    out["digest_b"] = rep.last_stream_digest()
    out["chunks"] = list(rep(PROMPT, max_new_tokens=9,
                             stream_coalesce_tokens=8))
    return out


def _resumes(rep):
    full = rep.generate(PROMPT, max_new_tokens=24)
    return {"full": full,
            "resumed": rep.generate(PROMPT, max_new_tokens=24,
                                    resume_tokens=full[:10]),
            "done": rep.generate(PROMPT, max_new_tokens=24,
                                 resume_tokens=full)}


@pytest.fixture(scope="module")
def jax_runs(weights):
    return (_streams(_jax_replica(weights)),
            _resumes(_jax_replica(weights, spec=True)))


# ==========================================================================
# unit tier: one rank in this process, against JAX's replica
# ==========================================================================

def test_streams_and_digests_match_jax(world_of_one, weights, jax_runs):
    """Same weights, same greedy streams; the digest is (stream_seq,
    32-hex blake2b) and equals JAX's, so two same-seed replicas agree,
    and a different stream bumps the sequence and changes it."""
    jax_streams, _ = jax_runs
    a, b = _port(weights), _port(weights)
    assert a.last_stream_digest() is None
    got = _streams(a)
    assert got["a"] == jax_streams["a"] and len(got["a"]) == 12
    assert got["b"] == jax_streams["b"]
    da = got["digest_a"]
    assert da[0] == 1 and len(da[1]) == 32
    assert da == jax_streams["digest_a"]
    b.generate(PROMPT, max_new_tokens=12)
    assert b.last_stream_digest() == da
    assert got["digest_b"][0] == 2 and got["digest_b"][1] != da[1]
    assert got["digest_b"] == jax_streams["digest_b"]
    # the streaming protocol: an eager first chunk, then coalesced ones
    chunks = got["chunks"]
    assert chunks == jax_streams["chunks"]
    assert chunks[0] == [chunks[0][0]] and sum(map(len, chunks)) == 9
    st = a.stats()
    assert (st["gang_rank"], st["gang_world"], st["n_devices"]) == (0, 1, 1)
    assert st["requests_served"] == 3


def test_resume_tokens_exactly_once_with_spec_decode(world_of_one, weights,
                                                     jax_runs):
    """Severed-stream re-route: delivered tokens ride the prompt, the
    continuation is the greedy suffix, nothing repeats; a fully delivered
    stream emits nothing. Equal to JAX's replica with the same draft."""
    _, jax_resumes = jax_runs
    got = _resumes(_port(weights, spec=True))
    assert got == jax_resumes
    assert got["resumed"] == got["full"][10:] and got["done"] == []


def test_digest_divergence_wedges_gang(world_of_one, weights, monkeypatch):
    """ReplicaShard wedges the whole gang when any peer's stream digest
    disagrees with rank 0's — split-brain output is never served."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.sharded_replica import ReplicaShard
    shard = ReplicaShard(0, 2)
    shard._callable = _port(weights)
    shard._callable.generate(PROMPT, max_new_tokens=8)
    local = shard._callable.last_stream_digest()

    class _Ref:
        def __init__(self, v):
            self.v = v

    class _PeerMethod:
        def __init__(self, v):
            self.v = v

        def remote(self, *a, **k):
            return _Ref(self.v)

    class _Peer:
        def __init__(self, v):
            self.run_shard = _PeerMethod(v)

    monkeypatch.setattr(ray_tpu_torch, "get",
                        lambda refs, timeout=None: [r.v for r in refs])
    shard._peers = [_Peer(local)]
    shard._verify_stream_digest()        # agreement: no-op
    assert not shard._wedged
    shard._peers = [_Peer((local[0], "0" * 32))]
    with pytest.raises(RuntimeError, match="digest divergence"):
        shard._verify_stream_digest()
    assert shard._wedged
    with pytest.raises(ray_tpu_torch.ActorDiedError, match="wedged"):
        shard.check_health()


def test_drain_covers_whole_gang(world_of_one, weights):
    """rank 0 owns admission, so begin_drain() on the replica drains the
    gang: the engine stops admitting, pending counts reach 0, and the
    shard reports draining to the controller."""
    from ray_tpu_torch.serve.sharded_replica import ReplicaShard
    shard = ReplicaShard(0, 1)
    shard._callable = rep = _port(weights)
    rep.generate(PROMPT, max_new_tokens=4)
    assert shard.begin_drain()
    st = rep.drain_status()
    assert st["draining"] and st["pending"] == 0
    assert shard.get_runtime_state()["draining"]
    with pytest.raises(RuntimeError):
        rep.generate(PROMPT, max_new_tokens=4)


def test_gang_rank_killer_spec_env_and_rank0_immunity(world_of_one,
                                                      weights, monkeypatch):
    from ray_tpu.util.chaos import GangRankKiller as JaxKiller
    from ray_tpu_torch.util.chaos import GangRankKiller
    killer = GangRankKiller(probability=1.0)
    assert killer.spec() == JaxKiller(1.0).spec() == "gang_rank=1.0"
    assert killer.SPEC_ENV == JaxKiller.SPEC_ENV.replace(
        "RAY_TPU_", "RAY_TPU_TORCH_", 1)
    env = killer.env({"A": "1", killer.SPEC_ENV: "shell_attach=0.5"})
    assert env[killer.SPEC_ENV] == "shell_attach=0.5,gang_rank=1.0"
    assert GangRankKiller(at_call=3).spec() == "gang_rank=#3"
    with pytest.raises(ValueError):
        GangRankKiller(probability=0.0)

    rep = _port(weights)
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append((pid, sig)))
    killer.arm_local()
    try:
        # rank 0 never checks the hook: admission must survive chaos
        assert rep._rank == 0
        assert len(rep.generate(PROMPT, max_new_tokens=4)) == 4
        assert kills == []
        # a non-zero rank dies on its first step
        rep._rank = 1
        rep.generate(PROMPT, max_new_tokens=4)
        assert kills and kills[0] == (os.getpid(), signal.SIGKILL)
    finally:
        rep._rank = 0
        GangRankKiller.disarm_local()


def test_shell_pool_checkout_many_is_atomic():
    from ray_tpu_torch.serve.fleet import ShellPool

    class _Shell:
        pass

    pool = ShellPool(_Shell, size=4)
    pool.ensure()
    assert pool.idle() == 4
    assert pool.checkout_many(8) is None     # n or none: no partial gang
    assert pool.idle() == 4
    gang = pool.checkout_many(3)
    assert len(gang) == 3 and pool.idle() == 1
    assert pool.checkout_many(2) is None     # 1 idle < 2: untouched
    assert pool.idle() == 1
    assert pool.stats()["checked_out_total"] == 3


def test_build_sharded_app_shape():
    from ray_tpu_torch.serve.sharded import build_sharded_app
    app = build_sharded_app("llama-debug", num_hosts=2,
                            name="sharded-llm", n_slots=2)
    assert app.deployment.config.num_hosts == 2
    assert app.deployment.name == "sharded-llm"
    assert app.kwargs["n_slots"] == 2


