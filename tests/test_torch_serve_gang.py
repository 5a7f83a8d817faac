"""A sharded replica's gang on the port's runtime (``serve/sharded.py``,
``serve/sharded_replica.py``, the controller's gang paths), the cluster
tier of ``tests/test_sharded_serving.py`` (its unit tier, against the
JAX package, is ``tests/test_torch_serve_sharded.py``).

One runtime: a ``num_hosts=2`` gang of ReplicaShard actors joined into a
gloo world serves the single-process replica's stream;
``GangRankKiller`` kills rank 1 at a fixed engine step, mid-decode of a
stream; the gang is retired whole and built anew, and the resumed
request returns exactly the missing suffix; after ``serve.delete`` the
gang's actors and its placement group are gone. The fleet's gang revival
attaches two pooled shells as one gang. A ``topology`` (a slice gang) is
refused naming A3c-2."""

import time

import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.models import TransformerConfig

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
REPLICA = dict(n_slots=2, max_len=64, prefill_chunk=4, prefill_budget=8,
               seed=0)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


@pytest.fixture(scope="module")
def world_of_one():
    """The in-process reference replica starts a gloo world of one rank
    in this process (``default_serving_mesh``); it goes with the
    module."""
    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runtime():
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    rt.init(num_cpus=8, object_store_memory=256 * 1024 * 1024,
            _system_config={"serve_reconcile_period_s": 0.25})
    yield rt
    serve.shutdown()
    rt.shutdown()


def _gang_rows(rt):
    from ray_tpu_torch.util import placement_group_table, state
    # a ReplicaShard is the actor with the peers' drain method
    actors = [a for a in state.list_actors()
              if "run_shard_drain" in a["method_names"]
              and a["state"] != "DEAD"]
    pgs = [p for p in placement_group_table() if p["state"] != "REMOVED"]
    return actors, pgs


def test_gang_kill_resume_and_teardown(world_of_one, runtime):
    """A num_hosts=2 gang's stream equals the single-process replica's
    (same seeded init on every rank); rank 1 SIGKILLs itself at its 19th
    engine step, mid-decode of the second stream; what arrived is a
    prefix; once the controller has retired the wedged gang and built
    another, the resumed request returns exactly the missing suffix; and
    serve.delete leaves no shard actor and no placement group."""
    rt = runtime
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.sharded import build_sharded_app
    from ray_tpu_torch.util.chaos import GangRankKiller
    # the first stream takes N - 1 = 15 engine steps (two prefill chunks
    # and the first decode in one step), so step 19 is the second
    # stream's 4th, after its first 4 tokens
    N = 16
    killer = GangRankKiller(at_call=19)
    cfg = TransformerConfig(**SHAPE, dtype=torch.float32)
    engine = dict(REPLICA, stream_coalesce_tokens=2, device="cpu")
    app = build_sharded_app(
        cfg, num_hosts=2, name="gang", deployment_kwargs={
            "ray_actor_options": {"num_cpus": 1, "runtime_env": {
                "env_vars": {killer.SPEC_ENV: killer.spec()}}}},
        **engine)
    from ray_tpu_torch.serve.sharded import ShardedEngineReplica
    single = ShardedEngineReplica(cfg, **engine)
    want = single.generate(PROMPT, max_new_tokens=N)

    handle = serve.run(app, name="gang", route_prefix=None)
    assert handle.generate.remote(PROMPT, max_new_tokens=N).result(
        timeout=120) == want
    actors, pgs = _gang_rows(rt)
    assert len(actors) == 2 and len(pgs) == 1

    got, err = [], None
    try:
        for tok in handle.options(stream=True).remote(PROMPT,
                                                      max_new_tokens=N):
            got.append(tok)
    except Exception as e:          # rank 1's death severs the stream
        err = e
    assert err is not None and 0 < len(got) < N, (err, got)
    assert got == want[:len(got)]

    deadline = time.monotonic() + 120
    res = None
    while time.monotonic() < deadline:
        try:
            res = handle.generate.remote(
                PROMPT, max_new_tokens=N,
                resume_tokens=got).result(timeout=60)
            break
        except Exception:
            time.sleep(0.5)
    assert res == want[len(got):]
    actors, pgs = _gang_rows(rt)
    assert len(actors) == 2 and len(pgs) == 1     # the gang built anew

    serve.delete("gang")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and any(_gang_rows(rt)):
        time.sleep(0.5)
    assert _gang_rows(rt) == ([], [])


def test_gang_revival_from_pooled_shells(world_of_one, runtime):
    """The fleet's gang revival: two pre-warmed ReplicaShell actors are
    checked out at once and attached CONCURRENTLY as the ranks of one
    gang (``FleetManager._attach_shard_gang``: ``checkout_many``,
    ``attach_shard`` with its rendezvous and lockstep warm-up, rank 0's
    peers set); the gang's rank 0 then serves the single-process
    replica's tokens, and a pool one shell short leaves the pool as it
    was."""
    import cloudpickle

    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.fleet import (FleetManager, ReplicaShell,
                                           ShellPool)
    from ray_tpu_torch.serve.sharded import ShardedEngineReplica
    cfg = TransformerConfig(**SHAPE, dtype=torch.float32)
    engine = dict(REPLICA, device="cpu")
    want = ShardedEngineReplica(cfg, **engine).generate(PROMPT,
                                                        max_new_tokens=8)
    shell_cls = rt.remote(ReplicaShell)
    fleet = FleetManager.__new__(FleetManager)
    fleet.pool = ShellPool(
        lambda: shell_cls.options(num_cpus=1, max_concurrency=8).remote(),
        size=2)
    fleet.pool.ensure()
    spec = {"name": "revived", "config": {"num_hosts": 2},
            "callable": cloudpickle.dumps(ShardedEngineReplica),
            "init_args": [cfg], "init_kwargs": engine,
            "is_function": False}
    assert fleet._attach_shard_gang(spec, 3) is None   # 2 idle < 3
    assert fleet.pool.idle() == 2
    rank0, group = fleet._attach_shard_gang(spec, 2)
    try:
        assert fleet.pool.idle() == 0 and len(group["members"]) == 2
        assert rt.get(rank0.handle_request.remote(
            "generate", (PROMPT,), {"max_new_tokens": 8}),
            timeout=120) == want
        stats = rt.get([m.run_shard.remote("stats", (), {})
                        for m in group["members"]], timeout=60)
        assert [(st["gang_rank"], st["gang_world"]) for st in stats] == \
            [(0, 2), (1, 2)]
        # the lockstep warm-up and the request ran on both ranks
        assert [st["requests_served"] for st in stats] == [2, 2]
    finally:
        from ray_tpu_torch.serve.sharded_replica import kill_group
        kill_group(group)


def test_topology_is_refused_naming_a3c2(runtime):
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.sharded import build_sharded_app
    app = build_sharded_app("llama-debug", num_hosts=2, topology="v4-16")
    with pytest.raises(NotImplementedError, match="A3c-2"):
        serve.run(app, name="slice", route_prefix=None)
