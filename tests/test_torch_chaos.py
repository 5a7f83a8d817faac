"""The port's chaos hooks against the JAX package's (``util/chaos.py``):
each of the eight killers this slice ports has JAX's spec string and
JAX's environment variable under the port's ``RAY_TPU_TORCH_`` prefix,
and fires at its injection point in the port:

- ``NodeKiller``: kills the victims JAX's picks from the same seed, never
  a protected node;
- ``ShmSpanCreateKiller``: a process dies inside its spanning create and
  the arena repairs the whole span;
- ``BroadcastRelayKiller``: an interior push of a broadcast tree fails,
  a leaf push is untouched;
- ``PeerExportKiller``: the exporting decode replica fails, and the
  importing one lands on local prefill with the tokens of an unshared
  replica;
- ``ShellAttachKiller``: a shell's attach fails before and after the
  callable is built, and the shell stays unattached;
- ``GangRankKiller``: a non-zero rank SIGKILLs itself at its step;
- ``GcsRpcDelayer``: the armed GCS handler is delayed, the others not;
- ``QuotaLeaseRevoker``: the revoked proxy degrades, the survivor's share
  stays frozen (no over-admission), and the victim re-leases."""

import asyncio
import multiprocessing
import os
import signal
import time

import pytest
import torch

import ray_tpu.util.chaos as jax_chaos
import ray_tpu_torch.util.chaos as chaos

RPC_ENV = "RAY_TPU_TORCH_TESTING_RPC_FAILURE"


def _port_env(name: str) -> str:
    return name.replace("RAY_TPU_", "RAY_TPU_TORCH_", 1)


@pytest.mark.parametrize("name,args", [
    ("ShmSpanCreateKiller", (3,)), ("BroadcastRelayKiller", (0.5,)),
    ("PeerExportKiller", (1.0,)), ("ShellAttachKiller", (0.25,)),
    ("GangRankKiller", (1.0,)), ("GcsRpcDelayer", ("kv_get", 75.0))])
def test_spec_and_env_equal_jax(name, args):
    port, ref = getattr(chaos, name)(*args), getattr(jax_chaos, name)(*args)
    assert port.spec() == ref.spec()
    assert port.SPEC_ENV == _port_env(ref.SPEC_ENV)
    base = {"A": "1"}
    if hasattr(ref, "arm_local") and name != "GcsRpcDelayer":
        # the RPC specs compose onto what the env already holds
        base[port.SPEC_ENV] = "x=0.5"
        want = {k.replace(ref.SPEC_ENV, port.SPEC_ENV): v for k, v in
                ref.env({"A": "1", ref.SPEC_ENV: "x=0.5"}).items()}
        assert port.env(base) == want
    else:
        assert port.env(base)[port.SPEC_ENV] == ref.spec()


@pytest.mark.parametrize("name", ["BroadcastRelayKiller", "PeerExportKiller",
                                  "ShellAttachKiller", "GangRankKiller"])
def test_probability_bounds_as_jax(name):
    for p in (0.0, 1.5):
        with pytest.raises(ValueError):
            getattr(jax_chaos, name)(p)
        with pytest.raises(ValueError):
            getattr(chaos, name)(p)


class _Node:
    def __init__(self, node_id, log):
        self.node_id, self._log = node_id, log

    def kill(self):
        self._log.append(self.node_id)


class _Cluster:
    def __init__(self, n):
        self.killed = []
        self.nodes = [_Node(f"n{i}", self.killed) for i in range(n)]


def test_node_killer_kills_what_jax_kills():
    picks = []
    for mod in (jax_chaos, chaos):
        cluster = _Cluster(5)
        killer = mod.NodeKiller(cluster, interval_s=0.01,
                                protected_node_ids=["n0"], max_kills=3,
                                seed=4).start()
        deadline = time.monotonic() + 10
        while len(killer.killed) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        killer.stop()
        assert killer.killed == cluster.killed and "n0" not in cluster.killed
        assert len(set(cluster.killed)) == 3
        picks.append(cluster.killed)
    assert picks[0] == picks[1]


def _span_victim(path, spec):
    # armed before the first native create: the spec is parsed once
    os.environ[chaos.ShmSpanCreateKiller.SPEC_ENV] = spec
    from ray_tpu_torch._private.object_store import ObjectStoreClient
    c = ObjectStoreClient(path)
    try:
        c.create_spanning((8_500_000).to_bytes(20, "big"),
                          20 * 1024 * 1024, 0)
    except Exception:
        pass
    os._exit(3)   # survived: the injection never fired


def test_shm_span_create_killer_fires_mid_span():
    from ray_tpu_torch._private.object_store import ObjectStoreClient
    path = "/dev/shm/raytpu_torch_test_span_chaos_%d" % os.getpid()
    s = ObjectStoreClient(path, create=True, size=64 * 1024 * 1024,
                          stripes=4)
    try:
        killer = chaos.ShmSpanCreateKiller(nth_create=1)
        victim = multiprocessing.get_context("spawn").Process(
            target=_span_victim, args=(s.path, killer.spec()))
        victim.start()
        killer.assert_killed(victim)
        s.stats()                            # runs the repair
        blob = b"\x5a" * (20 * 1024 * 1024)  # the whole span is free again
        key = (8_600_000).to_bytes(20, "big")
        assert s.put_bytes(key, blob) and s.is_span(key)
        assert s.span_stats()["stripes_claimed"] == 2
    finally:
        s.close()
        os.unlink(path)


def _arm(killer):
    killer.arm_local()
    return killer


def test_broadcast_relay_killer_fails_interior_pushes_only():
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.node_manager import NodeManager

    class _Store:
        def get(self, oid):
            return None
    nm = NodeManager.__new__(NodeManager)
    nm.store, nm.spilled = _Store(), {}
    killer = chaos.BroadcastRelayKiller(1.0)
    os.environ[killer.SPEC_ENV] = killer.spec()
    rpc._CHAOS_SPEC = None
    try:
        with pytest.raises(rpc.RpcError, match="relay_push"):
            asyncio.run(nm.h_request_push(None, b"o" * 20, "node-b",
                                          relay=["node-c"], bcast=True))
        # a leaf push passes the hook and fails on the missing object
        with pytest.raises(RuntimeError, match="not on this node"):
            asyncio.run(nm.h_request_push(None, b"o" * 20, "node-b"))
    finally:
        os.environ.pop(killer.SPEC_ENV, None)
        rpc._CHAOS_SPEC = None


TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128)
TIER = dict(n_slots=2, max_len=64, prefill_chunk=4, prefill_budget=8,
            device="cpu")
PROMPT = list(range(50, 67))                 # 17 tokens: 4 full chunks


def test_peer_export_killer_lands_on_local_prefill():
    from ray_tpu_torch.inference import LLMDeployment
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.serve.disagg import DisaggLLMDeployment
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def dep(**kw):
        return DisaggLLMDeployment(cfg, **TIER, prefix_cache_slots=2,
                                   params_fn=lambda: params,
                                   weights_key=None, **kw)
    oracle = LLMDeployment(cfg, **TIER, prefix_cache_slots=0,
                           params_fn=lambda: params, weights_key=None)
    a = dep()
    b = dep(peers={"A": a}, summaries_fn=lambda: [
        {"replica_id": "A", **a.engine.prefix_cache.summary()}])
    killer = chaos.PeerExportKiller(1.0)
    try:
        want = oracle.generate(PROMPT, max_new_tokens=8)
        a.generate(PROMPT, max_new_tokens=2)     # the peer holds the prefix
        _arm(killer)
        with pytest.raises(Exception, match="peer_export"):
            a.peer_export(PROMPT)                # the injection fires
        tried, export = [], a.peer_export

        def counted(*args, **kw):
            tried.append(1)
            return export(*args, **kw)
        a.peer_export = counted
        assert b.generate(PROMPT, max_new_tokens=8) == want
        assert tried                             # B asked A, A failed
        assert b.engine.kv_imports == 0          # local prefill, once
        assert b.engine.sched.queue_depth() == 0
    finally:
        killer.disarm_local()
        for d in (oracle, a, b):
            d.engine.stop()


BUILT = []


class _Counted:
    def __init__(self):
        BUILT.append(1)

    def __call__(self, x):
        return x


def test_shell_attach_killer_fires_at_both_points():
    import cloudpickle

    from ray_tpu_torch._private import rpc
    from ray_tpu_torch.serve.fleet import ReplicaShell
    blob = cloudpickle.dumps(_Counted)
    for at, built in ((1, 0), (2, 1)):
        del BUILT[:]
        shell = ReplicaShell()
        os.environ[RPC_ENV] = f"shell_attach=#{at}"
        rpc._CHAOS_SPEC = None
        try:
            with pytest.raises(rpc.RpcError, match="shell_attach"):
                shell.attach(blob, (), {}, False)
        finally:
            chaos.ShellAttachKiller.disarm_local()
        # before the callable (check 1) or after it (check 2): the shell
        # never reports attached
        assert len(BUILT) == built and not shell._attached
    shell = ReplicaShell()
    assert shell.attach(blob, (), {}, False) and shell._attached


def test_gang_rank_killer_kills_nonzero_ranks(monkeypatch):
    from ray_tpu_torch.serve.sharded import ShardedEngineReplica
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    rank = ShardedEngineReplica.__new__(ShardedEngineReplica)
    killer = _arm(chaos.GangRankKiller(at_call=2))
    try:
        for r in (0, 1, 1):
            rank._rank = r
            rank._maybe_chaos_kill()
    finally:
        killer.disarm_local()
    # rank 0 never checks; rank 1's second check is the kill
    assert kills == [signal.SIGKILL]


def test_gcs_rpc_delayer_delays_the_armed_handler():
    from ray_tpu_torch._private import gcs_obs

    class _Gcs:
        pass
    obs = gcs_obs.GcsObservability(_Gcs())
    calls = obs.wrap_handlers({"kv_get": lambda conn, x: x + 1,
                               "kv_put": lambda conn, x: x - 1})
    delayer = chaos.GcsRpcDelayer("kv_get", 80.0)
    delayer.arm_local()
    try:
        assert gcs_obs.delay_for("kv_get") == 80.0
        assert gcs_obs.delay_for("kv_put") == 0.0
        assert calls["kv_put"](None, x=5) == 4        # inline, undelayed

        async def timed():
            t0 = time.perf_counter()
            out = await calls["kv_get"](None, x=5)
            return out, time.perf_counter() - t0
        out, took = asyncio.run(timed())
        assert out == 6 and took >= 0.08
    finally:
        delayer.disarm_local()
    assert gcs_obs.delay_for("kv_get") == 0.0
    assert obs.handlers["kv_get"].calls == 1


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def test_quota_lease_revoker_no_over_admission():
    """JAX's round trip on the port's GCS lease handlers: after the
    revocation the victim admits at the conservative fraction of its
    share and the survivor's share stays frozen (the escrow), so the two
    admit strictly under the cluster rate; then the victim re-leases."""
    from ray_tpu_torch._private.config import cfg
    from ray_tpu_torch._private.gcs import GcsServer
    from ray_tpu_torch.serve.fleet import QuotaLeaseClient
    g = GcsServer.__new__(GcsServer)
    g.tenant_quotas, g.quota_leases = {}, {}
    g.quota_lease_epoch, g.tenant_burn = 1, {}

    def call(method, **kw):
        return getattr(g, "h_" + method)(None, **kw)
    cfg.set("quota_lease_interval_s", 0.0)
    try:
        g.h_set_tenant_quota(None, "hot", rate=10.0, burst=10.0)
        clk = _Clock()
        clients = {p: QuotaLeaseClient(p, call, clock=clk)
                   for p in ("p1", "p2")}
        for c in clients.values():
            assert c.acquire()
        clk.t += 0.01
        for c in clients.values():
            c.maybe_renew(clk())             # both adopt the 2-way split
        rev = chaos.QuotaLeaseRevoker(call, seed=7)
        assert sorted(rev.lease_ids()) == ["p1", "p2"]
        # JAX's revoker over the same lease table picks the same victim
        table = g.h_quota_lease_status(None)
        ref = jax_chaos.QuotaLeaseRevoker(
            lambda method, **kw: table if method == "quota_lease_status"
            else True, seed=7)
        pid = rev.revoke_one()
        assert pid == ref.revoke_one() and pid in clients
        assert rev.revoked == [pid]
        victim = clients[pid]
        survivor = clients[{"p1": "p2", "p2": "p1"}[pid]]

        def poke():
            clk.t += 0.01
            victim.maybe_renew(clk())
            survivor.maybe_renew(clk())
        assert rev.wait_for_degraded(victim, timeout_s=5.0, poke=poke)
        frac = cfg.quota_lease_conservative_frac
        assert victim.stats()["rates"]["hot"] == pytest.approx(5.0 * frac)
        assert survivor.stats()["rates"]["hot"] == pytest.approx(5.0)
        assert (victim.stats()["rates"]["hot"]
                + survivor.stats()["rates"]["hot"]) < 10.0
        assert rev.wait_for_release(victim, timeout_s=5.0, poke=poke)
        assert victim.stats()["rates"]["hot"] == pytest.approx(5.0)
    finally:
        cfg.reset("quota_lease_interval_s")
