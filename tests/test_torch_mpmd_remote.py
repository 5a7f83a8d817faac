"""The MPMD pipeline trainer's actor transport (ray_tpu_torch/train/mpmd.py,
``remote=True``: ``PipelineStageActor`` stages in worker processes of the
port's runtime) on the CPU, held to the in-process trainer, which
tests/test_torch_mpmd.py holds to the JAX package's per-step losses:

- llama-debug block stages whose weights ride the object store: each
  step's loss and the final state digests bitwise equal to the
  in-process trainer, every stage program at one input shape, the
  flash-kernel launches summed from the actors (0 on the CPU), one
  process per stage;
- a gang of 2 actors on a stage without a ``topology`` (with one it
  raises NotImplementedError): the solo run's digests;
- the counterparts of tests/test_pipeline_elastic.py:365 (the
  ``stage_step`` chaos spec degrades in a controlled way; in process, as
  there), :383 (stage actors armed with the spec SIGKILL themselves at
  their first forward, their replacements come up clean: the pipeline
  recovers, to the uninterrupted run's bits) and :665 (an actor killed
  in step 3 is replayed to the same bits), and a stage actor killed at
  fixed points twice, so that the survivors take both ways back to a
  boundary (their own snapshot, and the last sealed one when a stage
  died before sealing its own).
"""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.config import cfg
from ray_tpu_torch.train import (ActorStageHandle, FailureConfig,
                                 GangStageHandle, MPMDConfig,
                                 MPMDPipelineTrainer, PipelineDegradedError)
from ray_tpu_torch.util.chaos import StageKiller
from tests import torch_runtime_cases as cases

ONCE = {"fwd": 1, "bwd": 1, "apply": 1}
WARM_WORKERS = 16


@pytest.fixture(scope="module")
def cluster():
    ctx = rt.init(num_cpus=WARM_WORKERS,
                  object_store_memory=128 * 1024 * 1024)
    try:
        warm = rt.remote(cases.warm)
        rt.get([warm.remote() for _ in range(WARM_WORKERS)], timeout=120)
        # the warm workers return to the node manager's pool, where the
        # stage actors adopt them, once their leases have sat idle
        time.sleep(cfg.lease_idle_timeout_s + 0.5)
        yield ctx
    finally:
        rt.shutdown()


def _trainer(builders, remote, max_failures=2, **kw):
    return MPMDPipelineTrainer(
        builders, MPMDConfig(n_microbatches=cases.M),
        FailureConfig(max_failures=max_failures, restart_policy="stage",
                      restart_backoff_s=0.0),
        remote=remote, **kw)


@pytest.fixture(scope="module")
def tanh_base():
    tr = _trainer([cases.tanh_stage] * cases.S, remote=False)
    tr.fit(cases.tanh_data, 5)
    return tr.state_digests()


def test_remote_llama_blocks_bitwise_equal_in_process(cluster):
    cfg = cases.llama_config()
    weights = cases.llama_weights(cfg)
    data = cases.llama_data(cfg, weights, 3)
    local = _trainer(cases.llama_builders(cfg, weights), remote=False)
    want = local.fit(data, 3)
    remote = _trainer(cases.llama_builders(cfg, rt.put(weights)),
                      remote=True)
    try:
        got = remote.fit(data, 3)
        assert [h["loss"] for h in got["history"]] == \
            [h["loss"] for h in want["history"]]
        assert remote.state_digests() == local.state_digests()
        assert remote.compile_counts() == [ONCE] * cases.S
        zeros = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0}
        assert [h["launches"] for h in got["history"]] == [zeros] * 3
        assert "launches" not in want["history"][0]
        pids = {m["pid"] for m in remote.memory_stats()}
        assert len(pids) == cases.S and os.getpid() not in pids
    finally:
        remote.shutdown()


def test_remote_gang_of_two_matches_solo(cluster, tanh_base):
    """Synchronous checkpoints here (the gang's snapshot is rank 0's
    ref either way)."""
    tr = MPMDPipelineTrainer(
        [cases.tanh_stage] * cases.S,
        MPMDConfig(n_microbatches=cases.M, async_checkpoint=False),
        FailureConfig(max_failures=2, restart_policy="stage",
                      restart_backoff_s=0.0),
        remote=True, stage_gang_sizes=[1, 2])
    try:
        tr.fit(cases.tanh_data, 5)
        h = tr.handles[1]
        assert isinstance(h, GangStageHandle)
        assert all(isinstance(m, ActorStageHandle) for m in h.members)
        assert len(h.members) == 2
        assert len({m["pid"] for m in tr.memory_stats()}) == 3
        assert tr.state_digests() == tanh_base
    finally:
        tr.shutdown()
    with pytest.raises(NotImplementedError, match="A3c"):
        GangStageHandle.provision(0, 2, cases.M, [(0, cases.tanh_stage)],
                                  gang_size=2, topology="v5e-8")


def _armed(tr, envs):
    """provision_fn: the nth provision of stage s gets ``envs[s][n]``
    (a chaos spec) in its actor's environment, or none."""
    made = {}

    def provision(idx, snapshot=None):
        made[idx] = made.get(idx, 0) + 1
        env = envs[idx].get(made[idx], {})
        chunks = [(vs, tr.builders[vs]) for vs in tr._chunk_indices(idx)]
        return ActorStageHandle.provision(
            idx, tr.n_virtual, tr.config.n_microbatches, None, snapshot,
            chunk_builders=chunks,
            extra_options={"runtime_env": {"env_vars": env}})
    return provision


def test_stage_killer_chaos_spec_degrades_controlled():
    """stage_step=1.0 (in process, as the JAX package's test runs it):
    every (re)provisioned stage dies at its first forward, recovery burns
    the budget and ends in PipelineDegradedError — the controlled
    degrade, not a hang or an unhandled crash."""
    killer = StageKiller(probability=1.0)
    assert killer.spec() == "stage_step=1.0"
    assert killer.env({})[StageKiller.SPEC_ENV] == "stage_step=1.0"
    tr = _trainer([cases.tanh_stage] * cases.S, remote=False,
                  max_failures=2)
    tr.start()                       # provision BEFORE arming
    killer.arm_local()
    try:
        with pytest.raises(PipelineDegradedError, match="budget"):
            tr.fit(cases.tanh_data, 3)
    finally:
        StageKiller.disarm_local()


def test_stage_killer_single_shot_recovers(cluster, tanh_base):
    """The first actor of each stage is armed, its replacement comes up
    clean (the 'node came back clean' shape): the pipeline recovers and
    finishes training at the uninterrupted run's bits."""
    killer = StageKiller(probability=1.0)
    tr = _trainer([cases.tanh_stage] * cases.S, remote=True, max_failures=3)
    tr._provision_fn = _armed(tr, [{1: killer.env({})}] * cases.S)
    try:
        out = tr.fit(cases.tanh_data, 5)
        assert out["recoveries"], "chaos never fired"
        assert sorted({s for r in out["recoveries"]
                       for s in r["stages"]}) == [0, 1]
        assert out["steps"] == 5
        assert tr.state_digests() == tanh_base
    finally:
        tr.shutdown()


def test_actor_stage_kill_bit_identical(cluster, tanh_base):
    """Stage 1's actor is SIGKILLed (ray_tpu_torch.kill) in step 3, after
    the controller took the step's data and before its ops reach the
    stage (a step of these stages is too short to aim inside); recovery
    restores it from its snapshot in the object store and replays, and
    the final state equals the uninterrupted run's."""
    tr = _trainer([cases.tanh_stage] * cases.S, remote=True)
    tr.start()
    killed = []

    def data_fn(step):
        if step == 3 and not killed:
            killed.append(1)
            rt.kill(tr.handles[1].actor)
        return cases.tanh_data(step)

    try:
        out = tr.fit(data_fn, 5)
        assert out["recoveries"], "kill never surfaced as a stage loss"
        assert out["recoveries"][0]["steps_lost"] <= \
            tr.config.replay_depth + 1
        assert tr.state_digests() == tanh_base
        assert tr.compile_counts() == [ONCE] * cases.S
    finally:
        tr.shutdown()


def test_unsealed_boundary_restores_the_last_confirmed_one(cluster,
                                                           tanh_base):
    """Synchronous checkpoints at every step, and stage 1's actor armed
    to die twice at fixed points: in step 2 at its 3rd op (``stage_step``
    at check 11), with the step-1 boundary sealed, so the survivor rolls
    back to its own snapshot; then its replacement when the controller
    asks for its step-2 snapshot (``stage_seal`` at check 1), so that
    boundary is never sealed and in step 3 the survivor, whose own
    snapshot is newer, is restored to the step-1 one. Both replays end at
    the uninterrupted run's bits."""
    tr = MPMDPipelineTrainer(
        [cases.tanh_stage] * cases.S,
        MPMDConfig(n_microbatches=cases.M, checkpoint_every=1,
                   async_checkpoint=False),
        FailureConfig(max_failures=2, restart_policy="stage",
                      restart_backoff_s=0.0), remote=True)
    tr._provision_fn = _armed(tr, [
        {}, {1: StageKiller(at_call=11).env({}),
             2: StageKiller(at_call=1, channel="stage_seal").env({})}])
    try:
        out = tr.fit(cases.tanh_data, 5)
        assert [(r["step"], r["stages"], r["boundary"],
                 r["survivors_restored"], r["replayed_steps"])
                for r in out["recoveries"]] == [
            (2, [1], 1, False, [2]), (3, [1], 1, True, [2, 3])]
        assert tr.state_digests() == tanh_base
    finally:
        tr.shutdown()
