"""The port's elastic MPMD pipeline trainer (ray_tpu_torch/train/mpmd.py)
on the CPU, without JAX: the counterparts of the in-process tests of
tests/test_pipeline_elastic.py, on stages of one tanh layer (AdamW).

  - replay-buffer determinism, bounded eviction and gap detection
  - training under 1F1B and GPipe, program counts == 1
  - a stage killed mid-step (forward or backward) → park → restore →
    replay → BIT-IDENTICAL optimizer state against the uninterrupted
    run, program counts still 1
  - exhausted budget / job policy / missed park barrier → controlled
    degrade (PipelineDegradedError), never a hang
  - graceful migration on a preemption marker at a step boundary
  - stage shards saved and restored (and the async shard writer), the
    storage fallback of the restore ladder
  - interleaved virtual stages bit-identical to the plain pipeline,
    in-process stage gangs, async against sync checkpoints
  - config validation

The chaos-spec tests (StageKiller, `stage_step`) and the actor/gang
cluster tests wait for the runtime core (ROADMAP.md, Queue A item A3b).
"""

import os
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import pipeline as plib
from ray_tpu_torch.parallel.optim import adamw
from ray_tpu_torch.train import (AsyncShardWriter, FailureConfig,
                                 LocalStageHandle, MicrobatchReplayBuffer,
                                 MPMDConfig, MPMDPipelineTrainer,
                                 PipelineDegradedError, StageDefinition,
                                 restore_stage_shard, save_stage_shard)
from ray_tpu_torch.train.mpmd import _Now

D, MB, M, S = 8, 4, 4, 3
V4 = 4          # virtual stages for the interleaving tests


# ---------------------------------------------------------- replay buffer

def test_replay_buffer_bounded_oldest_first():
    buf = MicrobatchReplayBuffer(depth=2)
    for t in range(1, 5):
        buf.record(t, [np.full((2,), t)], [np.full((2,), -t)])
    assert buf.steps() == [3, 4]
    ins, tgts = buf.get(3)
    np.testing.assert_array_equal(ins[0], np.full((2,), 3))
    np.testing.assert_array_equal(tgts[0], np.full((2,), -3))
    with pytest.raises(KeyError):
        buf.get(2)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_replay_buffer_snapshots_inputs(kind):
    buf = MicrobatchReplayBuffer(depth=2)
    x = np.zeros((3,)) if kind == "numpy" else torch.zeros(3)
    buf.record(1, [x], [x])
    x[:] = 99.0                      # caller mutation after record
    ins, _ = buf.get(1)
    np.testing.assert_array_equal(ins[0], np.zeros((3,)))


def test_replay_buffer_gap_detection():
    buf = MicrobatchReplayBuffer(depth=2)
    buf.record(5, [np.zeros(1)], [np.zeros(1)])
    buf.record(6, [np.zeros(1)], [np.zeros(1)])
    assert buf.replayable_from(4) == [5, 6]
    assert buf.replayable_from(5) == [6]
    with pytest.raises(KeyError, match="gap"):
        buf.replayable_from(2)      # steps 3..4 already evicted


def test_replay_budget_reports_peak_buffers():
    """The replay buffer is sized against the peak WITH grad buffers, and
    budget() reports the composite microbatch-buffer number."""
    peaks = [plib.peak_live_activations(ops)
             for ops in plib.make_schedule("1f1b", 4, 8, virtual=2)]
    assert peaks == [13, 11, 9, 7]
    buf = MicrobatchReplayBuffer(depth=2, n_microbatches=8,
                                 peak_live_buffers=peaks)
    buf.record(1, [np.zeros((2, 2))] * 8, [np.zeros((2, 2))] * 8)
    b = buf.budget()
    assert b["replay_microbatches"] == 16
    assert b["peak_live_stage_buffers"] == 13
    assert b["peak_microbatch_buffers"] == 29
    assert b["bytes_held"] == 8 * 2 * (2 * 2 * 8)   # 16 float64 4-elt arrays


# ----------------------------------------------------------- local stages

def _tanh_stage(seed, last):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(D, D, generator=g) * 0.3,
              "b": torch.zeros(D)}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    loss_fn = None
    if last:
        def loss_fn(y, t):
            return torch.mean((y - t) ** 2)
    return StageDefinition(stage_fn=stage_fn, params=params,
                           optimizer=adamw(1e-2), loss_fn=loss_fn)


def _builder(stage_idx):
    return _tanh_stage(stage_idx, stage_idx == S - 1)


def _vbuilder(vs):
    """Builder for an n_virtual=4 pipeline: one tanh layer per virtual
    stage, loss on the deepest chunk."""
    return _tanh_stage(100 + vs, vs == V4 - 1)


def _data_fn(step):
    rng = np.random.RandomState(step)
    ins = [rng.randn(MB, D).astype(np.float32) for _ in range(M)]
    tgts = [rng.randn(MB, D).astype(np.float32) for _ in range(M)]
    return ins, tgts


def _trainer(max_failures=2, builders=None, gangs=None, marker_dir=None,
             **cfg_kw):
    cfg_kw.setdefault("n_microbatches", M)
    return MPMDPipelineTrainer(
        builders or [_builder] * S, MPMDConfig(**cfg_kw),
        FailureConfig(max_failures=max_failures, restart_policy="stage",
                      restart_backoff_s=0.0),
        stage_gang_sizes=gangs, marker_dir=marker_dir)


ONCE = {"fwd": 1, "bwd": 1, "apply": 1}


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_local_pipeline_trains_and_compiles_once(schedule):
    tr = _trainer(schedule=schedule)
    out = tr.fit(_data_fn, 5)
    assert out["steps"] == 5
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert tr.compile_counts() == [ONCE] * S
    # per-stage bubble + peak-live bookkeeping present
    assert out["peak_live_activations"] == (
        [min(S - s, M) + 1 for s in range(S)] if schedule == "1f1b"
        else [M] * S)
    assert 0.0 < out["bubble_fraction_analytic"] < 1.0
    assert "stage0_bubble_fraction" in out["history"][0]
    assert out["history"][0]["stage1_compute_s"] > 0.0


@pytest.mark.parametrize("stage,fail_at,steps,boundary", [
    (1, (4, "F"), 6, 2),          # a middle stage, mid-forward of step 4
    (2, (3, "B"), 4, 2),          # the last stage, in a backward
])
def test_stage_kill_recovers_bit_identical(stage, fail_at, steps, boundary):
    """The acceptance criterion: a stage killed mid-step recovers without
    restarting survivors, resumes within replay_depth + 1 steps, and
    post-replay optimizer state is bit-identical."""
    base = _trainer()
    base.fit(_data_fn, steps)
    tr = _trainer(replay_depth=2)
    tr.start()
    survivors = {s: h for s, h in enumerate(tr.handles) if s != stage}
    tr.handles[stage]._fail_at = fail_at
    out = tr.fit(_data_fn, steps)
    assert len(out["recoveries"]) == 1
    rec = out["recoveries"][0]
    assert rec["stages"] == [stage]
    assert rec["steps_lost"] <= tr.config.replay_depth + 1
    assert rec["boundary"] == boundary        # checkpoint_every=replay=2
    # survivors were never re-provisioned
    assert all(tr.handles[s] is h for s, h in survivors.items())
    # state parity with the uninterrupted run, bit for bit
    assert tr.state_digests() == base.state_digests()
    assert tr.compile_counts() == [ONCE] * S


def test_failure_budget_exhaustion_degrades():
    tr = _trainer(max_failures=1)
    tr.start()

    # every provisioned replacement for stage 1 dies immediately too
    def chaos_provision(idx, snapshot=None):
        h = tr._default_provision(idx, snapshot)
        if idx == 1:
            h._fail_at = (3, "F")
        return h
    tr._provision_fn = chaos_provision
    tr.handles[1]._fail_at = (3, "F")
    with pytest.raises(PipelineDegradedError, match="budget"):
        tr.fit(_data_fn, 6)


def test_job_policy_refuses_stage_recovery():
    tr = MPMDPipelineTrainer(
        [_builder] * S, MPMDConfig(n_microbatches=M),
        FailureConfig(max_failures=3, restart_policy="job"))
    tr.start()
    tr.handles[1]._fail_at = (1, "F")
    with pytest.raises(PipelineDegradedError, match="job"):
        tr.fit(_data_fn, 2)


def test_barrier_deadline_miss_degrades():
    """A survivor that cannot park within the deadline turns the recovery
    into a controlled job-level degrade instead of a hang."""
    tr = _trainer(barrier_deadline_s=0.2)

    class StuckHandle(LocalStageHandle):
        def abort_step(self, step):
            return _Now(error=TimeoutError("survivor wedged"))

    def provision(idx, snapshot=None):
        if idx == 0:
            return StuckHandle(idx, S, M, _builder, snapshot)
        return tr._default_provision(idx, snapshot)
    tr._provision_fn = provision
    tr.start()
    tr.handles[1]._fail_at = (1, "F")
    t0 = time.monotonic()
    with pytest.raises(PipelineDegradedError, match="barrier"):
        tr.fit(_data_fn, 2)
    assert time.monotonic() - t0 < 10.0


def test_preempt_notice_migrates_at_boundary(tmp_path):
    """The graceful path: a notice (marker file) migrates the stage at the
    next step boundary — no replay, no recovery entry, and the run's final
    state matches the unperturbed baseline bit for bit."""
    base = _trainer()
    base.fit(_data_fn, 4)

    tr = _trainer(marker_dir=str(tmp_path))
    tr.start()
    old = tr.handles[1]
    done = []

    def data_fn(step):
        if step == 3 and not done:
            done.append(1)
            open(tr.preempt_marker(1), "w").close()
        return _data_fn(step)

    out = tr.fit(data_fn, 4)
    assert tr.handles[1] is not old           # migrated
    assert old._dead                          # old host reaped
    assert out["recoveries"] == []            # no crash recovery
    assert not os.path.exists(tr.preempt_marker(1))   # notice cleared
    assert tr.state_digests() == base.state_digests()


# ------------------------------------------------- restore-source ladder

def test_stage_shard_save_restore_roundtrip(tmp_path):
    snap = {"step": 7, "stage": 1,
            "params": {"w": torch.arange(6, dtype=torch.float32),
                       "h": torch.ones(2, dtype=torch.bfloat16)},
            "opt_state": [{"step": torch.tensor(3.0), "m": torch.ones(3)},
                          {}]}
    save_stage_shard(str(tmp_path), 1, snap)
    assert os.path.exists(tmp_path / "stage_001" / "shard.pt")
    back = restore_stage_shard(f"file://{tmp_path}", 1)
    assert back["step"] == 7 and back["opt_state"][1] == {}
    torch.testing.assert_close(back["params"]["w"], snap["params"]["w"])
    assert back["params"]["h"].dtype == torch.bfloat16
    torch.testing.assert_close(back["opt_state"][0]["m"], torch.ones(3))


def test_async_shard_writer(tmp_path):
    """Submissions return at once, a newer one for a stage supersedes a
    queued older one, barrier() drains, and a failed write is raised at
    the barrier exactly once."""
    w = AsyncShardWriter()
    for step in range(3):
        w.submit(str(tmp_path), 0, {"step": step})
        w.submit(str(tmp_path), 1, {"step": 10 + step})
    assert w.barrier(timeout=30.0)
    assert restore_stage_shard(str(tmp_path), 0)["step"] == 2
    assert restore_stage_shard(str(tmp_path), 1)["step"] == 12
    assert 2 <= w.writes <= 6
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    w.submit(str(blocker), 0, {"step": 0})
    with pytest.raises(RuntimeError, match="stage-shard write failed"):
        w.barrier(timeout=30.0)
    assert w.barrier(timeout=30.0)            # raised once
    w.stop()
    w._thread.join(timeout=10.0)
    assert not w._thread.is_alive()


def test_recovery_falls_back_to_storage_shard(tmp_path):
    """Snapshot lost with the stage → the replacement restores from the
    durable storage shard instead."""
    base = _trainer()
    base.fit(_data_fn, 4)

    tr = _trainer(storage_path=str(tmp_path))
    tr.start()
    orig_ckpt = tr._checkpoint_all

    def ckpt_and_persist(step):
        orig_ckpt(step)
        for s in list(tr._snap_refs):
            save_stage_shard(str(tmp_path), s, tr._resolve_snap(s))
    tr._checkpoint_all = ckpt_and_persist
    ckpt_and_persist(0)
    tr.handles[1]._fail_at = (3, "F")
    # the in-memory snapshot dies with the stage
    orig_restore = tr._restore_source

    def restore(stage_idx):
        tr._snap_refs.pop(stage_idx, None)
        return orig_restore(stage_idx)
    tr._restore_source = restore
    tr.fit(_data_fn, 4)
    assert tr.recoveries
    assert tr.state_digests() == base.state_digests()


def test_no_restore_source_degrades():
    tr = _trainer()
    tr.start()
    tr.handles[1]._fail_at = (2, "F")
    tr._snap_refs.clear()
    with pytest.raises(PipelineDegradedError, match="restore source"):
        tr.fit(_data_fn, 3)


# ------------------------------------------- interleaved virtual stages

def test_interleaved_matches_plain_bit_identical():
    """v=2 over 2 hosts runs each chunk's F and B streams in strict
    microbatch order, so optimizer state is bit-identical to the SAME 4
    virtual stages spread plainly over 4 hosts — and every chunk still
    runs each program at one input shape."""
    plain = _trainer(builders=[_vbuilder] * V4, virtual_stages=1)
    out_p = plain.fit(_data_fn, 4)
    inter = _trainer(builders=[_vbuilder] * V4, virtual_stages=2)
    out_i = inter.fit(_data_fn, 4)
    assert plain.n_stages == 4 and inter.n_stages == 2
    assert inter.state_digests() == plain.state_digests()
    loss_p = [h["loss"] for h in out_p["history"] if "loss" in h]
    loss_i = [h["loss"] for h in out_i["history"] if "loss" in h]
    assert loss_i == loss_p
    assert inter.compile_counts() == [ONCE] * V4
    # interleaving shrinks the analytic bubble
    assert out_i["bubble_fraction_analytic"] < \
        out_p["bubble_fraction_analytic"]


def test_interleaved_kill_recovery_bit_identical():
    """A stage hosting TWO chunks dies mid-step: both chunks restore from
    the same boundary, replay in the interleaved order, and the final
    state matches the uninterrupted run bit for bit."""
    base = _trainer(builders=[_vbuilder] * V4, virtual_stages=2)
    base.fit(_data_fn, 6)

    tr = _trainer(builders=[_vbuilder] * V4, virtual_stages=2,
                  replay_depth=2)
    tr.start()
    tr.handles[1]._fail_at = (4, "F")          # chunks 1 and 3 die
    out = tr.fit(_data_fn, 6)
    assert len(out["recoveries"]) == 1
    assert tr.state_digests() == base.state_digests()
    assert tr.compile_counts() == [ONCE] * V4


# ------------------------------------------------------ in-process gangs

def test_local_gang_trains_and_matches_solo():
    """A 2-rank gang on stage 1 (two in-process members) is invisible to
    training: the solo run's digests, and both ranks ran the stage."""
    solo = _trainer()
    solo.fit(_data_fn, 4)
    gang = _trainer(gangs=[1, 2, 1])
    gang.fit(_data_fn, 4)
    h = gang.handles[1]
    assert len(h.members) == 2
    assert gang.state_digests() == solo.state_digests()
    for m in h.members:
        for rt in m._rts:
            assert rt.step == 4
            assert rt.compile_counts() == ONCE


def test_gang_rank_divergence_detected():
    """Digests are gathered from every rank and must agree bit for bit —
    a silently diverged rank raises."""
    tr = _trainer(gangs=[1, 2, 1])
    tr.fit(_data_fn, 2)
    rt = tr.handles[1].members[1]._rts[0]
    with torch.no_grad():
        rt.params["w"].add_(1.0)
    with pytest.raises(RuntimeError, match="diverged"):
        tr.state_digests()


# ---------------------------------------------- off-step snapshot parity

def test_async_checkpoint_parity():
    """Async off-step checkpointing is a pure performance knob: sync and
    async runs land bit-identical optimizer state, and the async run keeps
    its boundary snapshots UNRESOLVED (no step-path barrier). (The JAX
    test also turns off buffer donation; the port updates in place and
    has no such knob.)"""
    base = _trainer()
    base.fit(_data_fn, 5)
    assert all(hasattr(r, "result") for r in base._snap_refs.values())
    sync = _trainer(async_checkpoint=False)
    sync.fit(_data_fn, 5)
    assert not any(hasattr(r, "result") for r in sync._snap_refs.values())
    assert sync.state_digests() == base.state_digests()


def test_rollback_restores_state_and_counts():
    """A rollback puts parameters and optimizer state back to the last
    boundary exactly (the digest taken there)."""
    tr = _trainer()
    tr.fit(_data_fn, 2)                       # boundary at step 2
    at_boundary = tr.state_digests()
    tr._run_step(3, *_data_fn(3))             # moves the state
    assert tr.state_digests() != at_boundary
    for h in tr.handles:
        assert h.fetch(h.rollback()) == 2
    assert tr.state_digests() == at_boundary


# ----------------------------------------------------- config validation

def test_mpmd_config_validation():
    with pytest.raises(ValueError, match="checkpoint_every"):
        MPMDConfig(replay_depth=2, checkpoint_every=3).resolved()
    with pytest.raises(ValueError, match="n_microbatches"):
        MPMDConfig(n_microbatches=0).resolved()
    with pytest.raises(ValueError, match="1f1b"):
        MPMDConfig(schedule="gpipe", virtual_stages=2).resolved()
    c = MPMDConfig().resolved()
    assert c.checkpoint_every == c.replay_depth == 2
    assert (c.barrier_deadline_s, c.step_timeout_s) == (30.0, 300.0)


def test_failure_config_validation():
    with pytest.raises(ValueError, match="restart_policy"):
        FailureConfig(restart_policy="worker")
    with pytest.raises(ValueError, match="backoff"):
        FailureConfig(restart_backoff_s=-1.0)
    fc = FailureConfig(max_failures=2, restart_policy="stage")
    assert fc.restart_policy == "stage"


def test_trainer_requires_two_stages():
    with pytest.raises(ValueError, match="2 physical stages"):
        MPMDPipelineTrainer([_builder], MPMDConfig(n_microbatches=M))


def test_stage_definition_validation():
    with pytest.raises(ValueError, match="module= or stage_fn="):
        StageDefinition(optimizer=adamw(1e-3))
    with pytest.raises(ValueError, match="optimizer"):
        StageDefinition(module=torch.nn.Linear(2, 2))
    defn = StageDefinition(module=torch.nn.Linear(2, 2),
                           optimizer=adamw(1e-3))
    assert sorted(defn.params) == ["bias", "weight"]


# ------------------------------------------------- decoder block stages

def test_block_stage_builders_cut_the_model():
    """block_stage_builders cuts a model's blocks into stages: the stages
    one after another equal one BlockStage over every block, the last
    stage's loss is the chunked cross-entropy against the unembedding,
    and a build copies the weights (training a stage leaves the model's
    state_dict as it was)."""
    import dataclasses

    from ray_tpu_torch.models import (MODEL_REGISTRY, BlockStage,
                                      init_params, stage_state_dict)
    from ray_tpu_torch.parallel import chunked_cross_entropy
    from ray_tpu_torch.train import block_stage_builders
    cfg = dataclasses.replace(MODEL_REGISTRY["llama-debug"], n_layers=4,
                              dtype=torch.float32)
    weights = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                          dtype=torch.float32)
    before = {k: v.clone() for k, v in weights.items()}
    defs = [b(vs) for vs, b in enumerate(
        block_stage_builders(cfg, weights, 2, adamw(1e-3), loss_chunk=8))]
    whole = BlockStage(cfg, 4, device="cpu")
    whole.load_state_dict(stage_state_dict(weights, 0, 4))
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    t = torch.randint(0, cfg.vocab_size, (2, 16))
    with torch.no_grad():
        y = defs[1].module(defs[0].module(x))
        torch.testing.assert_close(y, whole(x), rtol=0, atol=0)
        assert defs[0].loss_fn is None
        torch.testing.assert_close(
            defs[1].loss_fn(y, t),
            chunked_cross_entropy(y, weights["unembed"], t, chunk=8)[0])
    tr = MPMDPipelineTrainer(
        block_stage_builders(cfg, weights, 2, adamw(1e-2), loss_chunk=8),
        MPMDConfig(n_microbatches=2))
    tr.fit(lambda step: ([x[:1], x[1:]], [t[:1], t[1:]]), 2)
    assert tr.compile_counts() == [ONCE] * 2
    assert all(torch.equal(before[k], weights[k]) for k in weights)
    with pytest.raises(ValueError, match="do not cut"):
        block_stage_builders(cfg, weights, 3, adamw(1e-3))


def test_storage_uris(tmp_path):
    """The shard store's URIs: plain paths and both file: forms are local;
    another scheme joins with '/' (and would go through fsspec)."""
    from ray_tpu_torch.util import storage
    path = str(tmp_path / "a" / "b.bin")
    for i, uri in enumerate((path, f"file://{path}", f"file:{path}")):
        storage.write_bytes(uri, b"xyz%d" % i)
        assert storage.read_bytes(uri) == b"xyz%d" % i
        assert open(path, "rb").read() == b"xyz%d" % i
    assert os.listdir(tmp_path / "a") == ["b.bin"]     # no temporary left
    assert storage.join("gs://bucket/ckpt/", "/stage_001", "shard.pt") == \
        "gs://bucket/ckpt/stage_001/shard.pt"
    assert storage.is_remote("memory://x") and not storage.is_remote(path)
