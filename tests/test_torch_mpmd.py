"""The port's MPMD pipeline trainer (ray_tpu_torch/train/mpmd.py) against
the JAX package's (ray_tpu/train/mpmd.py), in process, on the same
weights and data: each step's loss and the final parameters.

- 4 MLP stages (tanh layers, AdamW(1e-2), MSE loss), M=4, under 1F1B,
  GPipe and interleaved 1F1B (v=2: the 4 stages as 2 chunks on each of
  2 hosts);
- llama-debug blocks in fp32 with AdamW(1e-3), the embedding outside the
  stages and the last stage's loss the cross-entropy against the
  embedding table (``__graft_entry__.py:_dryrun_mpmd``): 2 stages of one
  block under 1F1B and GPipe (interleaving needs at least 4 virtual
  stages; ``chip_smoke.py`` phase 13 (c) holds interleaved tpu-3b block
  stages to the plain pipeline, bit for bit).

The JAX trainer runs once per pipeline (1F1B over the plain stages): every
schedule accumulates each stage's gradients in microbatch order, so the
JAX package's GPipe and interleaved runs land the same bits (its own tests
hold interleaved bit-identical to plain); the port's three schedules are
held bit-identical to each other here as well. The bounds are fp32's:
each loss within rtol 1e-5, and each parameter after the last step within
a relative L2 distance of 1e-4, the bound the port's other training tests
hold parameters to (``tests/torch_mesh_cases.py:assert_same_training``:
Adam's update of an entry whose gradient is ~0 turns fp32 summation-order
noise into steps of up to the learning rate; a block's ``mlp.down`` lands
1.06e-5 from JAX's after 3 steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import MODEL_REGISTRY
from ray_tpu.models.transformer import Block, unpartitioned_params
from ray_tpu.train import mpmd as jmpmd
from ray_tpu.train.config import FailureConfig as JFailureConfig
from ray_tpu_torch.models import BlockStage, block_params_from_jax
from ray_tpu_torch.parallel.optim import adamw
from ray_tpu_torch.train import (FailureConfig, MPMDConfig,
                                 MPMDPipelineTrainer, StageDefinition)
from tests.torch_mesh_cases import config
from tests.torch_pipeline_cases import jax_block_tree

M, MB, D, STEPS = 4, 4, 8, 3
N_MB, BLOCK_MB, L = 4, 2, 16
LOSS_RTOL, PARAM_REL_L2 = 1e-5, 1e-4
SCHEDULES = {"1f1b": dict(schedule="1f1b"), "gpipe": dict(schedule="gpipe"),
             "interleaved": dict(schedule="1f1b", virtual_stages=2)}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_fit(builders, data_fn):
    tr = jmpmd.MPMDPipelineTrainer(
        builders, jmpmd.MPMDConfig(n_microbatches=N_MB),
        JFailureConfig(max_failures=0, restart_policy="stage",
                       restart_backoff_s=0.0))
    out = tr.fit(data_fn, STEPS)
    params = [jax.tree.map(np.asarray, rt.params)
              for h in tr.handles for rt in h._rts]
    return [h["loss"] for h in out["history"]], params


def _port_fit(builders, data_fn, kind):
    tr = MPMDPipelineTrainer(
        builders, MPMDConfig(n_microbatches=N_MB, **SCHEDULES[kind]),
        FailureConfig(max_failures=0, restart_policy="stage"))
    out = tr.fit(data_fn, STEPS)
    assert tr.compile_counts() == [{"fwd": 1, "bwd": 1, "apply": 1}] * \
        len(builders)
    # virtual-stage order: chunk c of host s is virtual stage c*S + s
    rts = sorted((rt for h in tr.handles for rt in h._rts),
                 key=lambda rt: rt.stage_idx)
    params = [{n: p.detach().clone() for n, p in rt.params.items()}
              for rt in rts]
    return [h["loss"] for h in out["history"]], params, tr.state_digests()


def _check(port, jax_losses, jax_params, to_port):
    losses, params, _ = port
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL, atol=0)
    assert len(params) == len(jax_params)
    for got, want in zip(params, jax_params):
        want = to_port(want)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            rel = _rel_l2(got[name].numpy(), w)
            assert rel < PARAM_REL_L2, (name, rel)


# ------------------------------------------------------------------ MLP

def _mlp_weights(stage):
    rng = np.random.RandomState(100 + stage)
    return {"w": (rng.randn(D, D) * 0.3).astype(np.float32),
            "b": np.zeros(D, np.float32)}


def _mlp_data(step):
    rng = np.random.RandomState(step)
    return ([rng.randn(MB, D).astype(np.float32) for _ in range(N_MB)],
            [rng.randn(MB, D).astype(np.float32) for _ in range(N_MB)])


def _jax_mlp_builder(vs):
    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])
    loss_fn = None
    if vs == 3:
        def loss_fn(y, t):
            return jnp.mean((y - t) ** 2)
    return jmpmd.StageDefinition(
        stage_fn=stage_fn, params=jax.tree.map(jnp.asarray,
                                               _mlp_weights(vs)),
        optimizer=optax.adamw(1e-2), loss_fn=loss_fn)


def _port_mlp_builder(vs):
    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    loss_fn = None
    if vs == 3:
        def loss_fn(y, t):
            return torch.mean((y - t) ** 2)
    return StageDefinition(
        stage_fn=stage_fn, params={k: torch.from_numpy(v) for k, v in
                                   _mlp_weights(vs).items()},
        optimizer=adamw(1e-2), loss_fn=loss_fn)


@pytest.fixture(scope="module")
def mlp_runs():
    want = _jax_fit([_jax_mlp_builder] * 4, _mlp_data)
    got = {kind: _port_fit([_port_mlp_builder] * 4, _mlp_data, kind)
           for kind in SCHEDULES}
    return got, want


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_mlp_stages_match_jax(mlp_runs, kind):
    got, (losses, params) = mlp_runs
    _check(got[kind], losses, params, lambda p: p)
    assert got[kind][2] == got["1f1b"][2]     # the same bits as 1F1B


# ------------------------------------------------------ llama-debug blocks

def _jax_cfg():
    return dataclasses.replace(MODEL_REGISTRY["llama-debug"],
                               dtype=jnp.float32, param_dtype=jnp.float32,
                               scan_layers=False, remat=False)


@pytest.fixture(scope="module")
def block_setup():
    cfg = _jax_cfg()
    rng = np.random.RandomState(3)
    weights = [jax_block_tree(rng, cfg) for _ in range(2)]
    embed = (np.random.RandomState(9).randn(cfg.vocab_size, cfg.d_model)
             * 0.02).astype(np.float32)

    def data_fn(step):
        rng = np.random.RandomState(step)
        toks = rng.randint(0, cfg.vocab_size, size=(N_MB, BLOCK_MB, L + 1))
        return ([embed[toks[m, :, :-1]] for m in range(N_MB)],
                [toks[m, :, 1:].astype(np.int64) for m in range(N_MB)])
    return weights, embed, data_fn


def _jax_block_builders(weights, embed, n):
    cfg = _jax_cfg()
    positions = jnp.broadcast_to(jnp.arange(L)[None, :], (BLOCK_MB, L))

    def builder(vs):
        block = Block(cfg)

        def stage_fn(p, x):
            with unpartitioned_params():
                out, _aux = block.apply({"params": p}, x, positions)
            return out

        loss_fn = None
        if vs == n - 1:
            def loss_fn(y, tgt):
                logits = jnp.einsum("bld,vd->blv", y, jnp.asarray(embed))
                logz = jax.nn.logsumexp(logits, -1)
                gold = jnp.take_along_axis(
                    logits, tgt[..., None], -1)[..., 0]
                return (logz - gold).mean()
        return jmpmd.StageDefinition(
            stage_fn=stage_fn, params=jax.tree.map(jnp.asarray, weights[vs]),
            optimizer=optax.adamw(1e-3), loss_fn=loss_fn)
    return [builder] * n


def _port_block_builders(weights, embed, n):
    cfg = config("llama-debug")
    table = torch.from_numpy(embed)

    def builder(vs):
        stage = BlockStage(cfg, 1, device="cpu")
        stage.load_state_dict({f"layers.0.{k}": v for k, v in
                               block_params_from_jax(weights[vs]).items()})
        loss_fn = None
        if vs == n - 1:
            def loss_fn(y, tgt):
                logits = torch.einsum("bld,vd->blv", y, table)
                logz = torch.logsumexp(logits, -1)
                gold = logits.gather(-1, tgt[..., None])[..., 0]
                return (logz - gold).mean()
        return StageDefinition(module=stage, optimizer=adamw(1e-3),
                               loss_fn=loss_fn)
    return [builder] * n


def _block_to_port(tree):
    return {f"layers.0.{k}": v.numpy()
            for k, v in block_params_from_jax(tree).items()}


@pytest.fixture(scope="module")
def block_runs(block_setup):
    weights, embed, data_fn = block_setup
    want = _jax_fit(_jax_block_builders(weights, embed, 2), data_fn)
    got = {kind: _port_fit(_port_block_builders(weights, embed, 2),
                           data_fn, kind) for kind in ("1f1b", "gpipe")}
    return got, want


@pytest.mark.parametrize("kind", ["1f1b", "gpipe"])
def test_block_stages_match_jax(block_runs, kind):
    got, (losses, params) = block_runs
    _check(got[kind], losses, params, _block_to_port)
    assert got[kind][2] == got["1f1b"][2]     # the same bits as 1F1B
