"""The SPMD pipeline (``ray_tpu_torch.parallel.pipeline_apply``) in a gloo
world of 4 ranks against the JAX package's ``pipeline_apply`` on 4 CPU
devices, on the same weights and inputs:

- the MLP stages of ``tests/test_pipeline.py`` (M=8) on ``stage=4`` and
  on ``fsdp=2, stage=2``: the output and the gradients of its sum with
  respect to the stacked weights and the microbatches, within 1e-5;
- llama-debug blocks as 2 stages on ``fsdp=2, stage=2`` with the
  embedding inside the loss (``__graft_entry__.py:_dryrun_pipeline``):
  the loss and every gradient, the embedding's included, in fp32 at the
  bound the mesh tests hold gradients to (rtol 1e-4, atol 1e-6). This is
  the test of the replicated boundary: the embedding's gradient comes
  out of stage 0 and the loss's out of the last stage, each sent to
  every rank (every rank checks it holds rank 0's values).

The ranks run ``tests/torch_pipeline_cases.py`` (no JAX)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import MODEL_REGISTRY
from ray_tpu.models.transformer import Block, unpartitioned_params
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.parallel.pipeline import pipeline_apply, stack_stage_params
from ray_tpu_torch.models import block_params_from_jax
from tests import torch_mesh_cases as cases
from tests import torch_pipeline_cases as pcases
from tests.torch_world import World

S, M, MB, D = 4, 8, 2, 16
N_MB, BLOCK_MB, L = 4, 2, 32
JAX_MESHES = {"s4": dict(data=1, fsdp=1, stage=4),
              "f2s2": dict(data=1, fsdp=2, stage=2)}


def _mlp_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_mlp(layout, per_stage, x):
    mesh = make_mesh(MeshConfig(**JAX_MESHES[layout]),
                     devices=jax.devices()[:4])
    stacked = stack_stage_params(per_stage[:JAX_MESHES[layout]["stage"]])

    @jax.jit
    def run(p, xx):
        y, vjp = jax.vjp(
            lambda pp, xxx: pipeline_apply(_mlp_stage, pp, xxx, mesh), p, xx)
        return (y,) + vjp(jnp.ones_like(y))       # the gradients of y.sum()
    y, gp, gx = run(stacked, x)
    return {"y": np.asarray(y), "x_grad": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gp.items()}}


def _jax_blocks(stages, embed, tokens):
    cfg = dataclasses.replace(MODEL_REGISTRY["llama-debug"],
                              dtype=jnp.float32, param_dtype=jnp.float32,
                              scan_layers=False, remat=False)
    mesh = make_mesh(MeshConfig(**JAX_MESHES["f2s2"]),
                     devices=jax.devices()[:4])
    block = Block(cfg)
    positions = jnp.broadcast_to(jnp.arange(L)[None, :], (BLOCK_MB, L))

    def stage_fn(p, x):
        with unpartitioned_params():
            out, _aux = block.apply({"params": p}, x, positions)
        return out

    def loss_fn(params):
        inp, tgt = tokens[..., :-1], tokens[..., 1:]
        h = params["embed"][inp]
        h = pipeline_apply(stage_fn, params["stages"], h, mesh)
        logits = jnp.einsum("mbld,vd->mblv", h, params["embed"])
        logz = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, tgt[..., None], -1)[..., 0]
        return (logz - gold).mean()

    params = {"embed": jnp.asarray(embed),
              "stages": stack_stage_params(stages)}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), grads


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipeline")
    rng = np.random.RandomState(0)
    mlp = [{"w": (rng.randn(D, D) * 0.5).astype(np.float32),
            "b": (rng.randn(D) * 0.1).astype(np.float32)} for _ in range(S)]
    x = rng.randn(M, MB, D).astype(np.float32)
    cfg = MODEL_REGISTRY["llama-debug"]
    stages = [pcases.jax_block_tree(rng, cfg) for _ in range(2)]
    embed = (rng.randn(cfg.vocab_size, cfg.d_model) * 0.02).astype(
        np.float32)
    tokens = rng.randint(0, cfg.vocab_size, (N_MB, BLOCK_MB, L + 1))
    torch.save({"mlp": mlp, "x": x, "embed": embed, "tokens": tokens,
                "blocks": [{f"layers.0.{k}": v for k, v in
                            block_params_from_jax(p).items()}
                           for p in stages]}, work / "inputs.pt")
    with World("tests.torch_pipeline_cases:pipeline", 4, work,
               timeout=120) as world:
        with cases.one_thread():
            want = {"mlp": {layout: _jax_mlp(layout, mlp, x)
                            for layout in JAX_MESHES},
                    "blocks": _jax_blocks(stages, embed, tokens)}
        got = world.join()
    return got, want


@pytest.mark.parametrize("layout", sorted(JAX_MESHES))
def test_mlp_pipeline_matches_jax(results, layout):
    got, want = results
    g, w = got["mlp"][layout], want["mlp"][layout]
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g["y"], torch.from_numpy(w["y"]), **tol)
    torch.testing.assert_close(g["x_grad"], torch.from_numpy(w["x_grad"]),
                               **tol)
    assert sorted(g["grads"]) == ["b", "w"]
    for name, gw in w["grads"].items():
        torch.testing.assert_close(g["grads"][name], torch.from_numpy(gw),
                                   **tol, msg=name)


def test_block_pipeline_train_step_matches_jax(results):
    got, want = results
    g = got["blocks"]
    loss, grads = want["blocks"]
    torch.testing.assert_close(g["loss"].item(), loss, rtol=1e-4, atol=0.0)
    tol = dict(rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(g["embed_grad"],
                               torch.from_numpy(np.asarray(grads["embed"])),
                               **tol, msg="embed")
    per_stage = [{f"layers.0.{k}": v for k, v in block_params_from_jax(
        jax.tree.map(lambda a, s=s: np.asarray(a)[s],
                     grads["stages"])).items()} for s in range(2)]
    assert sorted(g["grads"]) == sorted(per_stage[0])
    for name, gs in g["grads"].items():
        want_stacked = torch.stack([p[name] for p in per_stage])
        torch.testing.assert_close(gs, want_stacked, **tol, msg=name)
