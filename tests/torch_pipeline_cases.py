"""What each rank of the pipeline tests' gloo worlds runs
(``tests/torch_world.py``, ``tests/test_torch_pipeline_world.py``).

JAX-free: the ranks import torch and the port only. ``pipeline`` reads
``inputs.pt`` (written by the test before it starts the world: the MLP
stages' weights and microbatches, and the llama-debug block stages'
weights converted from the JAX model with the embedding table and the
tokens) and returns, from rank 0, the outputs and every gradient, whole,
for each layout. Every rank checks that its outputs and its replicated
gradients equal rank 0's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from ray_tpu_torch.models import BlockStage
from ray_tpu_torch.parallel import (MeshConfig, make_mesh, pipeline_apply,
                                    shard_stage_params, stack_stage_params)
from tests.torch_mesh_cases import config

LAYOUTS = {"s4": MeshConfig(fsdp=1, stage=4),
           "f2s2": MeshConfig(fsdp=2, stage=2)}


def jax_block_tree(rng, cfg):
    """One JAX ``Block``'s param tree for ``cfg``'s widths, random
    (1/sqrt(fan-in) scale, norm scales near 1), as numpy arrays: the
    tests build the same stage on both sides from it."""
    E, H, Hkv, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    Dh = E // H

    def w(*shape, fan_in):
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    def scale():
        return (1.0 + 0.1 * rng.randn(E)).astype(np.float32)
    return {"attn_norm": {"scale": scale()},
            "attn": {"q": {"kernel": w(E, H, Dh, fan_in=E)},
                     "k": {"kernel": w(E, Hkv, Dh, fan_in=E)},
                     "v": {"kernel": w(E, Hkv, Dh, fan_in=E)},
                     "o": {"kernel": w(H, Dh, E, fan_in=E)}},
            "mlp_norm": {"scale": scale()},
            "mlp": {"gate": {"kernel": w(E, F, fan_in=E)},
                    "up": {"kernel": w(E, F, fan_in=E)},
                    "down": {"kernel": w(F, E, fan_in=F)}}}


def mlp_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _same_on_every_rank(t: torch.Tensor, what: str):
    ref = t.detach().clone()
    dist.broadcast(ref, 0)
    if not torch.equal(ref, t):
        raise AssertionError(f"rank {dist.get_rank()}: {what} differs from "
                             f"rank 0's")


def _stacked(per_stage, mesh):
    stacked = stack_stage_params([{k: torch.as_tensor(v) for k, v in
                                   p.items()} for p in per_stage])
    params = shard_stage_params(stacked, mesh)
    for p in params.values():
        p.requires_grad_(True)
    return params


def _grads(params):
    return {n: p.grad.full_tensor() for n, p in params.items()}


def run_mlp(layout, inputs):
    """MLP stages: y = pipeline(x) and the gradients of y.sum() with
    respect to the stacked weights and the microbatches."""
    mesh = make_mesh(LAYOUTS[layout], "cpu")
    n_stages = LAYOUTS[layout].stage
    params = _stacked(inputs["mlp"][:n_stages], mesh)
    x = torch.as_tensor(inputs["x"]).clone().requires_grad_(True)
    y = pipeline_apply(mlp_stage, params, x, mesh)
    y.sum().backward()
    _same_on_every_rank(y, f"{layout} output")
    _same_on_every_rank(x.grad, f"{layout} input gradient")
    return {"y": y.detach(), "x_grad": x.grad, "grads": _grads(params)}


def run_blocks(layout, inputs):
    """llama-debug blocks as stages, the embedding inside the loss, as the
    JAX package's pipelined training step (``__graft_entry__.py:
    _dryrun_pipeline``): h = embed[inputs]; pipeline; logits = h @
    embed^T; mean cross-entropy."""
    mesh = make_mesh(LAYOUTS[layout], "cpu")
    cfg = config("llama-debug")
    stage = BlockStage(cfg, 1, device="meta")
    params = _stacked(inputs["blocks"], mesh)
    embed = torch.as_tensor(inputs["embed"]).clone().requires_grad_(True)
    tokens = torch.as_tensor(inputs["tokens"]).long()
    inp, tgt = tokens[..., :-1], tokens[..., 1:]

    def stage_fn(p, x):
        return functional_call(stage, p, (x,))

    h = pipeline_apply(stage_fn, params, embed[inp], mesh)
    logits = torch.einsum("mbld,vd->mblv", h, embed)
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, tgt[..., None])[..., 0]
    loss = (logz - gold).mean()
    loss.backward()
    _same_on_every_rank(loss.detach(), f"{layout} loss")
    _same_on_every_rank(embed.grad, f"{layout} embedding gradient")
    return {"loss": loss.detach(), "embed_grad": embed.grad,
            "grads": _grads(params)}


def pipeline(rank, world, workdir):
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    return {"mlp": {layout: run_mlp(layout, inputs) for layout in LAYOUTS},
            "blocks": run_blocks("f2s2", inputs)}
