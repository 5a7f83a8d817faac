"""Stages and data for tests/test_torch_mpmd_remote.py. The stage actors'
worker processes import this module to rebuild the builders, so it
imports no JAX.

- tanh stages (one tanh layer each, AdamW(1e-2), MSE loss on the last),
  as tests/test_torch_mpmd_elastic.py builds them;
- llama-debug blocks in fp32 with AdamW(1e-3), the embedding outside the
  stages and the last stage's loss the chunked cross-entropy against the
  embedding table, as tests/test_torch_mpmd.py builds them; for actor
  stages the weights ride the object store (``block_stage_builders``
  with an object ref).
"""

import dataclasses

import numpy as np
import torch

from ray_tpu_torch.parallel.optim import adamw
from ray_tpu_torch.train import StageDefinition, block_stage_builders

D, MB, M, S = 8, 4, 4, 2
N_LAYERS, L, LOSS_CHUNK = 2, 16, 8


def tanh_stage(stage_idx):
    g = torch.Generator().manual_seed(stage_idx)
    params = {"w": torch.randn(D, D, generator=g) * 0.3,
              "b": torch.zeros(D)}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    loss_fn = None
    if stage_idx == S - 1:
        def loss_fn(y, t):
            return torch.mean((y - t) ** 2)
    return StageDefinition(stage_fn=stage_fn, params=params,
                           optimizer=adamw(1e-2), loss_fn=loss_fn)


def tanh_data(step):
    rng = np.random.RandomState(step)
    ins = [rng.randn(MB, D).astype(np.float32) for _ in range(M)]
    tgts = [rng.randn(MB, D).astype(np.float32) for _ in range(M)]
    return ins, tgts


def llama_config():
    from ray_tpu_torch.models import MODEL_REGISTRY
    return dataclasses.replace(MODEL_REGISTRY["llama-debug"],
                               n_layers=N_LAYERS, dtype=torch.float32,
                               param_dtype=torch.float32, remat=False)


def llama_weights(cfg):
    from ray_tpu_torch.models import init_params
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                       dtype=torch.float32)


def llama_builders(cfg, weights):
    """``weights``: the state_dict, or the object ref of it (actor
    stages, which build on the CPU)."""
    return block_stage_builders(cfg, weights, S, adamw(1e-3), LOSS_CHUNK,
                                device="cpu")


def llama_data(cfg, weights, steps):
    embed = weights["embed"]
    data = {}
    for step in range(1, steps + 1):
        g = torch.Generator().manual_seed(100 + step)
        toks = torch.randint(0, cfg.vocab_size, (M, 1, L + 1), generator=g)
        data[step] = ([embed[toks[m, :, :-1]].clone() for m in range(M)],
                      [toks[m, :, 1:].clone() for m in range(M)])
    return lambda step: data[step]


def warm():
    """Run in a worker before the stage actors adopt it: imports what a
    stage actor needs (torch, the trainer, and torch._dynamo, which a
    torch optimizer imports when it is made), so an actor starts without
    waiting for them."""
    import time

    import ray_tpu_torch.train.mpmd  # noqa: F401
    adamw(1e-3)([torch.zeros(1, requires_grad=True)])
    time.sleep(0.5)     # hold the worker so each warm task gets its own
    return True
