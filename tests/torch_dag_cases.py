"""What the stage actors of tests/test_torch_dag_channels.py run.

JAX-free: a worker that unpickles ``BlockStageActor`` imports this module,
torch and the port only."""

from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch.models import MODEL_REGISTRY, BlockStage


def config(name: str = "llama-debug"):
    """fp32 everywhere, no recompute: the JAX side uses the same fields."""
    return dataclasses.replace(MODEL_REGISTRY[name], dtype=torch.float32,
                               remat=False)


class BlockStageActor:
    """A run of llama-debug blocks as one compiled-DAG stage: x [B, L, d]
    -> the blocks' output, on the CPU."""

    def __init__(self, state_dict, n_blocks: int):
        torch.set_num_threads(1)
        self.stage = BlockStage(config(), n_blocks, device="cpu")
        self.stage.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()})

    def forward(self, x):
        with torch.no_grad():
            return self.stage(x)
