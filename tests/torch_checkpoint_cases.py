"""What each rank of the sharded-checkpoint tests' gloo world runs
(``tests/torch_world.py``): JAX-free, torch and the port only.

``layouts`` trains llama-debug (fp32, AdamW) one step on the ZeRO-3
layout (fsdp=4), saves the parameters with ``save_sharded`` (every rank
writes its own shards), restores them into a model of the same layout
and into one of the fsdp x tensor layout (fsdp=2, tensor=2), each made
from another seed, and returns from rank 0 what the test holds: every
shard and placement of the roundtrip, the whole tensors of both
restores, the next step's loss of the trained and the restored model,
and what ``restore_host_arrays`` reads.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.models import TransformerLM
from ray_tpu_torch.parallel import adamw, make_mesh, make_train_fns
from ray_tpu_torch.train.sharded_checkpoint import (abstract_like,
                                                    restore_host_arrays,
                                                    restore_sharded,
                                                    save_sharded)
from tests.torch_mesh_cases import LAYOUTS, config


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _state(layout, tokens, seed):
    mesh = make_mesh(LAYOUTS[layout], "cpu")
    model = TransformerLM(config("llama-debug"), device="meta")
    init_fn, step_fn, _ = make_train_fns(
        model, adamw(1e-3), mesh=mesh, batch_shape=tuple(tokens.shape),
        loss_chunk=16, device="cpu")
    return model, step_fn, init_fn(torch.Generator().manual_seed(seed))


def _restored(ckpt, layout, tokens):
    """A model of ``layout`` from seed 7, its parameters then restored
    from ``ckpt``; the restored state dict's step comes back too."""
    model, step_fn, state = _state(layout, tokens, seed=7)
    target = abstract_like({"params": model.state_dict(), "step": 0})
    got = restore_sharded(ckpt, target)
    model.load_state_dict(got["params"])
    return model, step_fn, state, got


def layouts(rank, world, workdir):
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    tokens = torch.as_tensor(inputs["tokens"])
    ckpt = str(workdir / "ckpt")
    model, step_fn, state = _state("f4", tokens, seed=0)
    state, _ = step_fn(state, tokens)
    saved = {n: t.detach().clone() for n, t in model.state_dict().items()}
    save_sharded({"params": model.state_dict(), "step": state.step}, ckpt)

    same, same_step, same_state, got = _restored(ckpt, "f4", tokens)
    shards_equal = all(
        torch.equal(got["params"][n].to_local(), t.to_local())
        and got["params"][n].placements == t.placements
        for n, t in saved.items())
    other, other_step, other_state, _ = _restored(ckpt, "f2t2", tokens)
    placements = {n: (tuple(saved[n].placements),
                      tuple(p.placements))
                  for n, p in other.state_dict().items()}
    # the whole tensors as restored, before the steps below change them
    out = {"step": got["step"], "shards_equal": shards_equal,
           "saved": {n: _whole(t) for n, t in saved.items()},
           "same": {n: _whole(t.detach()).clone()
                    for n, t in same.state_dict().items()},
           "other": {n: _whole(t.detach()).clone()
                     for n, t in other.state_dict().items()},
           "placements": placements}
    _, m_trained = step_fn(state, tokens)
    _, m_same = same_step(same_state, tokens)
    _, m_other = other_step(other_state, tokens)
    out["loss"] = (float(m_trained["loss"]), float(m_same["loss"]),
                   float(m_other["loss"]))
    if rank == 0:
        out["host"] = restore_host_arrays(ckpt)
    return out


PROMPT = [3, 14, 15, 92, 65, 35, 89, 79]


def train_and_save(rank, world, workdir):
    """Train llama-debug (fp32, AdamW(1e-3)) 2 steps on the fsdp x
    tensor layout (fsdp=2, tensor=2) from the converted weights in
    ``inputs.pt`` and save the parameters under ``workdir/ckpt``; rank 0
    returns them whole."""
    from ray_tpu_torch.parallel import load_params
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    tokens = torch.as_tensor(inputs["tokens"])
    model, step_fn, state = _state("f2t2", tokens, seed=0)
    load_params(model, inputs["weights"])
    for _ in range(2):
        state, _ = step_fn(state, tokens)
    save_sharded(model.state_dict(), str(workdir / "ckpt"))
    return {n: _whole(t.detach()).clone()
            for n, t in model.state_dict().items()}


class CheckpointedLM:
    """Serve callable of a ``num_hosts=2`` gang: every rank builds
    llama-debug over the gang's 2-rank mesh (tensor=2, another layout
    than the training's), restores the trained parameters into it, and
    serves last-position logits."""

    def __init__(self, ckpt_path: str):
        import torch.distributed as dist

        from ray_tpu_torch.parallel import MeshConfig, make_infer_fns
        assert dist.get_world_size() == 2
        mesh = make_mesh(MeshConfig(fsdp=1, tensor=2), "cpu")
        model = TransformerLM(config("llama-debug"), device="meta")
        init_fn, self._infer, _ = make_infer_fns(
            model, mesh, batch_shape=(1, len(PROMPT)), device="cpu")
        init_fn(torch.Generator().manual_seed(7))    # the target layout
        got = restore_sharded(ckpt_path, abstract_like(model.state_dict()))
        model.load_state_dict(got)
        self.placements = {n: str(p.placements)
                           for n, p in model.state_dict().items()}

    def __call__(self, tokens):
        return self._infer(torch.tensor([tokens]))[0].tolist()
