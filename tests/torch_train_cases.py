"""Training loops and a collective rank for tests/test_torch_train_executor.py
and tests/test_torch_collective.py. The train workers and actors import
this module to run them, so it imports no JAX (and torch only where a
loop needs it, so a report-only worker starts without it).

- ``report_loop``/``crash_loop``: the shapes of tests/test_train.py's
  loops (reports, rank-0 checkpoints, one crash after step 1);
- ``llama_steps``/``llama_loop``: llama-debug in fp32 from given weights,
  AdamW(1e-3) through ``make_train_fns`` with the session's step
  profiler, on given token batches;
- ``CollectiveRank``: one rank of a 2-rank collective group.
"""

import os
import time

import numpy as np

from ray_tpu_torch import train


def report_loop(config):
    ctx = train.get_context()
    for step in range(4):
        ckpt = None
        if ctx.get_world_rank() == 0:
            ckpt = train.Checkpoint.from_dict({"model": step * 10})
        train.report({"step": step, "loss": 10.0 - step,
                      "rank": ctx.get_world_rank(),
                      "world": ctx.get_world_size()}, checkpoint=ckpt)


def crash_loop(config):
    ctx = train.get_context()
    start = 0
    if train.get_checkpoint() is not None:
        start = train.get_checkpoint().to_dict()["step"] + 1
    for step in range(start, 4):
        ckpt = None
        if ctx.get_world_rank() == 0:
            ckpt = train.Checkpoint.from_dict({"step": step})
        train.report({"step": step}, checkpoint=ckpt)
        if step == 1 and ctx.get_world_rank() == 0 and \
                not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            time.sleep(0.3)   # let the report drain
            os._exit(1)       # simulate a worker crash


def llama_steps(config, profiler=None):
    """[(loss, grad_norm)] of len(config["batches"]) steps of llama-debug
    (fp32, AdamW(1e-3), loss chunk 16) from config["weights"] (the port's
    state dict as numpy arrays), on torch.set_num_threads(threads)."""
    import dataclasses

    import torch

    from ray_tpu_torch import models, parallel
    torch.set_num_threads(config["threads"])
    cfg = dataclasses.replace(models.MODEL_REGISTRY["llama-debug"],
                              dtype=torch.float32)
    batches = config["batches"]
    model = models.TransformerLM(cfg, device="meta")
    init_fn, step_fn, _ = parallel.make_train_fns(
        model, parallel.adamw(1e-3), batch_shape=batches[0].shape,
        loss_chunk=16, device="cpu", profiler=profiler)
    state = init_fn(torch.Generator().manual_seed(0))
    state.model.load_state_dict({k: torch.from_numpy(v)
                                 for k, v in config["weights"].items()})
    out = []
    for tokens in batches:
        state, m = step_fn(state, torch.from_numpy(tokens))
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out


def llama_loop(config):
    prof = train.step_profiler()
    for i, (loss, gnorm) in enumerate(llama_steps(config, profiler=prof)):
        train.report({"step": i + 1, "loss": loss, "grad_norm": gnorm,
                      "flops": prof.flops, "mfu": prof.last.get("mfu")})


class CollectiveRank:
    """One rank: joins a group of 2 on ``backend`` and runs every
    collective on seeded numpy inputs, returning the results as numpy."""

    def run(self, rank, backend, group):
        import torch

        from ray_tpu_torch.util import collective as col
        col.init_collective_group(2, rank, backend=backend,
                                  group_name=group)
        try:
            rng = np.random.RandomState(rank)
            x = rng.randn(5, 3).astype(np.float32)

            def arg(a):
                return torch.from_numpy(a) if backend == "torch" else a

            def out(a):
                return a.numpy() if isinstance(a, torch.Tensor) else \
                    np.asarray(a)
            res = {"rank": col.get_rank(group),
                   "size": col.get_collective_group_size(group)}
            for op in ("sum", "product", "min", "max"):
                res[f"allreduce_{op}"] = out(col.allreduce(arg(x), group,
                                                           op=op))
            res["allgather"] = [out(a) for a in col.allgather(arg(x), group)]
            res["reducescatter"] = out(col.reducescatter(arg(x), group))
            res["broadcast"] = out(col.broadcast(arg(x), 1, group))
            col.barrier(group)
            ints = np.arange(6, dtype=np.int64).reshape(2, 3) + 10 * rank
            if rank == 0:
                col.send(arg(ints), 1, group)
                res["recv"] = out(col.recv(1, group))
            else:
                res["recv"] = out(col.recv(0, group))
                col.send(arg(ints), 0, group)
            return res
        finally:
            col.destroy_collective_group(group)
