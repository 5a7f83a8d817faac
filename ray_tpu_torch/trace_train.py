"""Where a training step's time goes on the card, for tpu-3b.

    python -m ray_tpu_torch.trace_train

Builds tpu-3b at full width and depth with seeded weights and trains it,
batch 4 x 1024, loss_chunk 256, one repeated batch, in four settings:

- fp32 master weights, adamw(3e-4), no activation recompute (chip_smoke.py
  phase 6);
- the JAX bench's recipe: bf16 weights, adafactor(3e-4), remat "dots"
  (chip_smoke.py phase 7);
- the same recipe with remat "nothing" (plain checkpointing, which
  recomputes the products too but runs no per-op policy) and without
  remat, timed only: the recompute's share of the recipe's step is the
  difference of the step times.

For each it times steps after two warm-up steps (host clock around work
that ends in a synchronise), with tokens/s and the peak memory allocated,
then the optimizer's update alone on the last step's gradients; for the
first two it traces one step and its optimizer's update with
torch.profiler and prints the device time by kernel (the largest,
then the rest of the port's own) and by kernel family and the device's
busy share of the traced wall time.

Needs a CUDA card. Prints the card's name and power limit first.
"""

from __future__ import annotations

import dataclasses
import gc

import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import MODEL_REGISTRY, TransformerLM
from ray_tpu_torch.parallel import adafactor, adamw, make_train_fns
from ray_tpu_torch.trace_serving import card_line, report, timed_ms

B = 4        # sequences per step
L = 1024     # tokens per sequence
STEPS = 3    # steps timed


def run(title, cfg, optimizer, traced=True):
    model = TransformerLM(cfg, device="meta")
    init_fn, step_fn = make_train_fns(model, optimizer,
                                      batch_shape=(B, L + 1), loss_chunk=256)
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L + 1), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))

    def step():
        step_fn(state, tokens)

    step()
    step()                                         # warm-up
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(step, STEPS)
    print(f"{title}, tpu-3b, B={B} L={L}: step {step_ms:.2f} ms "
          f"({B * L * 1e3 / step_ms:.1f} tokens/s), peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    opt_ms = timed_ms(state.optimizer.step, STEPS)
    print(f"{title}: the optimizer's update alone {opt_ms:.2f} ms")
    if traced:
        for what, fn, top in (("step", step, 16),
                              ("optimizer update", state.optimizer.step, 6)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = timed_ms(fn)
            report(f"trace: one {title} {what}", prof, wall, top=top)
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    return step_ms


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = card_line()
    print(f"card: {card}")
    base = MODEL_REGISTRY["tpu-3b"]
    run("fp32 AdamW, no remat", dataclasses.replace(base, remat=False),
        adamw(3e-4))
    recipe = dataclasses.replace(base, param_dtype=torch.bfloat16,
                                 remat=True, remat_policy="dots")
    with_remat = run("recipe (bf16, Adafactor, remat dots)", recipe,
                     adafactor(3e-4))
    nothing = run("recipe with remat nothing",
                  dataclasses.replace(recipe, remat_policy="nothing"),
                  adafactor(3e-4), traced=False)
    without = run("recipe without remat",
                  dataclasses.replace(recipe, remat=False), adafactor(3e-4),
                  traced=False)
    for policy, ms in (("dots", with_remat), ("nothing", nothing)):
        print(f"recompute's share of the recipe's step under remat "
              f"{policy}: {ms - without:.2f} ms "
              f"({100 * (ms - without) / ms:.1f}%)")
    print(f"card: {card}")


if __name__ == "__main__":
    main()
