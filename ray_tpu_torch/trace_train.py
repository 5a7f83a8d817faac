"""Where a training step's time goes on the card, for tpu-3b.

    python -m ray_tpu_torch.trace_train

Builds tpu-3b at full width and depth with seeded fp32 master weights and
trains it as chip_smoke.py's training phase does (make_train_fns,
adamw(3e-4), loss_chunk 256, batch 4 x 1024, one repeated batch):

1. times steps after two warm-up steps (host clock around work that ends
   in a synchronise), with tokens/s and the peak memory allocated;
2. traces one step with torch.profiler and prints the device time by
   kernel (the largest, then the rest of the port's own) and by kernel
   family and the device's busy share of the traced wall time.

Needs a CUDA card. Prints the card's name and power limit first.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import MODEL_REGISTRY, TransformerLM
from ray_tpu_torch.parallel import adamw, make_train_fns
from ray_tpu_torch.trace_serving import card_line, report, timed_ms

B = 4        # sequences per step
L = 1024     # tokens per sequence
STEPS = 3    # steps timed


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = card_line()
    print(f"card: {card}")
    cfg = MODEL_REGISTRY["tpu-3b"]
    model = TransformerLM(cfg, device="meta")
    init_fn, step_fn = make_train_fns(model, adamw(3e-4),
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
    print(f"train tpu-3b, B={B} L={L}: step {step_ms:.2f} ms "
          f"({B * L * 1e3 / step_ms:.1f} tokens/s), peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed_ms(step)
    report("trace: one training step", prof, wall, top=16)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
