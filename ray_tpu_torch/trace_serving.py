"""Where the serving path's time goes on the card.

    python -m ray_tpu_torch.trace_serving [--model tpu-7b] [--layers N]

Builds a model of ``MODEL_REGISTRY`` (tpu-7b by default) at full width
with seeded random weights, at its full depth or cut to ``--layers``
(mixtral-8x7b does not fit in 80 GB whole), then, at batch 8 and prompt
512 (the shape of chip_smoke.py's generator phases):

1. times the generator's one-shot prefill and its single-token decode
   steps (host clock around work that ends in a synchronise);
2. times the engine's decode step with every slot occupied;
3. traces one prefill and three decode steps with torch.profiler and
   prints the device time by kernel (the largest, then the rest of the
   port's own) and the device's busy share of the traced wall time.

Needs a CUDA card. Prints the card's name and power limit first.
``trace_train.py`` does the same for a training step and shares the
timing and kernel-row counting here.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.models import (MODEL_REGISTRY, TransformerLM, init_cache,
                                  init_params)

B = 8        # requests decoded together
P = 512      # prompt tokens
STEPS = 16   # decode steps timed


def timed_ms(fn, n=1):
    """Host time per call of ``fn``, bracketed by synchronises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def kernel_events(prof):
    """A torch.profiler trace's kernel rows: an operator's row repeats the
    time of its kernels, and so does a user annotation on the device
    (Optimizer.step#AdamW.step)."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def busy_ms(prof):
    """The device's kernel time in a torch.profiler trace, ms."""
    return sum(_device_us(e) for e in kernel_events(prof)) / 1e3


# kernel families by name: the port's kernels, cuBLAS GEMMs, the
# multi-tensor kernels of the optimizer and the gradient norm, the sort
# and cumulative sum of an expert layer's routing, and the copies between
# host and device
FAMILIES = (("flash attention (ours)", ("flash_",)),
            ("GEMM", ("gemm", "nvjet", "cutlass", "xmma")),
            ("multi-tensor (AdamW, grad norm)", ("multi_tensor_apply",)),
            ("sort and scan (MoE routing)", ("sort", "Sort", "scan", "Scan")),
            ("memcpy (host hops, snapshots)", ("Memcpy",)))


def model_args(description, model, layers=None):
    """The traces' options: a registry model and an optional cut depth."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--model", default=model,
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("--layers", type=int, default=layers,
                        help="cut the model to this many layers")
    return parser


def model_config(args):
    cfg = MODEL_REGISTRY[args.model]
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def report(title, prof, wall_ms, top=12):
    """Device time by kernel (the ``top`` rows, then every other row of the
    port's own kernels), by kernel family, and the device's busy share of
    ``wall_ms``."""
    events = kernel_events(prof)
    busy = sum(_device_us(e) for e in events) / 1e3
    print(f"{title}: traced wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy / wall_ms):.1f}%")
    family_ms = dict.fromkeys([f for f, _ in FAMILIES] + ["other"], 0.0)
    for e in events:
        family = next((f for f, keys in FAMILIES
                       if any(k in e.key for k in keys)), "other")
        family_ms[family] += _device_us(e) / 1e3
    print("  by family: " + ", ".join(
        f"{f} {ms:.2f} ms ({100 * ms / busy:.1f}%)"
        for f, ms in family_ms.items()))
    rows = sorted(events, key=_device_us, reverse=True)
    ours = FAMILIES[0][1]
    for e in rows[:top] + [e for e in rows[top:]
                           if any(k in e.key for k in ours)]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    args = model_args("Time and trace the serving path on the card.",
                      "tpu-7b").parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = card_line()
    print(f"card: {card}")
    cfg = model_config(args)
    name = f"{args.model}, {cfg.n_layers} layers"
    model = TransformerLM(cfg, device="meta")
    model.load_state_dict(init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"),
        assign=True)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))

    with torch.inference_mode():
        cache = init_cache(cfg, B, P + STEPS + 8)
        state = {}

        def prefill():
            cache["idx"] = 0
            state["logits"], state["cache"] = model(tokens, cache=cache)

        prefill()                                  # warm-up
        prefill_ms = timed_ms(prefill, 3)
        tok = state["logits"][:, -1].argmax(-1)

        def decode():
            state["logits"], state["cache"] = model(tok[:, None],
                                                    cache=state["cache"])

        decode()                                   # warm-up
        decode_ms = timed_ms(decode, STEPS)
        print(f"{name}: generator, B={B}: prefill of {P} tokens "
              f"{prefill_ms:.2f} ms"
              f", decode step {decode_ms:.2f} ms ({B * 1e3 / decode_ms:.1f} "
              f"tokens/s)")

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed_ms(prefill)
        report("trace: one prefill", prof, wall)
        state["cache"]["idx"] = P
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed_ms(decode, 3)
        report("trace: three decode steps", prof, 3 * wall)
        del cache, state

    eng = InferenceEngine(model, EngineConfig(
        n_slots=B, max_len=1024, prefill_chunk=128, prefill_budget=1024),
        device="cuda")
    rng = np.random.RandomState(0)
    handles = [eng.submit(rng.randint(0, cfg.vocab_size, P),
                          max_new_tokens=1000 - P) for _ in range(B)]
    while any(h.first_token_t is None for h in handles):
        eng.step()
    eng.step()                                     # warm-up
    step_ms = timed_ms(eng.step, STEPS)
    print(f"{name}: engine, {B} slots occupied at ~{P} tokens: decode step "
          f"{step_ms:.2f} ms ({B * 1e3 / step_ms:.1f} tokens/s)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed_ms(eng.step, 3)
    report("trace: three engine decode steps", prof, 3 * wall)
    for h in handles:
        h.cancel()
    eng.step()
    print(f"card: {card}")


if __name__ == "__main__":
    main()
