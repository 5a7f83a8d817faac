"""Where a training step's time goes on the card.

    python -m ray_tpu_torch.trace_train [--model tpu-3b] [--layers N]
                                        [--settings fp32,dots,nothing,off]
                                        [--pipeline S [--remote]]

Builds a model of ``MODEL_REGISTRY`` (tpu-3b by default) at full width
with seeded weights, at its full depth or cut to ``--layers``, and trains
it, batch 4 x 1024, loss_chunk 256, one repeated batch, in four settings
(``--settings`` runs some of them: fp32 AdamW keeps 16 bytes per
parameter, which a 4-layer mixtral-8x7b, 6.07 B parameters, does not fit):

- ``fp32``: fp32 master weights, adamw(3e-4), no activation recompute
  (chip_smoke.py phase 6);
- ``dots``: the JAX bench's recipe: bf16 weights, adafactor(3e-4), remat
  "dots" (chip_smoke.py phase 7, and the MoE training phase);
- ``nothing`` and ``off``: the same recipe with remat "nothing" (plain
  checkpointing, which recomputes the products too but runs no per-op
  policy) and without remat, timed only: the recompute's share of the
  recipe's step is the difference of the step times.

For each it times steps after two warm-up steps (host clock around work
that ends in a synchronise), with tokens/s and the peak memory allocated,
then the optimizer's update alone on the last step's gradients; for the
first two it traces one step and its optimizer's update with
torch.profiler and prints the device time by kernel (the largest,
then the rest of the port's own) and by kernel family and the device's
busy share of the traced wall time.

With ``--pipeline S`` it instead runs the recipe's blocks (bf16 weights,
adafactor(3e-4)) as an in-process MPMD pipeline of S stages
(``train.mpmd``, 1F1B), 4 microbatches of 1 x 1024 per step (the same
4096 tokens), the embedding and unembedding outside the stages: it times
steps after two warm-up steps, then traces one step and splits its
device time by stage program (``mpmd.fwd``: the forwards; ``mpmd.bwd``:
each backward's recompute and gradients; ``mpmd.acc``, ``mpmd.apply``)
and by kernel family, the host hops being the memcpy rows. With
``--remote`` too, the stages are actors of the port's runtime
(``ray_tpu_torch.init()``; each stage holds 1/S of the card), the weights
go through the object store, and each actor traces the step in its own
process: the device's busy share is the actors' kernel time over the
step's wall (the card runs one process's kernels at a time).

Needs a CUDA card. Prints the card's name and power limit first.
"""

from __future__ import annotations

import dataclasses
import gc

import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import TransformerLM, init_params
from ray_tpu_torch.parallel import adafactor, adamw, make_train_fns
from ray_tpu_torch.trace_serving import (FAMILIES, _device_us, card_line,
                                         model_args, model_config, report,
                                         timed_ms)
from ray_tpu_torch.train import (MPMDConfig, MPMDPipelineTrainer,
                                 block_stage_builders)

B = 4        # sequences per step
L = 1024     # tokens per sequence
STEPS = 3    # steps timed


def run(title, cfg, optimizer, traced=True):
    model = TransformerLM(cfg, device="meta")
    init_fn, step_fn, _ = make_train_fns(model, optimizer,
                                         batch_shape=(B, L + 1),
                                         loss_chunk=256)
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
    print(f"{title}, B={B} L={L}: step {step_ms:.2f} ms "
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


def pipeline_inputs(cfg):
    """Seeded weights and one step's B embedded input microbatches and
    targets (on the host), the embedding outside the stages."""
    weights = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda", dtype=cfg.param_dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, 1, L + 1), device="cuda",
                         generator=g)
    inputs = [weights["embed"][t[:, :-1]].to(cfg.dtype).cpu() for t in toks]
    targets = [t[:, 1:].cpu() for t in toks]
    return weights, inputs, targets


def run_pipeline(title, cfg, n_stages):
    """Time and trace the recipe's blocks as an MPMD pipeline (see the
    module docstring)."""
    weights, inputs, targets = pipeline_inputs(cfg)
    # a replay window past the run: no checkpoint inside the traced step
    tr = MPMDPipelineTrainer(
        block_stage_builders(cfg, weights, n_stages, adafactor(3e-4)),
        MPMDConfig(n_microbatches=B, replay_depth=8))
    del weights
    traced = STEPS + 2
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def data_fn(step):
        if step == 3:
            torch.cuda.reset_peak_memory_stats()
        if step == traced:
            prof.__enter__()
        return inputs, targets

    out = tr.fit(data_fn, traced)
    prof.__exit__(None, None, None)
    rows = out["history"]
    step_ms = sum(h["wall_s"] for h in rows[2:-1]) * 1e3 / (traced - 3)
    print(f"{title}, {n_stages} stages, {B} microbatches of 1x{L}: step "
          f"{step_ms:.2f} ms ({B * L * 1e3 / step_ms:.1f} tokens/s), peak "
          f"memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB, analytic bubble {out['bubble_fraction_analytic']:.4f}")
    last = rows[-1]
    compute = [last[f"stage{s}_compute_s"] * 1e3 for s in range(n_stages)]
    wall = last["wall_s"] * 1e3
    print(f"traced step: wall {wall:.2f} ms, stage compute "
          f"{[round(c, 2) for c in compute]} ms, host (hops and dispatch) "
          f"{wall - sum(compute):.2f} ms, measured bubble "
          f"{[last[f'stage{s}_bubble_fraction'] for s in range(n_stages)]}")
    report(f"trace: one {title} pipeline step", prof, wall)
    ranges = {}
    for e in prof.key_averages():
        if e.key.startswith("mpmd.") and _device_us(e) > 0:
            ranges[e.key] = ranges.get(e.key, 0.0) + _device_us(e) / 1e3
    print("  device time under each stage program: " + (", ".join(
        f"{k} {v:.2f} ms" for k, v in sorted(ranges.items()))
        or "none recorded"))
    tr.shutdown()
    del tr
    gc.collect()
    torch.cuda.empty_cache()


def run_remote_pipeline(title, cfg, n_stages):
    """``--pipeline S --remote``: as run_pipeline, with actor stages."""
    import ray_tpu_torch as rt
    rt.init(object_store_memory=32 * 2 ** 30)    # the weights, snapshots
    try:
        weights, inputs, targets = pipeline_inputs(cfg)
        wref = rt.put({k: v.cpu() for k, v in weights.items()})
        del weights
        torch.cuda.empty_cache()
        tr = MPMDPipelineTrainer(
            block_stage_builders(cfg, wref, n_stages, adafactor(3e-4)),
            MPMDConfig(n_microbatches=B, replay_depth=8), remote=True,
            stage_resources=[{"GPU": 1.0 / n_stages}] * n_stages)
        traced = STEPS + 2
        tr.start()

        def data_fn(step):
            if step == traced:
                for h in tr.handles:
                    h.fetch(h.actor.trace_start.remote(), timeout=120)
            return inputs, targets

        out = tr.fit(data_fn, traced)
        kernels = [h.fetch(h.actor.trace_stop.remote(), timeout=300)
                   for h in tr.handles]
        rows = out["history"]
        step_ms = sum(h["wall_s"] for h in rows[2:-1]) * 1e3 / (traced - 3)
        peaks = [round(m["peak_bytes"] / 2 ** 30, 2)
                 for m in tr.memory_stats()]
        print(f"{title}, {n_stages} stage actors, {B} microbatches of "
              f"1x{L}: step {step_ms:.2f} ms ({B * L * 1e3 / step_ms:.1f} "
              f"tokens/s), peak memory allocated per actor {peaks} GiB")
        last = rows[-1]
        wall = last["wall_s"] * 1e3
        compute = [last[f"stage{s}_compute_s"] * 1e3
                   for s in range(n_stages)]
        busy = [sum(us for _, us, _ in ks) / 1e3 for ks in kernels]
        print(f"traced step: wall {wall:.2f} ms, stage compute "
              f"{[round(c, 2) for c in compute]} ms, device busy per actor "
              f"{[round(b, 2) for b in busy]} ms, together {sum(busy):.2f} "
              f"ms ({100 * sum(busy) / wall:.1f}% of the wall), measured "
              f"bubble "
              f"{[last[f'stage{s}_bubble_fraction'] for s in range(n_stages)]}")
        family = dict.fromkeys([f for f, _ in FAMILIES] + ["other"], 0.0)
        for ks in kernels:
            for key, us, _ in ks:
                f = next((f for f, keys in FAMILIES
                          if any(k in key for k in keys)), "other")
                family[f] += us / 1e3
        print("  by family: " + ", ".join(
            f"{f} {ms:.2f} ms" for f, ms in family.items()))
        tr.shutdown()
    finally:
        rt.shutdown()


SETTINGS = ("fp32", "dots", "nothing", "off")


def main():
    parser = model_args("Time and trace a training step on the card.",
                        "tpu-3b")
    parser.add_argument("--settings", default=",".join(SETTINGS),
                        help="comma-separated, of " + ", ".join(SETTINGS))
    parser.add_argument("--pipeline", type=int, default=None, metavar="S",
                        help="trace the recipe as an MPMD pipeline of S "
                        "stages instead")
    parser.add_argument("--remote", action="store_true",
                        help="with --pipeline: the stages as actors")
    args = parser.parse_args()
    settings = args.settings.split(",")
    if not set(settings) <= set(SETTINGS):
        parser.error(f"--settings {args.settings}: of {SETTINGS}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = card_line()
    print(f"card: {card}")
    base = model_config(args)
    name = f"{args.model}, {base.n_layers} layers"
    recipe = dataclasses.replace(base, param_dtype=torch.bfloat16,
                                 remat=True, remat_policy="dots")
    if args.remote and args.pipeline is None:
        parser.error("--remote needs --pipeline S")
    if args.pipeline is not None:
        trace = run_remote_pipeline if args.remote else run_pipeline
        trace(f"{name}: recipe blocks (bf16, Adafactor)", recipe,
              args.pipeline)
        print(f"card: {card}")
        return
    runs = {
        "fp32": (f"{name}: fp32 AdamW, no remat",
                 dataclasses.replace(base, remat=False), adamw, True),
        "dots": (f"{name}: recipe (bf16, Adafactor, remat dots)", recipe,
                 adafactor, True),
        "nothing": (f"{name}: recipe with remat nothing",
                    dataclasses.replace(recipe, remat_policy="nothing"),
                    adafactor, False),
        "off": (f"{name}: recipe without remat",
                dataclasses.replace(recipe, remat=False), adafactor, False),
    }
    ms = {s: run(title, cfg, opt(3e-4), traced)
          for s, (title, cfg, opt, traced) in runs.items() if s in settings}
    for policy in ("dots", "nothing"):
        if policy in ms and "off" in ms:
            extra = ms[policy] - ms["off"]
            print(f"recompute's share of the recipe's step under remat "
                  f"{policy}: {extra:.2f} ms "
                  f"({100 * extra / ms[policy]:.1f}%)")
    print(f"card: {card}")


if __name__ == "__main__":
    main()
