#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. The card's name and power limit (from nvidia-smi), then the build of
   every kernel from the sources under ray_tpu_torch/ops/csrc.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes and a few edge shapes, and timed beside its plain version,
   the least time the card could take (bound) and one PyTorch library call
   computing the same function.
3. The generator at the full width and depth of tpu-7b (32 layers, bf16,
   seeded random weights): make_generate_fn with batch 8, prompt 512, 32
   new tokens, greedy. Its prefill must launch the flash kernel once per
   layer, and its last-position prefill logits must agree with the same
   weights run through plain attention.
4. The continuous-batching engine on the same model: six requests of
   100-700 prompt tokens, one submitted mid-decode, stepped to the end.
   Every greedy token it emitted is then held against a one-shot forward
   of the same weights over the prompt and the tokens before it.
5. A JSON line of the kernels, the card line again, and last the result.

Launch counts are zeroed just before each main-path phase (3, 4) and read
just after it; launches made to compare or time a kernel do not count.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# bf16 kernel output against the plain version: o is stored in bf16 (one
# ulp is 2**-7 near 1, 2**-6 near 2-4) and p is rounded to bf16 against the
# running max in the kernel, the final max in the plain version
BF16_TOL = 2e-2
# fp32: the bound the JAX package holds its own Pallas kernel to
# (tests/test_model_parallel.py); lse is fp32 in every dtype
FP32_TOL = 2e-3
# tpu-7b prefill logits, kernel path vs plain attention (mha_reference),
# relative L2 error: the plain attention rounds its scores to bf16
# (2**-9 relative on scores of size ~10 moves probabilities by ~2%), and
# 32 bf16 layers add a few ulps each
LOGITS_REL_TOL = 5e-2
# engine greedy tokens against a one-shot (teacher-forced) forward: the
# engine's token must be the one-shot argmax or within this many logit
# units of it. The two paths attend differently (fp32 cached attention vs
# the kernel's bf16 p), and each logit may move by about the 0.125 max abs
# difference measured kernel vs plain attention on tpu-7b prefill logits
# (H100 80GB HBM3, 700 W); two logits moving apart give twice that, with
# room for decode's longer caches. A wrong slot, position or cache write
# picks a token several units (logits spread ~6) below the argmax.
NEAR_TIE_GAP = 0.5

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
H100_BYTES_S = 3.35e12     # HBM3


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(q, k, causal):
    """Least time for attention forward on these inputs: each of q, k, v,
    o read or written once (+ fp32 lse), against 4*D FLOPs per (query,
    key) pair that the mask keeps."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if causal:
        rows = torch.arange(Lq, dtype=torch.float64)
        pairs = float(torch.clamp(rows + 1, max=Lk).sum())
    else:
        pairs = float(Lq * Lk)
    flops = 4.0 * B * H * D * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + B * H * Lq * 4
    peak = H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_flash_kernel(ops):
    """Phase 2: kernel vs plain version on the card; timing at the tpu-7b
    prefill shape. Returns the kernel's record (without launches)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # name, B, Lq, Lk, H, Hkv, D, dtype, causal
        ("tpu-7b prefill", 8, 512, 512, 32, 8, 128, torch.bfloat16, True),
        ("llama-1b prefill", 8, 512, 512, 32, 8, 64, torch.bfloat16, True),
        ("ragged L=200", 2, 200, 200, 32, 8, 128, torch.bfloat16, True),
        ("Lq<Lk causal", 2, 130, 300, 32, 8, 128, torch.bfloat16, True),
        ("Lq>Lk causal", 2, 300, 130, 32, 8, 64, torch.bfloat16, True),
        ("Lq<Lk non-causal", 2, 130, 300, 32, 8, 128, torch.bfloat16,
         False),
        ("fp32 ragged", 2, 200, 200, 8, 2, 128, torch.float32, True),
        ("fp32 Lq>Lk non-causal", 2, 300, 130, 8, 2, 64, torch.float32,
         False),
    ]
    record = None
    for name, B, Lq, Lk, H, Hkv, D, dtype, causal in cases:
        def rand(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.float32).to(dtype)
        q, k, v = rand(B, Lq, H, D), rand(B, Lk, Hkv, D), rand(B, Lk, Hkv, D)
        before = ops.flash_attention_fwd.launches
        o, lse = ops.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        if ops.flash_attention_fwd.launches != before + 1:
            fail(f"flash_fwd {name}: the launch counter did not move")
        ro, rlse = ops.flash_attention_fwd_reference(q, k, v, causal)
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        ok = torch.allclose(o.float(), ro.float(), rtol=tol, atol=tol) and \
            torch.allclose(lse, rlse, rtol=FP32_TOL, atol=FP32_TOL)
        print(f"flash_fwd {name}: B={B} Lq={Lq} Lk={Lk} H={H} Hkv={Hkv} "
              f"D={D} {dtype} causal={causal}: max|o-plain|={err_o:.3e} "
              f"max|lse-plain|={err_lse:.3e} (tol {tol:g}/{FP32_TOL:g}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok or not torch.isfinite(o.float()).all():
            fail(f"flash_fwd {name} disagrees with its plain version")
        if record is None:   # the main path's shape: time it
            ms = cuda_ms(lambda: ops.flash_attention_fwd(q, k, v, causal))
            plain_ms = cuda_ms(
                lambda: ops.flash_attention_fwd_reference(q, k, v, causal))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            library_ms = cuda_ms(sdpa)
            sdpa_err = (sdpa().transpose(1, 2).float() - ro.float()
                        ).abs().max().item()
            bound_ms, bound_by = attention_bound_ms(q, k, causal)
            print(f"flash_fwd {name} timing: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
                  f"(max|sdpa-plain|={sdpa_err:.3e}), bound {bound_ms:.4f} "
                  f"ms by {bound_by}", flush=True)
            record = {"name": "flash_fwd", "route": "cuda",
                      "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
                      "replaces": "ray_tpu/ops/attention.py:54",
                      "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
        del q, k, v, o, lse, ro, rlse
    torch.cuda.empty_cache()
    return record


def run_generator(models, ops, device="cuda", name="tpu-7b", B=8, P=512,
                  N=32):
    """Phase 3. Returns (model, flash launches during generation). On a
    CPU (a rehearsal at a small size) the kernel is never launched."""
    cfg = models.MODEL_REGISTRY[name]
    model = models.TransformerLM(cfg, device="meta")
    init_fn, gen_fn = models.make_generate_fn(
        model, batch=B, prompt_len=P, max_new_tokens=N, temperature=0.0,
        device=device)
    t0 = time.perf_counter()
    init_fn(torch.Generator(device=device).manual_seed(0))
    sync(device)
    n_params = models.count_params(model)
    print(f"{name}: {n_params / 1e9:.3f} B parameters, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))

    ops.flash_attention_fwd.launches = 0           # main path: generator
    t0 = time.perf_counter()
    out = gen_fn(tokens)
    sync(device)
    gen_s = time.perf_counter() - t0
    launches = ops.flash_attention_fwd.launches
    print(f"generator: {B}x{P} prompt + {N} new tokens in {gen_s:.3f} s "
          f"({B * N / gen_s:.1f} tokens/s incl. prefill), flash_fwd "
          f"launches {launches}", flush=True)
    want_launches = cfg.n_layers if device == "cuda" else 0
    if launches != want_launches:
        fail(f"the prefill launched flash_fwd {launches} times, want "
             f"{want_launches} (one per layer on the card)")
    if tuple(out.shape) != (B, N) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        fail(f"generator output {tuple(out.shape)} out of range")

    # the same weights through plain attention (mha_reference)
    ref = models.TransformerLM(
        dataclasses.replace(cfg, attention_impl="reference"), device="meta")
    ref.load_state_dict(model.state_dict(), assign=True)
    with torch.inference_mode():
        got = model(tokens, cache=models.init_cache(
            cfg, B, P, device=device))[0][:, -1]
        want = ref(tokens, cache=models.init_cache(
            cfg, B, P, device=device))[0][:, -1]
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm()).item()
    print(f"prefill logits, kernel vs plain attention: relative L2 "
          f"{rel:.3e} (tol {LOGITS_REL_TOL:g}), max abs "
          f"{(got - want).abs().max().item():.3e}, max |logit| "
          f"{want.abs().max().item():.3e}, last-token argmax agreement "
          f"{(got.argmax(-1) == want.argmax(-1)).float().mean().item():.3f}",
          flush=True)
    if not torch.isfinite(got).all() or rel > LOGITS_REL_TOL:
        fail("prefill logits disagree with plain attention")
    _, ref_gen = models.make_generate_fn(ref, batch=B, prompt_len=P,
                                         max_new_tokens=N, device=device)
    out_ref = ref_gen(tokens)
    agree = (out == out_ref).float().mean().item()
    first_diff = [int((row_a != row_b).nonzero()[0]) if (row_a != row_b)
                  .any() else N for row_a, row_b in zip(out, out_ref)]
    print(f"greedy tokens, kernel vs plain attention (informational, bf16 "
          f"near-ties may flip): agreement {agree:.3f}, first difference "
          f"per row {first_diff}", flush=True)
    del ref, got, want
    return model, launches


def run_engine(model, models, inference, ops, card, device="cuda",
               n_slots=8, max_len=1024, chunk=128, budget=256,
               lens=(100, 230, 370, 480, 610, 700),
               new=(16, 20, 24, 28, 32, 24)):
    """Phase 4. Returns flash launches during the engine's run."""
    vocab = model.cfg.vocab_size
    cfg = inference.EngineConfig(n_slots=n_slots, max_len=max_len,
                                 prefill_chunk=chunk, prefill_budget=budget)
    eng = inference.InferenceEngine(model, cfg, device=device, seed=0)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, vocab, n) for n in lens]

    ops.flash_attention_fwd.launches = 0           # main path: engine
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=n)
               for p, n in zip(prompts[:-1], new[:-1])]
    steps = 0
    while handles[0].first_token_t is None:
        eng.step()
        steps += 1
        if steps > 200:
            fail("engine: the first request never started decoding")
    for _ in range(4):            # the last request arrives mid-decode
        eng.step()
        steps += 1
    if handles[0].finish_reason is not None:
        fail("engine: the first request finished before the last arrived")
    handles.append(eng.submit(prompts[-1], max_new_tokens=new[-1]))
    while not all(h.finish_reason for h in handles):
        eng.step()
        steps += 1
        if steps > 400:
            fail("engine: requests did not finish")
    sync(device)
    wall = time.perf_counter() - t0
    launches = ops.flash_attention_fwd.launches

    total = 0
    streams = []
    for i, (h, n) in enumerate(zip(handles, new)):
        toks = h.tokens()
        streams.append(toks)
        total += len(toks)
        rate = (len(toks) - 1) / (h.finished_t - h.first_token_t)
        print(f"engine request {i}: prompt {lens[i]}, {len(toks)} tokens, "
              f"finish {h.finish_reason}, TTFT {h.ttft_s * 1e3:.1f} ms, "
              f"decode {rate:.1f} tokens/s", flush=True)
        if len(toks) != n or h.finish_reason != "length" or \
                min(toks) < 0 or max(toks) >= vocab:
            fail(f"engine request {i}: {len(toks)} tokens (want {n}), "
                 f"finish {h.finish_reason}")
    print(f"engine: {len(handles)} requests, {total} tokens in {steps} "
          f"steps, {wall:.3f} s ({total / wall:.1f} tokens/s overall), "
          f"flash_fwd launches {launches} (chunked prefill and decode attend "
          f"through the cache) [{card}]", flush=True)

    # every engine token against a one-shot forward over the prompt and
    # the engine's earlier tokens: logits at position P-1+i predict token i
    gaps, exact = [], 0
    with torch.inference_mode():
        for prompt, toks in zip(prompts, streams):
            seq = torch.tensor(np.concatenate([prompt, toks[:-1]]),
                               dtype=torch.long, device=device)[None]
            logits = model(seq, cache=models.init_cache(
                model.cfg, 1, seq.shape[1], device=device))[0][0]
            logits = logits[len(prompt) - 1:].float()
            picked = torch.tensor(toks, device=device)
            gap = logits.max(-1).values - logits.gather(
                1, picked[:, None])[:, 0]
            if not torch.isfinite(logits).all():
                fail("engine check: one-shot logits are not finite")
            gaps.append(gap.max().item())
            exact += int((logits.argmax(-1) == picked).sum())
    print(f"engine tokens vs one-shot forward of the same weights: "
          f"{exact}/{total} are its argmax, largest gap below the argmax "
          f"{max(gaps):.3e} (tol {NEAR_TIE_GAP:g}), per request "
          f"{[round(g, 4) for g in gaps]}", flush=True)
    if max(gaps) > NEAR_TIE_GAP:
        fail("engine tokens disagree with a one-shot forward")
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card")
    from ray_tpu_torch import inference, models
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    _, log = _build.build("flash_fwd")
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"ptxas flash_fwd: {line.strip()}", flush=True)

    record = check_flash_kernel(ops)
    model, gen_launches = run_generator(models, ops)
    eng_launches = run_engine(model, models, inference, ops, card)
    record["launches"] = gen_launches + eng_launches
    if record["launches"] == 0:
        fail("the main path never launched flash_fwd")

    print(json.dumps({"kernels": [record]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
