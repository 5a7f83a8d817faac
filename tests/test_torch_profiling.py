"""ray_tpu_torch's step profiler against ray_tpu's on the CPU.

The same ``observe()`` inputs through both packages' ``StepProfiler``
give equal records and register gauges of the same names; the analytic
decode FLOPs and bytes are equal; the peak overrides read the port's own
environment names; ``wrap_step``'s count of a llama-debug train step
equals the analytic count (attention counted once, from its shapes, with
the causal mask); and the engine's per-decode-step attribution equals the
JAX engine's for the same requests on the same weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from ray_tpu.inference import EngineConfig as JaxEngineConfig
from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.models.transformer import TransformerLM as JaxLM
from ray_tpu.util import metrics as jax_metrics
from ray_tpu.util import profiling as jax_profiling
from ray_tpu_torch import models, parallel
from ray_tpu_torch._private import events
from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.models import (TransformerConfig, TransformerLM,
                                  params_from_jax)
from ray_tpu_torch.util import metrics
from ray_tpu_torch.util import profiling

# (compute_s, data_s, begin_t, end_t, tokens, flops, bytes, failed): a
# first step, a host gap, a data wait, a step without cost, a failure
OBSERVATIONS = [
    (0.25, 0.0, 10.0, 10.25, 4096, 6.9e13, 1.2e10, False),
    (0.30, 0.01, 10.5, 10.81, 4096, None, None, False),
    (0.10, 0.0, 11.0, 11.1, None, 0.0, 0.0, False),
    (0.20, 0.05, 12.0, 12.25, 8, 3.0e12, 4.0e11, True),
]


def _observe_all(prof):
    out = []
    for c, d, b, e, tok, fl, nb, failed in OBSERVATIONS:
        out.append(prof.observe(compute_s=c, data_s=d, begin_t=b, end_t=e,
                                tokens=tok, flops=fl, bytes_accessed=nb,
                                failed=failed))
    return out


def test_observe_records_equal_jax():
    """Exactly equal records (phases, wall, MFU over wall and compute,
    roofline bound, tokens/s, the failure flag) for the same inputs, with
    the peaks given."""
    kw = dict(peak_flops=989.4e12, peak_bytes_per_s=3.35e12,
              emit_span=False)
    got = _observe_all(profiling.StepProfiler("probe_rec", **kw))
    want = _observe_all(jax_profiling.StepProfiler("probe_rec", **kw))
    assert got == want
    assert got[1]["host_gap_ms"] > 0 and "roofline_bound" in got[0]


def test_gauge_names_equal_jax():
    """The gauges one profiler registers, by name and tag keys."""
    profiling.StepProfiler("probe_names", peak_flops=1e12)
    jax_profiling.StepProfiler("probe_names", peak_flops=1e12)

    def names(registry):
        return sorted((m["name"], m["type"])
                      for m in registry.registry_snapshot()
                      if m["name"].startswith("runtime_probe_names_"))
    assert names(metrics) == names(jax_metrics)
    assert len(names(metrics)) == 5


def test_step_span_carries_the_record():
    """emit_span=True records ``<name>.step`` with the record's fields."""
    events.drain()
    prof = profiling.StepProfiler("probe_span", peak_flops=1e12)
    prof.set_cost(1e9)
    with prof.step(tokens=16) as s:
        s.data_ready()
    rows = [r for r in events.drain() if r.get("name") == "probe_span.step"]
    assert rows and rows[0]["category"] == "profile"
    assert rows[0]["attrs"]["mfu"] == prof.last["mfu"]
    assert rows[0]["attrs"]["tokens_per_s"] == prof.last["tokens_per_s"]


@pytest.mark.parametrize("kv_lens", [[1], [10, 20, 300], [0, 5, 4096]])
def test_decode_flops_and_bytes_equal_jax(kv_lens):
    args = (2_613_000_000, 24, 24, 128)
    assert profiling.decode_step_flops(*args, kv_lens) == \
        jax_profiling.decode_step_flops(*args, kv_lens)
    args = (5.2e9, 24, 8, 128)
    assert profiling.decode_step_bytes(*args, kv_lens, 2.0) == \
        jax_profiling.decode_step_bytes(*args, kv_lens, 2.0)


def test_peak_env_override(monkeypatch):
    """The port reads RAY_TPU_TORCH_*; on the CPU it falls back to the
    nominal CPU entry, as JAX does."""
    monkeypatch.delenv("RAY_TPU_TORCH_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("RAY_TPU_TORCH_PEAK_BYTES_PER_S", raising=False)
    assert profiling.detect_peak_flops() == 1e11
    assert profiling.detect_peak_bytes_per_s() == 5e10
    monkeypatch.setenv("RAY_TPU_PEAK_FLOPS", "1e9")       # not the port's
    monkeypatch.setenv("RAY_TPU_TORCH_PEAK_FLOPS", "123e9")
    monkeypatch.setenv("RAY_TPU_TORCH_PEAK_BYTES_PER_S", "7e9")
    assert profiling.detect_peak_flops() == 123e9
    assert profiling.detect_peak_bytes_per_s() == 7e9
    assert profiling.StepProfiler("probe_env").peak_flops == 123e9


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "dots"])
def test_wrap_step_counts_the_analytic_flops(remat):
    """One llama-debug step (B=2, L=64, unchunked loss): 6 FLOPs per
    parameter of every matrix product per token (forward, and the two
    products of each one's gradient), plus each layer's attention counted
    once from its shapes over the causal mask's kept pairs: the forward's
    two products, dQ's three and dK/dV's four, 2*D FLOPs each per pair,
    and under remat "dots" the forward's again (the recompute; the block's
    saved matrix products are not recomputed). Exact: both sides sum the
    same integers. A second call of the shape reuses the count."""
    cfg = dataclasses.replace(models.MODEL_REGISTRY["llama-debug"],
                              remat=remat, remat_policy="dots")
    B, L = 2, 64
    model = TransformerLM(cfg, device="meta")
    prof = profiling.StepProfiler("probe_wrap", emit_span=False)
    init_fn, step_fn, _ = parallel.make_train_fns(
        model, parallel.adamw(1e-3), batch_shape=(B, L + 1), device="cpu",
        profiler=prof)
    state = init_fn(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L + 1),
                           generator=torch.Generator().manual_seed(1))
    state, m = step_fn(state, tokens)
    n_mm = sum(p.numel() for n, p in model.named_parameters()
               if p.dim() == 2 and n != "embed")
    pairs = B * cfg.n_heads * L * (L + 1) // 2
    products = 2 + 3 + 4 + (2 if remat else 0)
    want = 6 * n_mm * B * L + \
        cfg.n_layers * 2 * cfg.head_dim * pairs * products
    assert prof.flops == want
    assert prof.last["tokens_per_s"] > 0 and prof.last["mfu"] > 0
    prof.set_cost(0.0)
    step_fn(state, tokens)
    assert prof.flops == want


@pytest.fixture(scope="module")
def tiny():
    shape = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=128, max_seq_len=128)
    jmodel = JaxLM(JaxConfig(**shape, dtype=jnp.float32,
                             param_dtype=jnp.float32, remat=False))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = TransformerLM(TransformerConfig(**shape, dtype=torch.float32),
                           device="cpu")
    tmodel.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, meta.unbox(params))))
    return jmodel, params, tmodel


def _decode_costs(engine):
    """Two requests, one arriving mid-decode: (FLOPs, bytes) of every
    profiled decode step, and the engine.decode spans' attrs."""
    rng = np.random.RandomState(0)
    events.drain()
    a = engine.submit(rng.randint(0, 128, 9), max_new_tokens=7)
    costs = []

    def step():
        n = engine.profiler.steps if engine.profiler else 0
        engine.step()
        if engine.profiler and engine.profiler.steps > n:
            costs.append((engine.profiler.flops,
                          engine.profiler.bytes_accessed))
    for _ in range(3):
        step()
    b = engine.submit(rng.randint(0, 128, 5), max_new_tokens=4)
    while not (a.finish_reason and b.finish_reason):
        step()
    return costs


def test_engine_decode_attribution_equals_jax(tiny):
    """The port engine's per-step decode FLOPs and bytes (from each
    step's slot lengths) equal the JAX engine's, exactly; each
    engine.decode span carries the attribution; step_profile=False
    builds no profiler and its spans carry none."""
    jmodel, params, tmodel = tiny
    cfg = dict(n_slots=2, max_len=48, prefill_chunk=4, prefill_budget=8)
    want = _decode_costs(JaxEngine(jmodel, params, JaxEngineConfig(**cfg)))
    eng = InferenceEngine(tmodel, EngineConfig(**cfg), device="cpu")
    got = _decode_costs(eng)
    assert got == want and len(got) >= 6
    decs = [r["attrs"] for r in events.drain()
            if r.get("name") == "engine.decode"]
    slots = [r for r in decs if "mfu" in r]
    assert len(slots) == len(got)
    assert all({"compute_ms", "host_gap_ms", "data_wait_ms",
                "mfu_compute", "roofline_bound"} <= set(d) for d in slots)
    off = InferenceEngine(tmodel, EngineConfig(**cfg, step_profile=False),
                          device="cpu")
    h = off.submit([1, 2, 3], max_new_tokens=3)
    while not h.finish_reason:
        off.step()
    assert off.profiler is None
    decs = [r["attrs"] for r in events.drain()
            if r.get("name") == "engine.decode"]
    assert decs and all("mfu" not in d for d in decs)
