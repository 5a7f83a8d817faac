"""The Hopper kernels against their plain versions, on the card: the
flash-attention forward, the dQ and dK/dV backward kernels, and the
autograd Function that joins them; the edges of the bf16 tensor-core
tiling, fused-projection views, and the refusal of a view that TMA cannot
read.

Marked ``cuda``: they skip on a machine without a CUDA card. This file
imports neither JAX nor ray_tpu, so it runs on the card's machine:
``python -m pytest -m cuda tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as ops


def _qkv(seed, B, Lq, Lk, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Lq, H, D).astype(np.float32),
            rng.randn(B, Lk, Hkv, D).astype(np.float32),
            rng.randn(B, Lk, Hkv, D).astype(np.float32))


# tpu-7b prefill, llama-1b (D=64), ragged L, Lq != Lk both ways, fp32
CARD_CASES = [
    dict(B=2, Lq=512, Lk=512, H=32, Hkv=8, D=128, dtype=torch.bfloat16,
         causal=True),
    dict(B=2, Lq=256, Lk=256, H=32, Hkv=8, D=64, dtype=torch.bfloat16,
         causal=True),
    dict(B=2, Lq=200, Lk=200, H=8, Hkv=2, D=128, dtype=torch.bfloat16,
         causal=True),
    dict(B=1, Lq=130, Lk=300, H=4, Hkv=2, D=64, dtype=torch.bfloat16,
         causal=False),
    dict(B=1, Lq=300, Lk=130, H=4, Hkv=2, D=128, dtype=torch.bfloat16,
         causal=True),
    dict(B=2, Lq=200, Lk=200, H=4, Hkv=1, D=64, dtype=torch.float32,
         causal=True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_version_on_card(case):
    """On the card: the CUDA kernel against its plain version. fp32 at
    rtol = atol = 2e-3 (the JAX package's kernel bound); bf16 o at 2e-2,
    since o is stored in bf16 (one ulp is 2**-7 near 1) and p is rounded to
    bf16 against the running max in the kernel and the final max in the
    plain version; lse is fp32 in both, at 2e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = dict(case)
    dtype, causal = c.pop("dtype"), c.pop("causal")
    q, k, v = (torch.from_numpy(x).to("cuda", dtype)
               for x in _qkv(5, c["B"], c["Lq"], c["Lk"], c["H"], c["Hkv"],
                             c["D"]))
    before = ops.flash_attention_fwd.launches
    o, lse = ops.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.flash_attention_fwd.launches == before + 1
    ro, rlse = ops.flash_attention_fwd_reference(q, k, v, causal)
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, rlse, rtol=2e-3, atol=2e-3)


def _grad_inputs(case, seed):
    """q, k, v, dO on the card in the case's dtype, with the forward
    kernel's o and lse."""
    c = dict(case)
    dtype, causal = c.pop("dtype"), c.pop("causal")
    rng = np.random.RandomState(seed + 100)
    q, k, v = (torch.from_numpy(x).to("cuda", dtype)
               for x in _qkv(seed, c["B"], c["Lq"], c["Lk"], c["H"],
                             c["Hkv"], c["D"]))
    do = torch.from_numpy(rng.randn(c["B"], c["Lq"], c["H"], c["D"])
                          .astype(np.float32)).to("cuda", dtype)
    o, lse = ops.flash_attention_fwd(q, k, v, causal)
    return q, k, v, o, lse, do, causal


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_backward_kernels_match_plain_version_on_card(case):
    """On the card: the dQ and dK/dV kernels against their plain version
    on the same o and lse. fp32 at rtol = atol = 2e-3 (the same arithmetic
    in another order of sums); bf16 at a relative L2 error of 1e-2 per
    gradient, since dq/dk/dv are stored in bf16 (a relative step of up to
    2**-8) and ds is rounded to bf16 from fp32 values that differ in the
    last bits, so an elementwise bound would have to grow with L."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, o, lse, do, causal = _grad_inputs(case, 6)
    before = (ops.flash_attention_bwd_dq.launches,
              ops.flash_attention_bwd_dkv.launches)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (ops.flash_attention_bwd_dq.launches,
            ops.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = ops.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g.float()).all(), name
        if q.dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-3, msg=name)
        else:
            assert _rel_l2(g, w) < 1e-2, (name, _rel_l2(g, w))


# the bf16 tensor-core tiling's edges (128-row q tiles of two 64-row
# warpgroups in the forward and dQ, 128-key blocks of 64-row q tiles in
# dK/dV): a length that is a multiple of 64 but not of 128 (L=192: under
# the causal mask the 64-key tile after warpgroup 0's rows, and a
# warpgroup wholly past Lq), one shorter than a tile (L=17: the second
# warpgroup has no rows), Lq != Lk across a 128-row boundary both ways,
# causal and not, G in {1, 3, 4}, D in {64, 128}, and a warpgroup with no
# rows beside a key loop longer than the K/V ring
EDGE_CASES = [
    dict(B=2, Lq=192, Lk=192, H=8, Hkv=2, D=128, causal=True),
    dict(B=2, Lq=17, Lk=17, H=6, Hkv=2, D=64, causal=True),
    dict(B=1, Lq=129, Lk=257, H=8, Hkv=2, D=128, causal=True),
    dict(B=1, Lq=129, Lk=257, H=4, Hkv=4, D=64, causal=False),
    dict(B=1, Lq=257, Lk=129, H=6, Hkv=2, D=128, causal=True),
    dict(B=1, Lq=257, Lk=129, H=4, Hkv=1, D=64, causal=False),
    # dQ's second warpgroup has no rows (Lq=130) while its 16 K/V tiles
    # wrap the 3-stage ring many times
    dict(B=2, Lq=130, Lk=1024, H=24, Hkv=8, D=128, causal=False),
]


def _edge_inputs(case, seed, fused=False):
    """bf16 q, k, v, dO on the card; with fused, q, k and v are strided
    views of one [B, L, H + 2 Hkv, D] tensor (Lq == Lk), as a fused QKV
    projection gives them."""
    c = dict(case)
    B, Lq, Lk, H, Hkv, D = (c[n] for n in ("B", "Lq", "Lk", "H", "Hkv",
                                             "D"))
    rng = np.random.RandomState(seed)
    if fused:
        qkv = torch.from_numpy(rng.randn(B, Lq, H + 2 * Hkv, D)
                               .astype(np.float32)).to("cuda", torch.bfloat16)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    else:
        q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                   for x in _qkv(seed, B, Lq, Lk, H, Hkv, D))
    do = torch.from_numpy(rng.randn(B, Lq, H, D).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    return q, k, v, do, c["causal"]


def _check_edge(q, k, v, do, causal):
    """Forward and both backward kernels against their plain versions, at
    the bounds of the tests above: bf16 o at 2e-2, lse at 2e-3, each
    gradient at a relative L2 error of 1e-2."""
    launches = ops.flash_attention_fwd.launches
    o, lse = ops.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.flash_attention_fwd.launches == launches + 1
    ro, rlse = ops.flash_attention_fwd_reference(q, k, v, causal)
    torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, rlse, rtol=2e-3, atol=2e-3)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = ops.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g.float()).all(), name
        assert _rel_l2(g, w) < 1e-2, (name, _rel_l2(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_tensor_core_tiling_edges_on_card(case):
    """On the card: the bf16 tensor-core kernels at the edges of their
    tiling, against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check_edge(*_edge_inputs(case, 9))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_fused_projection_views_on_card(D):
    """On the card: q, k, v as views of one fused projection, whose TMA
    tensor maps get non-trivial (batch, seq, head) strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    case = dict(B=2, Lq=200, Lk=200, H=6, Hkv=2, D=D, causal=True)
    q, k, v, do, causal = _edge_inputs(case, 10, fused=True)
    assert not q.is_contiguous() and q.stride(1) == 10 * D
    _check_edge(q, k, v, do, causal)


@pytest.mark.cuda
def test_stride_off_the_16_byte_rule_raises_on_card():
    """On the card: a bf16 view whose head stride is 260 bytes (not a
    multiple of 16) raises ValueError in the forward, the dQ and the dK/dV
    wrappers, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(2, 64, 8, 130, device="cuda",
                    dtype=torch.bfloat16)[..., :128]
    k = torch.zeros(2, 64, 2, 128, device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros(2, 8, 64, device="cuda")
    wrappers = (ops.flash_attention_fwd, ops.flash_attention_bwd_dq,
                ops.flash_attention_bwd_dkv)
    launches = [fn.launches for fn in wrappers]
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.flash_attention_fwd(q, k, k, True)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.flash_attention_bwd_dq(q, k, k, q.contiguous(), lse, lse, True)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.flash_attention_bwd_dkv(q, k, k, q.contiguous(), lse, lse, True)
    assert [fn.launches for fn in wrappers] == launches


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_on_card_matches_plain_version(causal):
    """fp32, GQA, ragged Lq != Lk: flash_attention's autograd Function on
    the card (forward kernel, then the two backward kernels) against torch
    autograd through the plain attention, at rtol = atol = 2e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = _qkv(7, 2, 150, 170, 8, 2, 64)
    do = torch.from_numpy(np.random.RandomState(8).randn(2, 150, 8, 64)
                          .astype(np.float32)).cuda()
    grads = []
    for fn in (ops.flash_attention, ops.mha_reference):
        q, k, v = (torch.from_numpy(x).cuda().requires_grad_()
                   for x in arrays)
        before = ops.flash_attention_bwd_dkv.launches
        out = fn(q, k, v, causal=causal)
        grads.append(torch.autograd.grad(out, (q, k, v), do))
        launched = ops.flash_attention_bwd_dkv.launches - before
        assert launched == (1 if fn is ops.flash_attention else 0)
    for g, w, name in zip(*grads, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-3, msg=name)


def _counted_step(device):
    """One step of a llama-debug-shaped recipe (bf16 weights, adafactor,
    remat "dots", chunked cross-entropy) through make_train_fns with a
    StepProfiler: (its FLOPs, the flash launches in the step)."""
    import dataclasses

    from ray_tpu_torch import models, parallel
    from ray_tpu_torch.util.profiling import StepProfiler
    cfg = dataclasses.replace(models.MODEL_REGISTRY["llama-debug"],
                              param_dtype=torch.bfloat16, remat=True,
                              remat_policy="dots")
    prof = StepProfiler("card_probe", emit_span=False)
    model = models.TransformerLM(cfg, device="meta")
    init_fn, step_fn, _ = parallel.make_train_fns(
        model, parallel.adafactor(1e-2), batch_shape=(2, 129),
        loss_chunk=32, device=device, profiler=prof)
    state = init_fn(torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    before = ops.flash_attention_fwd.launches
    step_fn(state, tokens)
    return prof.flops, ops.flash_attention_fwd.launches - before


@pytest.mark.cuda
def test_wrap_step_counts_the_same_on_card_and_cpu():
    """StepProfiler.wrap_step's FLOPs of one recipe step are equal on the
    card (the flash kernels, counted from their shapes) and on the CPU
    (their plain versions, whose products the count skips), exactly:
    both are sums of the same shape formulas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, launched = _counted_step("cuda")
    cpu, _ = _counted_step("cpu")
    assert launched == 4     # forward and recompute, 2 layers
    assert card > 0 and card == cpu


@pytest.mark.cuda
def test_step_scope_block_waits_for_the_card():
    """_StepScope.block returns only once the card has run the work that
    produced the tensors it was given (a nested dict and list), and on
    CPU tensors returns at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ray_tpu_torch.util.profiling import StepProfiler
    prof = StepProfiler("card_block", emit_span=False)
    x = torch.randn(4096, 4096, device="cuda")
    with prof.step() as s:
        s.data_ready()
        y = x
        for _ in range(20):
            y = y @ x
            y = y / y.norm()
        s.block({"out": [y], "cpu": torch.ones(2)})
        assert torch.cuda.current_stream().query()
    assert prof.last["compute_ms"] > 0
    with prof.step() as s:
        s.block({"cpu": torch.ones(2)})


@pytest.mark.cuda
def test_mesh_engine_equals_engine_on_card():
    """At llama-debug size (bf16) on the card, InferenceEngine over a
    one-card mesh (a world of one rank, NCCL) gives the same greedy
    tokens as the engine without a mesh, on requests that arrive while
    others decode. The engines attend through the cache and launch no
    flash kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ray_tpu_torch.inference import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import MODEL_REGISTRY, TransformerLM, init_params
    from ray_tpu_torch.parallel import MeshConfig, init_world, make_mesh
    cfg = MODEL_REGISTRY["llama-debug"]
    weights = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
    init_world(device="cuda")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (10, 37, 70, 5)]
    out = {}
    for name in ("no mesh", "mesh"):
        mesh = make_mesh(MeshConfig(fsdp=1), "cuda") if name == "mesh" \
            else None
        model = TransformerLM(cfg, device="meta")
        model.load_state_dict({k: v.clone() for k, v in weights.items()},
                              assign=True)
        eng = InferenceEngine(model, EngineConfig(
            n_slots=4, max_len=256, prefill_chunk=32, prefill_budget=64),
            device="cuda", mesh=mesh)
        before = ops.flash_attention_fwd.launches
        hs = [eng.submit(p, max_new_tokens=12) for p in prompts[:3]]
        while hs[0].first_token_t is None:
            eng.step()
        hs.append(eng.submit(prompts[3], max_new_tokens=9))
        for _ in range(400):
            if all(h.finish_reason for h in hs):
                break
            eng.step()
        out[name] = [h.tokens() for h in hs]
        assert ops.flash_attention_fwd.launches == before
    assert [len(t) for t in out["mesh"]] == [12, 12, 12, 9]
    assert out["mesh"] == out["no mesh"]


# RL learners: the update on the card equals the same update on the CPU
# from the same weights and batch, fp32 with TF32 off. Weights to 1e-4
# (chip_smoke.py's RL_WEIGHT_TOL: the two devices sum in another order,
# and an Adam step where a gradient sits at that rounding level moves by
# a share of the learning rate)
RL_CFG = dict(obs_shape=[4], action_spec={"type": "discrete", "n": 2},
              hidden_sizes=(64, 64), lr=3e-4, grad_clip=0.5, clip_param=0.2,
              vf_loss_coeff=0.5, entropy_coeff=0.01, minibatch_size=128,
              num_epochs=6, seed=0, gamma=0.99, lambda_=0.95, tau=0.005,
              initial_alpha=0.2, target_entropy=None)


def _max_state_diff(a, b):
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)


@pytest.mark.cuda
def test_ppo_learner_update_on_card_equals_cpu():
    """PPO's whole update_from_batch (6 epochs x 4 minibatches of 128, the
    CartPole net) on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ray_tpu_torch.rl.learner import TorchLearner
    rng = np.random.default_rng(0)
    n = 512
    batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int64),
             "logp": (np.log(0.5) + 0.3 * rng.normal(size=n))
             .astype(np.float32),
             "advantages": rng.normal(size=n).astype(np.float32),
             "value_targets": rng.normal(size=n).astype(np.float32)}
    out = {}
    for dev in ("cpu", "cuda"):
        learner = TorchLearner({**RL_CFG, "learner_device": dev}, 4, 2)
        assert next(learner.module.net.parameters()).device.type == dev
        m = learner.update_from_batch(batch)
        assert m["num_minibatch_updates"] == 24
        out[dev] = (learner.module.net.state_dict(), m["total_loss"])
    assert _max_state_diff(out["cpu"][0], out["cuda"][0]) <= 1e-4
    assert abs(out["cpu"][1] - out["cuda"][1]) <= 1e-4


@pytest.mark.cuda
def test_sac_learner_update_on_card_equals_cpu():
    """4 SAC steps (critics, actor on the updated critics, alpha, polyak)
    with the same normal draws given to both devices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ray_tpu_torch.rl.sac import SACLearner
    rng = np.random.default_rng(1)
    mbs = [{"obs": rng.normal(size=(128, 3)).astype(np.float32),
            "actions": np.tanh(rng.normal(size=(128, 1))).astype(np.float32),
            "rewards": rng.normal(size=128).astype(np.float32),
            "dones": (rng.random(128) < 0.05).astype(np.float32),
            "next_obs": rng.normal(size=(128, 3)).astype(np.float32)}
           for _ in range(4)]
    noise = [torch.from_numpy(rng.normal(size=(2, 128, 1))
                              .astype(np.float32)) for _ in range(4)]
    out = {}
    for dev in ("cpu", "cuda"):
        learner = SACLearner({**RL_CFG, "learner_device": dev}, 3, 1)
        for mb, z in zip(mbs, noise):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in mb.items()}
            z = z.to(dev)
            learner.update(batch, torch.ones(128, device=dev), z[0], z[1])
        out[dev] = {**{f"pi.{k}": v for k, v in
                       learner.pi.state_dict().items()},
                    **{f"q.{k}": v for k, v in
                       learner.q.state_dict().items()},
                    **{f"t.{k}": v for k, v in
                       learner.q_target.state_dict().items()},
                    "log_alpha": learner.log_alpha.detach()}
    assert _max_state_diff(out["cpu"], out["cuda"]) <= 1e-4


@pytest.mark.cuda
def test_iter_torch_batches_on_card_equal_cpu_batches():
    """Data's device feed on the card: 64 batches of int32 token rows
    through iter_torch_batches(device="cuda", device_prefetch=4), each
    read on the consumer's stream the moment it is handed out while a
    matmul keeps the card busy, equal bit for bit to the same batches on
    the CPU (a pinned host buffer reused before its copy had finished
    would show here as a wrong batch, with no error)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    rt.init(num_cpus=2, object_store_memory=512 * 2 ** 20)
    try:
        rng = np.random.default_rng(64)
        tokens = rng.integers(0, 32000, (64 * 32, 257)).astype(np.int32)
        ds = data.from_numpy(tokens, "tokens", parallelism=8)
        cpu = list(ds.iter_torch_batches(batch_size=32, device="cpu",
                                         dtypes=torch.int64))
        a = torch.randn(1024, 1024, device="cuda")
        got = []
        for b in ds.iter_torch_batches(batch_size=32, device="cuda",
                                       dtypes=torch.int64,
                                       device_prefetch=4):
            got.append(b["tokens"].clone())
            torch.mm(a, a)
        torch.cuda.synchronize()
        assert len(got) == len(cpu) == 64
        for g, c in zip(got, cpu):
            assert g.device.type == "cuda" and g.dtype == torch.int64
            assert torch.equal(g.cpu(), c["tokens"])
        assert torch.equal(torch.cat([c["tokens"] for c in cpu]),
                           torch.from_numpy(tokens).long())
    finally:
        rt.shutdown()
