"""What each rank of the mesh tests' gloo worlds runs
(``tests/torch_world.py``).

JAX-free: the ranks import torch and the port only. Each case reads its
inputs (``inputs.pt``, written by the test before it starts the world: a
token batch, attention inputs, and weights converted from the JAX model
where the test compares with JAX; without them the weights come from the
port's initialisers and seed 0, on every rank alike) and
returns, from rank 0, whole tensors gathered from every layout it ran; the
test holds them against the single-process port and the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.models import MODEL_REGISTRY, TransformerLM
from ray_tpu_torch.models import generate as generate_lib
from ray_tpu_torch.ops import dispatch
from ray_tpu_torch.parallel import (MeshConfig, adafactor, adamw,
                                    load_params, make_infer_fns, make_mesh,
                                    make_train_fns, use_mesh)
from ray_tpu_torch.parallel.sharding import spec_to_placements

LAYOUTS = {
    "d4": MeshConfig(data=4, fsdp=1), "f4": MeshConfig(fsdp=4),
    "t4": MeshConfig(fsdp=1, tensor=4), "f2t2": MeshConfig(fsdp=2, tensor=2),
    "s2t2": MeshConfig(fsdp=1, seq=2, tensor=2),
    "s4": MeshConfig(fsdp=1, seq=4), "e2f2": MeshConfig(fsdp=2, expert=2),
    "e4": MeshConfig(fsdp=1, expert=4),
}


def config(name: str, recipe: bool = False):
    """fp32 everywhere, or the JAX bench's recipe (bf16 weights, remat
    "dots"); the JAX side uses the same fields."""
    cfg = MODEL_REGISTRY[name]
    if recipe:
        return dataclasses.replace(cfg, dtype=torch.bfloat16,
                                   param_dtype=torch.bfloat16, remat=True,
                                   remat_policy="dots")
    return dataclasses.replace(cfg, dtype=torch.float32, remat=False)


@contextlib.contextmanager
def one_thread():
    """Run the test process's own reference on one thread while the
    world's ranks run beside it (each on one thread too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def train(layouts, inputs, recipe=False, steps=3, optimizer=None):
    """Per layout: the metrics of each step, every gradient of the first
    step and every parameter after the last, as whole tensors. The
    optimizer is the recipe's ``adafactor(1e-2)`` or ``adamw(1e-3)``, or
    ``optimizer`` ("adafactor" in fp32)."""
    out = {}
    for name in layouts:
        mesh = make_mesh(LAYOUTS[name], "cpu") if name != "single" else None
        cfg = config(inputs["model"], recipe)
        model = TransformerLM(cfg, device="meta")
        opt = (adafactor(1e-2) if recipe or optimizer == "adafactor"
               else adamw(1e-3))
        tokens = torch.as_tensor(inputs["tokens"])
        init_fn, step_fn, shardings = make_train_fns(
            model, opt, mesh=mesh, batch_shape=tuple(tokens.shape),
            loss_chunk=16, device="cpu")
        state = init_fn(torch.Generator().manual_seed(0))
        if "weights" in inputs:
            load_params(model, inputs["weights"])
        metrics, grads = [], None
        for _ in range(steps):
            state, m = step_fn(state, tokens)
            metrics.append({k: float(v) for k, v in m.items()})
            if grads is None:
                grads = {n: _whole(p.grad).clone()
                         for n, p in model.named_parameters()}
        out[name] = {
            "metrics": metrics, "grads": grads,
            "params": {n: _whole(p.detach()).clone()
                       for n, p in model.named_parameters()},
            "placements": {n: tuple(p.placements)
                           for n, p in model.named_parameters()
                           if isinstance(p, DTensor)},
            "mesh_dims": mesh.mesh_dim_names if mesh is not None else ()}
    return out


def _case(layouts, recipe=False, steps=3, optimizer=None):
    def run(rank, world, workdir):
        inputs = torch.load(workdir / "inputs.pt", weights_only=False)
        return train(layouts, inputs, recipe, steps, optimizer)
    return run


train_dp = _case(("d4", "f4", "t4"))
train_f2t2 = _case(("f2t2",))
train_sp = _case(("s2t2", "d4"))

train_recipe = _case(("f2t2",), recipe=True)
train_adafactor = _case(("f2t2",), optimizer="adafactor")


def _spy(calls):
    """Record which attention body dispatch runs."""
    real = {n: getattr(dispatch, n) for n in
            ("ring_attention", "flash_attention", "mha_reference")}

    def wrap(n):
        def f(*a, **k):
            calls.append(n)
            return real[n](*a, **k)
        return f
    for n in real:
        setattr(dispatch, n, wrap(n))


def attention(rank, world, workdir):
    """Per layout and case: dispatch's output and the gradients of
    sum(out * dout) wrt q, k, v, with q/k/v given as DTensors sharded over
    seq (what the model hands it), and the bodies dispatch ran."""
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    calls = []
    _spy(calls)
    out = {}
    for layout, case, impl in inputs["runs"]:
        mesh = make_mesh(LAYOUTS[layout], "cpu")
        q, k, v, dout = inputs[case]
        place = spec_to_placements((None, "seq", None, None), mesh)
        with use_mesh(mesh):
            qkv = [distribute_tensor(x, mesh, place, src_data_rank=None)
                   .requires_grad_() for x in (q, k, v)]
            del calls[:]
            o = dispatch.attention(*qkv, causal=True, impl=impl)
            (_whole(o) * dout).sum().backward()
        out[(layout, case, impl)] = {
            "out": _whole(o).detach(),
            "grads": [_whole(x.grad) for x in qkv], "calls": list(calls)}
    return out


def serve(rank, world, workdir):
    """make_infer_fns' last-position logits and make_generate_fn's greedy
    tokens (when ``inputs["new"]`` asks for some) on each layout."""
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    prompt = torch.as_tensor(inputs["prompt"])
    B, P = prompt.shape
    out = {}
    for name in inputs["layouts"]:
        mesh = make_mesh(LAYOUTS[name], "cpu")
        model = TransformerLM(config(inputs["model"]), device="meta")
        init_fn, infer_fn, _ = make_infer_fns(model, mesh,
                                              batch_shape=(B, P),
                                              device="cpu")
        init_fn(torch.Generator().manual_seed(0))
        load_params(model, inputs["weights"])
        out[name] = {"logits": infer_fn(prompt),
                     "placements": {n: tuple(p.placements)
                                    for n, p in model.named_parameters()}}
        if inputs.get("new"):
            _, gen_fn = generate_lib.make_generate_fn(
                model, mesh, batch=B, prompt_len=P,
                max_new_tokens=inputs["new"], device="cpu")
            out[name]["tokens"] = gen_fn(prompt)
    return out


def drive_engine(engine, prompts, new, max_steps=400):
    """The same schedule for any engine (the JAX package's or the port's,
    with or without a mesh), stepped by the caller in lockstep: the first
    prompt is admitted and decodes its first token, then the rest arrive
    together (so a prompt sharing the first one's prefix hits the prefix
    cache). Returns every request's greedy tokens."""
    import queue

    def run(done):
        for _ in range(max_steps):
            engine.step()
            if done():
                return
        raise AssertionError("engine did not get there")

    handles = [engine.submit(prompts[0], max_new_tokens=new[0])]
    run(lambda: handles[0].first_token_t is not None)
    handles += [engine.submit(p, max_new_tokens=n)
                for p, n in zip(prompts[1:], new[1:])]
    run(lambda: all(h.finish_reason is not None for h in handles))
    out = []
    for h in handles:
        toks = []
        while True:
            try:
                toks.append(int(h.next(timeout=0)))
            except (StopIteration, queue.Empty):
                break
        out.append(toks)
    return out


def engine_spec(inputs, variant):
    """(EngineConfig kwargs, port spec) of one engine variant."""
    from ray_tpu_torch.models import TransformerConfig
    kw = dict(inputs["engine"])
    if variant == "int8":
        kw.update(prefix_cache_slots=2, kv_quant="int8")
    spec = None
    if variant == "spec":
        weights = inputs["draft_weights"]
        spec = {"draft_model": TransformerConfig(**inputs["draft"],
                                                 dtype=torch.float32),
                "k": inputs["k"], "draft_params_fn": lambda: weights}
    return kw, spec


def _engine_layouts(eng):
    """{tensor: (mesh spec, DTensor placements)} of the engine's device
    tensors (a replicated tensor's spec is ``()``, as JAX prints it)."""
    specs = {"pool_k": eng._pool_spec, "pool_v": eng._pool_spec,
             "draft_pool_k": eng._draft_pool_spec,
             "draft_pool_v": eng._draft_pool_spec}
    named = {"pool_k": eng._pool_k, "pool_v": eng._pool_v,
             "draft_pool_k": eng._dpool_k, "draft_pool_v": eng._dpool_v,
             "blocks_k": eng._blocks_k, "blocks_v": eng._blocks_v,
             "blocks_k_scale": eng._blocks_ks,
             "blocks_v_scale": eng._blocks_vs}
    return {n: (tuple(specs.get(n) or ()), tuple(t.placements))
            for n, t in named.items() if t is not None}


def engine(rank, world, workdir):
    """The sharded engine in lockstep (every rank submits the same prompts
    and steps alike) on each variant of ``inputs["variants"]``: its greedy
    tokens and, under the mesh, its tensors' layouts."""
    from ray_tpu_torch.inference import EngineConfig, InferenceEngine
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = make_mesh(LAYOUTS[inputs["layout"]], "cpu")
    out = {}
    for variant in inputs["variants"]:
        model = TransformerLM(config(inputs["model"]), device="cpu")
        model.load_state_dict(inputs["weights"])
        kw, spec = engine_spec(inputs, variant)
        eng = InferenceEngine(model, EngineConfig(**kw), device="cpu",
                              mesh=mesh, spec=spec)
        out[variant] = {"tokens": drive_engine(eng, inputs["prompts"],
                                               inputs["new"]),
                        "placements": _engine_layouts(eng),
                        "weights": {n: tuple(p.placements)
                                    for n, p in model.named_parameters()},
                        "stats": eng.stats()}
    return out


moe_train = _case(("e2f2",), steps=4)


def _rel_l2(got, want) -> float:
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def assert_same_training(got, want, rtol=1e-4, atol=1e-6, bf16=False):
    """A layout's training against another's (the single-process port):
    every metric of every step at ``rtol``; every gradient of the first
    step at ``rtol``/``atol``, as ``tests/test_torch_train_step.py`` holds
    the port's gradients to JAX's; every parameter after the last step by
    its relative L2 distance at ``rtol``, as ``tests/
    test_torch_moe_train.py`` holds the parameters (Adam's update of an
    entry whose gradient is ~0 turns summation-order noise into steps of
    up to the learning rate, so single entries are not compared). With
    ``bf16`` (the recipe) the metrics and parameters are held, as
    ``tests/test_torch_moe_train.py`` holds the recipe, and the gradients
    are not: a bf16 gradient is the sum of bf16 partial products, and on
    llama-debug those of one bf16 step lie 2.4% (relative L2) from the
    fp32 step's, so two summation orders of it differ by as much."""
    assert len(got["metrics"]) == len(want["metrics"])
    for g, w in zip(got["metrics"], want["metrics"]):
        for key in ("loss", "total_loss", "moe_aux", "grad_norm", "tokens"):
            torch.testing.assert_close(g[key], w[key], rtol=rtol, atol=0.0,
                                       msg=key)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, w in want["grads"].items() if not bf16 else ():
        torch.testing.assert_close(got["grads"][name].float(), w.float(),
                                   rtol=rtol, atol=atol, msg=f"grad {name}")
    assert sorted(got["params"]) == sorted(want["params"])
    for name, w in want["params"].items():
        rel = _rel_l2(got["params"][name], w)
        assert rel < rtol, (name, rel)
