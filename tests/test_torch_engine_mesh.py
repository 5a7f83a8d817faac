"""The sharded engine against the JAX package: a gloo world of 4 ranks
runs ``InferenceEngine(mesh=fsdp 2 x tensor 2)`` in lockstep on
llama-debug in fp32, with weights converted from JAX's init. Its greedy
tokens must equal those of JAX's ``InferenceEngine(mesh=...)`` over 4
host devices on the same weights and those of the single-process port
engine, plain, with speculative decoding (a one-layer draft whose single
KV head does not divide the tensor axis) and with int8 prefix blocks (a
prompt that hits the cache). The pools' layouts are held to the JAX
engine's ``NamedSharding`` specs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from ray_tpu.inference import EngineConfig as JaxEngineConfig
from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from ray_tpu.models import TransformerLM as JaxLM
from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.parallel.train_step import make_infer_fns as jax_make_infer_fns
from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.models import TransformerLM, params_from_jax
from ray_tpu_torch.parallel.sharding import spec_to_placements
from tests import torch_mesh_cases as cases
from tests.torch_world import World

VARIANTS = ("plain", "spec", "int8")
ENGINE = dict(n_slots=4, max_len=96, prefill_chunk=16, prefill_budget=32)
DRAFT = dict(vocab_size=1024, d_model=64, n_layers=1, n_heads=2,
             n_kv_heads=1, d_ff=128, max_seq_len=512)
NEW = (8, 7, 9, 6)
JAX_ARRAYS = {"pool_k": "_pool_k", "pool_v": "_pool_v",
              "draft_pool_k": "_dpool_k", "draft_pool_v": "_dpool_v",
              "blocks_k": "_blocks_k", "blocks_v": "_blocks_v",
              "blocks_k_scale": "_blocks_ks", "blocks_v_scale": "_blocks_vs"}


def _state_dict(params):
    return params_from_jax(jax.tree.map(np.asarray, meta.unbox(params)))


def _prompts(vocab):
    """The second prompt shares the first one's two leading chunks."""
    rng = np.random.RandomState(1)
    prefix = rng.randint(0, vocab, 32)
    return [np.concatenate([prefix, rng.randint(0, vocab, 7)]),
            np.concatenate([prefix, rng.randint(0, vocab, 12)]),
            rng.randint(0, vocab, 23), rng.randint(0, vocab, 5)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("engine_mesh")
    jcfg = dataclasses.replace(JAX_REGISTRY["llama-debug"], dtype=jnp.float32,
                               param_dtype=jnp.float32)
    jmodel = JaxLM(jcfg)
    mesh = make_mesh(MeshConfig(fsdp=2, tensor=2), devices=jax.devices()[:4])
    jinit, _, _ = jax_make_infer_fns(jmodel, mesh, batch_shape=(1, 8))
    params = jinit(jax.random.PRNGKey(0))
    jdcfg = JaxConfig(**DRAFT, dtype=jnp.float32, param_dtype=jnp.float32,
                      remat=False)
    dparams = JaxLM(jdcfg).init(jax.random.PRNGKey(3),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    inputs = {"model": "llama-debug", "layout": "f2t2",
              "weights": _state_dict(params), "draft": DRAFT, "k": 3,
              "draft_weights": _state_dict(dparams), "engine": ENGINE,
              "prompts": _prompts(jcfg.vocab_size), "new": NEW,
              "variants": VARIANTS}
    torch.save(inputs, work / "inputs.pt")
    jax_out = {}
    with World("tests.torch_mesh_cases:engine", 4, work,
               timeout=240) as world:
        for variant in VARIANTS:
            kw, _ = cases.engine_spec(inputs, variant)
            spec = None
            if variant == "spec":
                spec = {"draft_model": jdcfg, "k": inputs["k"],
                        "draft_params_fn": lambda: dparams}
            eng = JaxEngine(jmodel, params, JaxEngineConfig(
                **kw, step_profile=False), mesh=mesh, spec=spec)
            # the layouts the engine allocates (XLA may lay out the
            # arrays its programs return otherwise)
            specs = {n: tuple(getattr(eng, a).sharding.spec)
                     for n, a in JAX_ARRAYS.items()
                     if getattr(eng, a, None) is not None}
            jax_out[variant] = {
                "tokens": cases.drive_engine(eng, inputs["prompts"], NEW),
                "specs": specs, "stats": eng.stats()}
        single = {}
        with cases.one_thread():
            for variant in VARIANTS:
                model = TransformerLM(cases.config("llama-debug"),
                                      device="cpu")
                model.load_state_dict(inputs["weights"])
                kw, spec = cases.engine_spec(inputs, variant)
                eng = InferenceEngine(model, EngineConfig(**kw),
                                      device="cpu", spec=spec)
                single[variant] = cases.drive_engine(eng, inputs["prompts"],
                                                     NEW)
        got = world.join()
    return got, jax_out, single


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_tokens_match_jax_and_single_process(results, variant):
    got, jax_out, single = results
    tokens = got[variant]["tokens"]
    assert [len(t) for t in tokens] == list(NEW)
    assert tokens == jax_out[variant]["tokens"]
    assert tokens == single[variant]


def test_prefix_hit_and_spec_counts_match_jax(results):
    """The int8 run restores the shared prefix from the cache and the
    spec run accepts as many drafts as JAX's, so the variants exercise
    what they name."""
    got, jax_out, _ = results
    st, jst = got["int8"]["stats"], jax_out["int8"]["stats"]
    assert st["prefix_hits"] == jst["prefix_hits"] >= 1
    assert st["kv_quant"] == "int8"
    st, jst = got["spec"]["stats"], jax_out["spec"]["stats"]
    assert st["spec_tokens_accepted"] == jst["spec_tokens_accepted"]
    assert st["spec_tokens_proposed"] == jst["spec_tokens_proposed"] > 0


SIZES = {"data": 1, "fsdp": 2, "expert": 1, "stage": 1, "seq": 1,
         "tensor": 2}


def _canon(spec):
    """A mesh spec without its axes of size 1 (XLA drops them from the
    specs of the arrays it returns: ``("data", "fsdp")`` reads ``"fsdp"``
    on this mesh) and without trailing replicated dims."""
    out = []
    for entry in spec:
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None and SIZES[a] > 1)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("variant", VARIANTS)
def test_pool_layouts_match_jax_named_shardings(results, variant):
    """Every device tensor the JAX engine lays out (the target pools, the
    draft pools pruned against the draft's one KV head, the replicated
    int8 blocks and scales) has the JAX spec, and its DTensor placements
    are that spec's on the port's mesh."""
    got, jax_out, _ = results
    port = got[variant]["placements"]
    jax_specs = jax_out[variant]["specs"]
    assert set(port) == set(jax_specs)
    from ray_tpu_torch.parallel import MeshConfig as PortMeshConfig
    port_mesh = PortMeshConfig(fsdp=2, tensor=2).resolve(4)
    for name, (spec, placements) in port.items():
        assert _canon(spec) == _canon(jax_specs[name]), name
        assert placements == spec_to_placements(spec, port_mesh), name
    if variant == "spec":
        assert _canon(port["draft_pool_k"][0]) == (None, "fsdp")
    if variant == "int8":
        assert port["blocks_k_scale"][0] == ()


def test_weights_are_distributed_over_the_mesh(results):
    """A model loaded with whole tensors is distributed in place, each
    parameter as ``state_shardings`` places it."""
    from ray_tpu_torch.parallel import MeshConfig as PortMeshConfig
    from ray_tpu_torch.parallel.train_step import state_shardings
    got, _, _ = results
    model = TransformerLM(cases.config("llama-debug"), device="meta")
    want = state_shardings(model, PortMeshConfig(fsdp=2, tensor=2).resolve(4))
    assert got["plain"]["weights"] == {n: p for n, (p, _) in want.items()}


def test_a_mesh_that_is_not_one_raises_as_jax():
    cfg = dataclasses.replace(cases.config("llama-debug"), n_layers=1)
    model = TransformerLM(cfg, device="cpu")
    with pytest.raises(AttributeError):
        InferenceEngine(model, EngineConfig(**ENGINE), device="cpu",
                        mesh=object())
