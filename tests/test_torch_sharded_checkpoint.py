"""The port's sharded checkpoints (ray_tpu_torch/train/
sharded_checkpoint.py, on torch.distributed.checkpoint) against the JAX
package's (orbax), on the CPU at llama-debug size:

- the two cases of tests/test_sharded_checkpoint.py in a gloo world of 4
  ranks: a roundtrip on the ZeRO-3 layout (every shard and placement
  back, the next step's loss the same) and a restore into the fsdp x
  tensor layout (the whole tensors the same, a finite loss);
- parameters trained 2 AdamW steps in each package from the same
  converted weights, saved and restored by each package: each restore
  exact, and the two within the relative L2 distance of 1e-4 that the
  port's training parity tests hold parameters to after steps;
- ``restore_from_broadcast`` and ``restore_stage_shard(broadcast=True)``
  as tests/test_weight_broadcast.py:260 and
  tests/test_pipeline_elastic.py:416 test them;
- a remote MPMD stage restored from ``storage_path`` through the weight
  plane: the actor's state digest is the saved stage's.

Checkpoints of the two packages cannot read each other's files, so
parity is held on values."""

import dataclasses

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.train import sharded_checkpoint as sc
from tests.torch_world import World

B, L = 8, 32


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tests import torch_mesh_cases as cases
    work = tmp_path_factory.mktemp("ckpt")
    vocab = cases.config("llama-debug").vocab_size
    torch.save({"tokens": np.random.RandomState(1).randint(
        0, vocab, (B, L + 1))}, work / "inputs.pt")
    with World("tests.torch_checkpoint_cases:layouts", 4, work,
               timeout=300) as w:
        return w.join()


def test_sharded_save_restore_roundtrip(world):
    """Every shard and its placement come back, and the restored model's
    next loss is the trained model's (1e-6, as the JAX case)."""
    from torch.distributed.tensor import Shard
    assert world["step"] == 1
    assert world["shards_equal"]
    for n, t in world["saved"].items():
        assert torch.equal(world["same"][n], t), n
        assert torch.equal(world["host"]["params"][n], t), n
    assert world["placements"]["layers.0.attn.q"][0] == (Shard(0),)
    trained, same, _ = world["loss"]
    assert abs(trained - same) < 1e-6


def test_restore_into_different_layout(world):
    """Saved on fsdp=4, restored on fsdp=2 x tensor=2: the same whole
    tensors, laid out as the target says, and a finite loss."""
    from torch.distributed.tensor import Shard
    for n, t in world["saved"].items():
        assert torch.equal(world["other"][n], t), n
    assert len(world["placements"]["layers.0.attn.q"][1]) == 2
    assert Shard(1) in world["placements"]["layers.0.attn.q"][1]
    assert 0.0 < world["loss"][2] < 20.0


def test_trained_params_roundtrip_like_the_jax_package(tmp_path):
    """2 AdamW(1e-3) steps in each package from the same converted
    weights; each saves and restores its parameters. Each restore is
    exact, and each restored parameter is within a relative L2 distance
    of 1e-4 of the other package's (the bound of tests/test_torch_mpmd.py
    and tests/torch_mesh_cases.py: Adam's update of an entry whose
    gradient is ~0 turns fp32 summation-order noise into steps of up to
    the learning rate)."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax.core import meta

    from ray_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from ray_tpu.models import TransformerLM as JaxLM
    from ray_tpu.parallel import MeshConfig, make_mesh
    from ray_tpu.parallel import train_step as jax_train
    from ray_tpu.train import sharded_checkpoint as jsc
    from ray_tpu_torch.models import (MODEL_REGISTRY, TransformerLM,
                                      params_from_jax)
    from ray_tpu_torch.parallel import adamw, make_train_fns

    b, l = 2, 24
    jcfg = dataclasses.replace(JAX_REGISTRY["llama-debug"],
                               dtype=jnp.float32, param_dtype=jnp.float32,
                               remat=False)
    tcfg = dataclasses.replace(MODEL_REGISTRY["llama-debug"],
                               dtype=torch.float32)
    tokens = np.random.RandomState(2).randint(0, tcfg.vocab_size,
                                              (b, l + 1))
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, seq=1, tensor=1),
                     devices=jax.devices()[:1])
    init, step, _ = jax_train.make_train_fns(
        JaxLM(jcfg), optax.adamw(1e-3), mesh, batch_shape=(b, l + 1),
        loss_chunk=16)
    jstate = init(jax.random.PRNGKey(0))
    first = jax.tree.map(np.asarray, meta.unbox(jstate.params))

    model = TransformerLM(tcfg, device="meta")
    init_fn, step_fn, _ = make_train_fns(model, adamw(1e-3),
                                         batch_shape=(b, l + 1),
                                         loss_chunk=16, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(first))
    for _ in range(2):
        jstate, _ = step(jstate, jnp.asarray(tokens))
        state, _ = step_fn(state, torch.from_numpy(tokens))

    jpath = jsc.save_sharded(jstate.params, str(tmp_path / "jax"))
    jback = jsc.restore_sharded(jpath, jsc.abstract_like(jstate.params))
    want = params_from_jax(jax.tree.map(np.asarray, meta.unbox(jback)))
    sd = {n: t.detach().clone() for n, t in model.state_dict().items()}
    tpath = sc.save_sharded(sd, str(tmp_path / "torch"))
    got = sc.restore_sharded(tpath, sc.abstract_like(sd))
    assert sorted(got) == sorted(want)
    jflat = jax.tree.leaves(meta.unbox(jstate.params))
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax.tree.leaves(meta.unbox(jback)), jflat))
    for n, t in got.items():
        assert torch.equal(t, sd[n]), n
        rel = ((t - want[n]).norm() / want[n].norm()).item()
        assert rel < 1e-4, (n, rel)


def test_restore_from_broadcast_places_leaves(monkeypatch):
    """No target: the broadcast tree comes back as it is; with one, each
    tensor takes the target's dtype."""
    tree = {"w": torch.ones(4), "b": torch.zeros(2)}
    monkeypatch.setattr(rt, "get", lambda ref: tree)
    assert sc.restore_from_broadcast("ref") is tree
    target = {"w": torch.empty(4, dtype=torch.bfloat16),
              "b": torch.empty(2, dtype=torch.float32)}
    placed = sc.restore_from_broadcast("ref", target)
    assert placed["w"].dtype == torch.bfloat16
    assert placed["b"].dtype == torch.float32
    assert torch.equal(placed["w"].float(), tree["w"])


def test_stage_shard_broadcast_and_put_fallback(tmp_path, monkeypatch):
    """restore_stage_shard(broadcast=True) routes the shard through
    broadcast_weights, and through a plain put when the weight plane
    raises; without broadcast it returns the snapshot."""
    snap = {"step": 7, "params": {"w": torch.arange(6.0)}}
    sc.save_stage_shard(str(tmp_path), 1, snap)
    assert sc.restore_stage_shard(str(tmp_path), 1)["step"] == 7
    monkeypatch.setattr(rt, "broadcast_weights", lambda w: ("REF", w))
    kind, got = sc.restore_stage_shard(str(tmp_path), 1, broadcast=True)
    assert kind == "REF" and torch.equal(got["params"]["w"],
                                         snap["params"]["w"])

    def down(w):
        raise RuntimeError("no data plane")
    monkeypatch.setattr(rt, "broadcast_weights", down)
    monkeypatch.setattr(rt, "put", lambda v: ("PUT", v))
    kind, got = sc.restore_stage_shard(str(tmp_path), 1, broadcast=True)
    assert kind == "PUT" and got["step"] == 7


def test_remote_stage_restored_from_storage_through_the_weight_plane(
        tmp_path):
    """With actor stages and no snapshot left, the trainer's restore
    ladder reads the stage's durable shard and hands it over as a
    weight-plane ref; the replacement actor built from it holds the saved
    stage's state, digest for digest."""
    from ray_tpu_torch.train import (ActorStageHandle, MPMDConfig,
                                     MPMDPipelineTrainer)
    from tests import torch_runtime_cases as cases
    builders = [cases.tanh_stage] * cases.S
    local = MPMDPipelineTrainer(builders,
                                MPMDConfig(n_microbatches=cases.M))
    local.fit(cases.tanh_data, 2)
    local._checkpoint_all(2)
    want = local.state_digests()
    for s in range(cases.S):
        sc.save_stage_shard(str(tmp_path), s, local._resolve_snap(s))
    rt.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    try:
        tr = MPMDPipelineTrainer(
            builders, MPMDConfig(n_microbatches=cases.M,
                                 storage_path=str(tmp_path)), remote=True)
        src = tr._restore_source(1)
        assert isinstance(src, rt.ObjectRef)
        h = ActorStageHandle.provision(1, cases.S, cases.M,
                                       cases.tanh_stage, src)
        try:
            assert h.fetch(h.state_digest(), timeout=120) == [want[1]]
        finally:
            h.kill()
    finally:
        rt.shutdown()
