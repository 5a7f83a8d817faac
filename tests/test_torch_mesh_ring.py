"""Ring attention and the attention dispatch under a mesh: a gloo world of
4 ranks against the JAX package's shard_map ring on the same layouts.

One world runs every case (``tests/torch_mesh_cases.py:attention``): q/k/v
sharded over seq as DTensors go through ``ops.dispatch.attention`` on a
seq-4 mesh (the ring over four ranks, MHA and 4:1 GQA) and a seq 2 x
tensor 2 mesh (auto picks the ring, heads over tensor; ``sharded_local``
forced; an odd length falls back to plain attention). The output is held
against the JAX dispatch on the same mesh over the host devices at the
2e-3 bound of ``tests/test_model_parallel.py``, and the body it runs
(ring, flash or plain attention) is the one the JAX dispatch runs; the
gradients of
sum(out * dout), which flow back through the ring's ``ppermute``, against
autograd of the port's plain attention, in fp32 at 1e-4."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import dispatch as jax_dispatch
from ray_tpu.parallel import MeshConfig as JaxMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel.mesh import use_mesh as jax_use_mesh
from ray_tpu_torch.ops import mha_reference
from tests.torch_world import World

CASES = {            # B, L, H, Hkv, D
    "mha": (2, 128, 4, 4, 32),
    "gqa": (1, 64, 8, 2, 16),
    "odd": (2, 65, 4, 2, 16),
}
RUNS = [("s4", "mha", "auto"), ("s4", "gqa", "auto"),
        ("s2t2", "gqa", "auto"), ("s2t2", "mha", "sharded_local"),
        ("s2t2", "odd", "auto")]
JAX_LAYOUTS = {"s4": dict(fsdp=1, seq=4), "s2t2": dict(fsdp=1, seq=2,
                                                       tensor=2)}
# what dispatch must run in each case: the JAX rules
BODY = {("s4", "mha", "auto"): "ring_attention",
        ("s4", "gqa", "auto"): "ring_attention",
        ("s2t2", "gqa", "auto"): "ring_attention",
        ("s2t2", "mha", "sharded_local"): "flash_attention",
        ("s2t2", "odd", "auto"): "mha_reference"}


@contextlib.contextmanager
def _spy_jax():
    """Record which attention body the JAX dispatch runs."""
    calls = []
    real = {n: getattr(jax_dispatch, n) for n in BODY.values()}

    def wrap(n):
        def f(*a, **k):
            calls.append(n)
            return real[n](*a, **k)
        return f
    for n in real:
        setattr(jax_dispatch, n, wrap(n))
    try:
        yield calls
    finally:
        for n, f in real.items():
            setattr(jax_dispatch, n, f)


def _inputs(case, seed):
    B, L, H, Hkv, D = CASES[case]
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in
            ((B, L, H, D), (B, L, Hkv, D), (B, L, Hkv, D), (B, L, H, D))]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("ring")
    arrays = {c: _inputs(c, i) for i, c in enumerate(CASES)}
    torch.save({"runs": RUNS, **{c: [torch.from_numpy(a) for a in v]
                                 for c, v in arrays.items()}},
               work / "inputs.pt")
    with World("tests.torch_mesh_cases:attention", 4, work,
               timeout=300) as world:
        # the JAX side and the plain references while the world runs
        want = {}
        for layout, case, impl in RUNS:
            q, k, v, dout = arrays[case]
            mesh = jax_make_mesh(JaxMeshConfig(**JAX_LAYOUTS[layout]),
                                 devices=jax.devices()[:4])
            with jax_use_mesh(mesh), _spy_jax() as calls:
                jout = jax_dispatch.attention(
                    jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, impl=impl)
            # the JAX dispatch picks the body the port must pick
            assert calls == [BODY[(layout, case, impl)]], calls
            tq, tk, tv = (torch.from_numpy(x).requires_grad_()
                          for x in (q, k, v))
            (mha_reference(tq, tk, tv) * torch.from_numpy(dout)).sum() \
                .backward()
            want[(layout, case, impl)] = (np.asarray(jout),
                                          [t.grad for t in (tq, tk, tv)])
        got = world.join()
    return got, want


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "-".join(r))
def test_dispatch_matches_jax(results, run):
    got, want = results
    np.testing.assert_allclose(got[run]["out"].numpy(), want[run][0],
                               rtol=2e-3, atol=2e-3)
    assert got[run]["calls"] == [BODY[run]]


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "-".join(r))
def test_grads_match_plain_attention(results, run):
    got, want = results
    for g, w, name in zip(got[run]["grads"], want[run][1], "qkv"):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                   msg=f"d{name}")
