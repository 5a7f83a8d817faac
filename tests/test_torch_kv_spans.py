"""KV span hand-off between ray_tpu_torch's engine and ray_tpu's on the
CPU.

The tiny fp32 config of tests/test_torch_engine.py with the same weights
on both sides, the prefix cache on, full-precision or int8 blocks: spans
exported by either engine and imported into a fresh engine of the other
package give the exporter's greedy tokens."""

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
from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.models import (TransformerConfig, TransformerLM,
                                  params_from_jax)

ENGINE = dict(n_slots=2, max_len=48, prefill_chunk=4, prefill_budget=8)


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


def _jax_engine(tiny, **kw):
    jmodel, params, _ = tiny
    return JaxEngine(jmodel, params, JaxEngineConfig(
        **{**ENGINE, **kw}, step_profile=False))


def _port_engine(tiny, **kw):
    return InferenceEngine(tiny[2], EngineConfig(**{**ENGINE, **kw}),
                           device="cpu")


def _drain(eng, handle, max_steps=300):
    for _ in range(max_steps):
        eng.step()
        if handle.finish_reason is not None:
            return handle.tokens()
    raise AssertionError("request did not finish")


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_exported_spans_import_across_packages(tiny, kv_quant, direction):
    """An engine prefills a prompt and exports its blocks; a fresh engine
    of the other package imports them and serves the prompt from them
    (prefix_matched 16, no prefill over the imported range) with the
    exporter's greedy tokens. The span format is the JAX engine's: (k, v),
    or (qk, qv, ks, vs) under int8, of shape [n_layers, 1, chunk, Hkv,
    D]."""
    kw = dict(prefix_cache_slots=2, kv_quant=kv_quant)
    make = {"jax": _jax_engine, "port": _port_engine}
    src, dst = direction.split("_to_")
    exporter, importer = make[src](tiny, **kw), make[dst](tiny, **kw)
    prompt = np.random.RandomState(11).randint(0, 128, 19)
    want = _drain(exporter, exporter.submit(prompt, max_new_tokens=8))
    covered, spans = exporter.export_kv_blocks(prompt)
    assert covered == 16 and len(spans) == 4
    assert len(spans[0]) == (4 if kv_quant == "int8" else 2)
    assert np.asarray(spans[0][0]).shape == (2, 1, 4, 2, 16)
    assert importer.import_kv_blocks(prompt, spans) == 16
    h = importer.submit(prompt, max_new_tokens=8)
    assert _drain(importer, h) == want
    assert h.prefix_matched == 16
    assert importer.stats()["kv_imports"] == 1


@pytest.fixture(scope="module")
def tiny_bf16():
    """The tiny config in bf16 on both sides (fp32 weights, bf16 compute
    and a bf16 slot and block pool), the same weights."""
    shape = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=128, max_seq_len=128)
    jmodel = JaxLM(JaxConfig(**shape, dtype=jnp.bfloat16,
                             param_dtype=jnp.float32, remat=False))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = TransformerLM(TransformerConfig(**shape, dtype=torch.bfloat16),
                           device="cpu")
    tmodel.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, meta.unbox(params))))
    return jmodel, params, tmodel


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bf16_spans_cross_as_two_byte_arrays(tiny_bf16, direction):
    """A bf16 pool's spans go out as ``ml_dtypes.bfloat16`` arrays, 2 bytes
    per element, from either package (the port's by a bit view of its
    pool, not through fp32), and the other package's engine imports them
    and serves the prompt from them with the exporter's greedy tokens;
    the imported blocks hold the exporter's bits."""
    kw = dict(prefix_cache_slots=2)
    make = {"jax": _jax_engine, "port": _port_engine}
    src, dst = direction.split("_to_")
    exporter, importer = make[src](tiny_bf16, **kw), make[dst](tiny_bf16,
                                                               **kw)
    prompt = np.random.RandomState(12).randint(0, 128, 19)
    want = _drain(exporter, exporter.submit(prompt, max_new_tokens=8))
    covered, spans = exporter.export_kv_blocks(prompt)
    assert covered == 16 and len(spans) == 4
    for k, v in spans:
        for x in (k, v):
            assert str(x.dtype) == "bfloat16" and x.dtype.itemsize == 2
            assert x.shape == (2, 1, 4, 2, 16)
    assert importer.import_kv_blocks(prompt, spans) == 16
    h = importer.submit(prompt, max_new_tokens=8)
    assert _drain(importer, h) == want
    assert h.prefix_matched == 16
    # the port's block pool holds the spans' bits exactly
    port = importer if dst == "port" else exporter
    back = port.export_kv_blocks(prompt)[1]
    for (k0, v0), (k1, v1) in zip(spans, back):
        np.testing.assert_array_equal(k0.view(np.int16), k1.view(np.int16))
        np.testing.assert_array_equal(v0.view(np.int16), v1.view(np.int16))
