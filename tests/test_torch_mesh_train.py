"""Sharded training on the CPU: a gloo world of 4 ranks trains llama-debug
in fp32 on the data-parallel (d4), ZeRO-3 (f4) and tensor-parallel (t4)
layouts, three AdamW steps each through ``make_train_fns(mesh=...)``, and
every metric, first-step gradient and final parameter is held to the
single-process port from the same seeded weights and batch
(``tests/torch_mesh_cases.py:assert_same_training``, rtol 1e-4). On t4,
llama-debug's 2 KV heads do not divide over tensor, so k and v stay
replicated, as in the JAX step."""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from tests import torch_mesh_cases as cases
from tests.torch_world import World

B, L = 8, 64


def token_inputs(name="llama-debug", seed=1):
    vocab = cases.config(name).vocab_size
    return {"model": name, "tokens": np.random.RandomState(seed).randint(
        0, vocab, (B, L + 1))}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("train")
    inputs = token_inputs()
    torch.save(inputs, work / "inputs.pt")
    with World("tests.torch_mesh_cases:train_dp", 4, work,
               timeout=300) as world:
        with cases.one_thread():
            single = cases.train(("single",), inputs)["single"]
        got = world.join()
    return single, got


@pytest.mark.parametrize("layout", ["d4", "f4", "t4"])
def test_layout_matches_single_process(results, layout):
    single, got = results
    cases.assert_same_training(got[layout], single)
    assert got[layout]["metrics"][-1]["loss"] < \
        got[layout]["metrics"][0]["loss"]


def test_placements(results):
    _, got = results
    pl = got["t4"]["placements"]
    assert pl["layers.0.attn.q"] == (Shard(1),)      # 4 heads over 4
    assert pl["layers.0.attn.k"] == (Replicate(),)   # 2 KV heads do not
    assert pl["layers.0.mlp.down"] == (Shard(0),)
    assert got["f4"]["placements"]["layers.0.attn.q"] == (Shard(0),)
    assert set(got["d4"]["placements"].values()) == {(Replicate(),)}
