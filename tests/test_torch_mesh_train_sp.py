"""Sequence-parallel training on the CPU: a gloo world of 4 ranks trains
llama-debug in fp32 on seq 2 x tensor 2, where attention is the ring
(``ops/ring_attention.py``, K/V passed around with the differentiable
``ppermute``) and the activations are sharded over seq between blocks,
and on d4 for ``tests/test_model_parallel.py::test_layouts_agree``'s
check. Both are held to the single-process port from the same seeded
weights and batch (``assert_same_training``, rtol 1e-4), and to each
other at that test's 2e-2."""

import numpy as np
import pytest

from tests import torch_mesh_cases as cases
from tests.test_torch_mesh_train import token_inputs
from tests.torch_world import World


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp")
    inputs = token_inputs()
    import torch
    torch.save(inputs, work / "inputs.pt")
    with World("tests.torch_mesh_cases:train_sp", 4, work,
               timeout=300) as world:
        with cases.one_thread():
            single = cases.train(("single",), inputs)["single"]
        got = world.join()
    return single, got


def test_s2t2_matches_single_process(results):
    single, got = results
    cases.assert_same_training(got["s2t2"], single)
    assert got["s2t2"]["mesh_dims"] == ("seq", "tensor")


def test_layouts_agree(results):
    _, got = results
    losses = [[m["loss"] for m in got[k]["metrics"]] for k in ("d4", "s2t2")]
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-2)
    cases.assert_same_training(got["d4"], got["s2t2"])
