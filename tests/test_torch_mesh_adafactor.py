"""Adafactor on sharded leaves: a gloo world of 4 ranks trains llama-debug
in fp32 on fsdp 2 x tensor 2 with ``adafactor(1e-2)``, three steps. Its
factored row and column statistics and its block RMS reduce over dims
that the mesh shards (DTensor's reductions, with the pending partial
sums reduced before they are used), and every metric, first-step
gradient and final parameter must equal the single-process optimizer's
from the same seeded weights and batch (``assert_same_training``, rtol
1e-4)."""

import pytest
import torch

from tests import torch_mesh_cases as cases
from tests.test_torch_mesh_train import token_inputs
from tests.torch_world import World


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("adafactor")
    inputs = token_inputs()
    torch.save(inputs, work / "inputs.pt")
    with World("tests.torch_mesh_cases:train_adafactor", 4, work,
               timeout=300) as world:
        with cases.one_thread():
            single = cases.train(("single",), inputs,
                                 optimizer="adafactor")["single"]
        got = world.join()
    return single, got["f2t2"]


def test_fp32_adafactor_on_f2t2_matches_single_process(results):
    single, got = results
    cases.assert_same_training(got, single)
    assert got["metrics"][-1]["loss"] < got["metrics"][0]["loss"]
