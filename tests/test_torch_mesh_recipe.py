"""The JAX bench's recipe under a mesh: a gloo world of 4 ranks trains
llama-debug on fsdp 2 x tensor 2 with bf16 weights, remat "dots" and
``adafactor(1e-2)``, three steps, against the single-process port's
recipe from the same seeded weights and batch at the 1e-2 bound of
``tests/test_torch_moe_train.py``: every metric of every step, and every
final parameter by its relative L2 distance.
``tests/test_torch_mesh_adafactor.py`` holds Adafactor in fp32."""

import pytest
import torch

from tests import torch_mesh_cases as cases
from tests.test_torch_mesh_train import token_inputs
from tests.torch_world import World


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("recipe")
    inputs = token_inputs()
    torch.save(inputs, work / "inputs.pt")
    with World("tests.torch_mesh_cases:train_recipe", 4, work,
               timeout=300) as world:
        with cases.one_thread():
            single = cases.train(("single",), inputs, recipe=True)["single"]
        got = world.join()
    return single, got["f2t2"]


def test_recipe_on_f2t2_matches_single_process(results):
    single, got = results
    assert got["params"]["layers.0.attn.q"].dtype == torch.bfloat16
    assert got["params"]["layers.0.attn_norm.scale"].dtype == torch.float32
    cases.assert_same_training(got, single, rtol=1e-2, bf16=True)
    assert got["metrics"][-1]["loss"] < got["metrics"][0]["loss"]

