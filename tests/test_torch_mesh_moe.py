"""MoE's expert axis on the CPU: a gloo world of 4 ranks trains moe-debug
in fp32 on expert 2 x fsdp 2 (``tests/test_moe.py::
test_moe_train_step_expert_parallel``'s axes, cut to 4 ranks): four
AdamW steps from the seeded weights, with the stacked experts sharded
over ``expert`` and the token->expert shuffle redistributed between the
token layout and the experts' layout. The loss falls, ``moe_aux > 0``,
and the steps equal the single-process port's (``assert_same_training``,
rtol 1e-4). ``tests/test_torch_mesh_moe_logits.py`` holds the logits
across expert layouts."""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from tests import torch_mesh_cases as cases
from tests.test_torch_mesh_train import token_inputs
from tests.torch_world import World


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("moe")
    inputs = token_inputs("moe-debug", seed=2)
    torch.save(inputs, work / "inputs.pt")
    with World("tests.torch_mesh_cases:moe_train", 4, work,
               timeout=300) as world:
        with cases.one_thread():
            single = cases.train(("single",), inputs, steps=4)["single"]
        got = world.join()
    return got["e2f2"], single


def test_expert_parallel_training(results):
    e2f2, single = results
    losses = [m["loss"] for m in e2f2["metrics"]]
    assert losses[-1] < losses[0], losses
    assert all(m["moe_aux"] > 0 for m in e2f2["metrics"])
    dims = e2f2["mesh_dims"]
    assert dims == ("fsdp", "expert")
    for name in ("gate", "up", "down"):
        pl = e2f2["placements"][f"layers.0.moe.{name}"]
        assert pl[dims.index("expert")] == Shard(0), (name, pl)
    np.testing.assert_allclose(losses, [m["loss"] for m in
                                        single["metrics"]], rtol=1e-4)
    cases.assert_same_training(e2f2, single)
