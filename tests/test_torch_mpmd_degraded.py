"""What a degraded recovery of the port's MPMD pipeline trainer
(ray_tpu_torch/train/mpmd.py) reports, on the CPU without JAX: the loss
it was recovering (step, stages, cause), the confirmed boundary and, when
a boundary's snapshot never sealed, which boundary was dropped and why.
Stages of one tanh layer, as in tests/test_torch_mpmd_elastic.py. The
probe that runs such recoveries in a loop on the card imports no JAX."""

import ast
import pathlib

import pytest

from ray_tpu_torch.train import PipelineDegradedError
from ray_tpu_torch.train.mpmd import StageLostError
from tests.test_torch_mpmd_elastic import _data_fn, _trainer


def test_degraded_recovery_names_the_loss_and_the_boundary():
    tr = _trainer()
    tr.start()
    tr.handles[1]._fail_at = (2, "F")
    tr._snap_refs.clear()           # no boundary is confirmed
    with pytest.raises(PipelineDegradedError) as info:
        tr.fit(_data_fn, 3)
    msg = str(info.value)
    assert "no restore source for stage 1" in msg, msg
    assert "lost (2, [1], " in msg, msg
    assert "confirmed boundary None" in msg, msg
    assert "dropped boundary (step, stage, cause) None" in msg, msg


def test_degraded_recovery_names_the_dropped_boundary():
    """A stage whose snapshot never seals drops its boundary; the error of
    the recovery that then finds no restore source says which and why."""
    tr = _trainer(checkpoint_every=1)
    tr.start()
    tr._snap_refs.clear()

    def unsealed(fut, timeout=None):
        raise StageLostError(1, "snapshot never sealed: seal refused")
    tr.handles[1].seal = unsealed
    tr.handles[1]._fail_at = (2, "F")
    with pytest.raises(PipelineDegradedError) as info:
        tr.fit(_data_fn, 3)
    msg = str(info.value)
    assert "no restore source for stage 1" in msg, msg
    assert "confirmed boundary None" in msg, msg
    assert "(1, 1, 'snapshot never sealed: seal refused')" in msg, msg


def test_elastic_probe_imports_no_jax():
    root = pathlib.Path(__file__).resolve().parent.parent
    tree = ast.parse((root / "pipeline_elastic_probe.py").read_text())
    top = {a.name.split(".")[0] for n in ast.walk(tree)
           if isinstance(n, ast.Import) for a in n.names}
    top |= {n.module.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module}
    assert not top & {"jax", "flax", "optax", "ray_tpu"}, top
    assert "chip_smoke" in top and "ray_tpu_torch" in top
