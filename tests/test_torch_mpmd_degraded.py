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


class _BlamedPeer:
    """A stage handle whose apply at ``step`` fails at the fetch without
    naming a death (as a stage whose input never came, or whose process
    died silently). ``dies``: the stage's state is gone after that apply
    and it then answers the ping as ``answer`` says: from a new
    incarnation ("new"), or from the old one with its own error saying it
    died ("own")."""

    def __init__(self, inner, step, dies=False, answer="new"):
        self.inner, self.step, self.dies, self.answer = (inner, step, dies,
                                                         answer)
        self._failing = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def apply_step(self, step):
        fut = self.inner.apply_step(step)
        if step == self.step and self._failing is None:
            self._failing = fut
            if self.dies:
                self.inner.kill()
        return fut

    def fetch(self, fut, timeout=None):
        if fut is self._failing:
            if self.dies and self.answer == "own":
                raise StageLostError(self.stage_idx, "its process died")
            raise TimeoutError(f"stage {self.stage_idx}'s apply barrier "
                               "timed out")
        return self.inner.fetch(fut, timeout)

    def ping(self, timeout=None):
        return True

    def incarnation(self, timeout=None):
        if self.dies and self._failing is not None and self.answer == "new":
            return "a fresh process"
        return "the first process"


@pytest.mark.parametrize("answer", ["new", "own"])
def test_loss_lands_on_the_stage_that_died_not_the_first_to_raise(answer):
    """Stage 0's apply fetch fails first and stage 1's second, every ping
    answers; stage 1 died (it answers from a new incarnation, or its own
    error says so). The loss lands on stage 1 alone, stage 0 survives, and
    the run recovers to the digests of the run without a kill."""
    from ray_tpu_torch.train.mpmd import LocalStageHandle
    base = _trainer()
    base.fit(_data_fn, 4)
    tr = _trainer()
    wrapped = {}

    def provision(idx, snapshot=None):
        h = tr._default_provision(idx, snapshot)
        if idx in wrapped or not isinstance(h, LocalStageHandle):
            return h
        wrapped[idx] = _BlamedPeer(h, 3, dies=idx == 1, answer=answer)
        return wrapped[idx]
    tr._provision_fn = provision
    tr.start()
    out = tr.fit(_data_fn, 4)
    assert [r["stages"] for r in out["recoveries"]] == [[1]], \
        out["recoveries"]
    assert tr.handles[0] is wrapped[0]
    assert tr.handles[1] is not wrapped[1]
    assert tr.state_digests() == base.state_digests()


def test_no_evidence_names_no_stage_and_replays():
    """A failed apply with every stage answering as before names no stage:
    every stage goes back to the boundary and the step replays."""
    base = _trainer()
    base.fit(_data_fn, 4)
    tr = _trainer()
    tr._provision_fn = lambda idx, snapshot=None: _BlamedPeer(
        tr._default_provision(idx, snapshot), 3)
    tr.start()
    out = tr.fit(_data_fn, 4)
    assert [r["stages"] for r in out["recoveries"]] == [[]]
    assert "evidence none" in out["recoveries"][0]["cause"]
    assert tr.state_digests() == base.state_digests()
