"""The port's pipeline schedules (ray_tpu_torch/parallel/pipeline.py)
against the JAX package's: the per-stage op lists of GPipe, 1F1B and
interleaved 1F1B (closed form and greedy), their peak live buffers,
analytic bubbles, dependency-order simulation and event timeline, over a
grid of (S, M, v), and make_schedule's validation errors. Then
pipeline_apply on one process (no mesh: S = 1) against the stages run one
after another, forward and gradients."""

import numpy as np
import pytest
import torch

from ray_tpu.parallel import pipeline as jplib
from ray_tpu_torch.parallel import pipeline as plib

GRID = [(S, M, v) for S in (1, 2, 3, 4) for M in (1, 2, 3, 4, 6, 8)
        for v in (1, 2, 3)]


def _ops(sched):
    return [[tuple(op) for op in ops] for ops in sched]


@pytest.mark.parametrize("S,M,v", GRID)
def test_schedules_equal_jax(S, M, v):
    kinds = ["1f1b"] + (["gpipe"] if v == 1 else [])
    for kind in kinds:
        got, want = (lib.make_schedule(kind, S, M, virtual=v)
                     for lib in (plib, jplib))
        assert _ops(got) == _ops(want), (kind, S, M, v)
        assert [plib.peak_live_activations(ops) for ops in got] == \
            [jplib.peak_live_activations(ops) for ops in want]
        assert [plib.peak_live_activations(ops, grad_buffers=False)
                for ops in got] == \
            [jplib.peak_live_activations(ops, grad_buffers=False)
             for ops in want]
        assert plib.simulate_schedule(got) == jplib.simulate_schedule(want)

        def op_time(s, kind, chunk):
            return 1.0 + 0.25 * s + (0.5 if kind == "B" else 0.0) \
                + 0.125 * chunk
        for transfer in (0.0, 0.3):
            assert plib.simulate_timeline(got, op_time, transfer) == \
                jplib.simulate_timeline(want, op_time, transfer)
    assert plib.pipeline_bubble_fraction(S, M, virtual=v) == \
        jplib.pipeline_bubble_fraction(S, M, virtual=v)
    if v > 1:
        assert _ops(plib.schedule_interleaved_1f1b(S, M, v)) == \
            _ops(jplib.schedule_interleaved_1f1b(S, M, v))


def test_grid_covers_both_interleaved_paths():
    """The grid holds S=4, M=8, v=2 (closed form) and M % S != 0 with
    v > 1 (greedy)."""
    assert (4, 8, 2) in GRID
    assert any(v > 1 and M % S for S, M, v in GRID)


def _raises(fn, *args, **kw):
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


@pytest.mark.parametrize("args", [
    ("zigzag", 2, 2), ("gpipe", 2, 2, 2), ("1f1b", 2, 2, 0),
    ("1f1b", 0, 4), ("gpipe", 2, 0), ("1f1b", 2, 0, 2),
])
def test_make_schedule_errors_equal_jax(args):
    assert _raises(plib.make_schedule, *args) == \
        _raises(jplib.make_schedule, *args)


def test_simulate_schedule_deadlock_equal_jax():
    bad = [[(plib.OP_BWD, 0), (plib.OP_FWD, 0)],
           [(plib.OP_FWD, 0), (plib.OP_BWD, 0)]]
    msg = _raises(plib.simulate_schedule, bad)
    assert "deadlock" in msg and msg == _raises(jplib.simulate_schedule, bad)


def test_pipeline_apply_one_stage_equals_sequential():
    """Without a mesh S = 1: the tick loop runs each microbatch through the
    one stage in turn; output and every gradient (parameters and input)
    equal the stage run microbatch by microbatch, bit for bit."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(1, 6, 6, generator=g, requires_grad=True)
    x = torch.randn(4, 3, 6, generator=g, requires_grad=True)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"])

    y = plib.pipeline_apply(stage_fn, {"w": w}, x)
    (y * y).sum().backward()
    w2 = w.detach().clone().requires_grad_()
    x2 = x.detach().clone().requires_grad_()
    ref = torch.stack([stage_fn({"w": w2[0]}, x2[m]) for m in range(4)])
    (ref * ref).sum().backward()
    assert torch.equal(y, ref)
    assert torch.equal(w.grad, w2.grad) and torch.equal(x.grad, x2.grad)
    apply = plib.make_pipeline_fns(stage_fn)
    assert torch.equal(apply({"w": w}, x), y)
    with pytest.raises(ValueError, match="2 stage rows"):
        plib.pipeline_apply(stage_fn, {"w": torch.zeros(2, 6, 6)}, x)


def test_stack_and_specs():
    per = [{"a": torch.full((2, 3), float(i)), "b": torch.zeros(4)}
           for i in range(3)]
    st = plib.stack_stage_params(per)
    assert st["a"].shape == (3, 2, 3) and st["b"].shape == (3, 4)
    np.testing.assert_array_equal(st["a"][2].numpy(), np.full((2, 3), 2.0))
    assert plib.stage_param_specs(st) == {"a": ("stage", None, None),
                                          "b": ("stage", None)}
    jst = jplib.stack_stage_params([{k: v.numpy() for k, v in p.items()}
                                    for p in per])
    assert {k: tuple(v) for k, v in jplib.stage_param_specs(jst).items()} \
        == plib.stage_param_specs(st)
    with pytest.raises(ValueError, match="same parameter names"):
        plib.stack_stage_params([{"a": torch.zeros(1)},
                                 {"b": torch.zeros(1)}])
