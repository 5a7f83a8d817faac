"""Elastic MPMD pipeline training, in process: per-stage programs, host
hand-offs between stages, and stage-level recovery.

Counterpart of the in-process part of ``ray_tpu/train/mpmd.py``
(``LocalStageHandle`` stages driven by ``MPMDPipelineTrainer``). Each
stage is its own program with its own parameters and optimizer; the
microbatch schedule (1F1B by default, GPipe optional, interleaved virtual
stages — ``parallel/pipeline.py``) is dispatched by the controller, and
activations and input-gradients cross every stage boundary as CPU tensors
(the JAX trainer hands host arrays across), keeping their dtype.

A stage's forward runs under ``no_grad`` and saves its input; its
backward recomputes the forward under autograd and takes
``torch.autograd.grad`` of the output (the last stage: of its loss) with
respect to the parameters and the input, as the JAX stage takes
``jax.vjp``. Parameter gradients accumulate in CALL order, so a replayed
step accumulates exactly as the first run did; at the step boundary the
sum is divided by M and the stage's ``torch.optim`` optimizer steps in
place (the JAX programs donate their buffers instead).

Stage loss is a first-class lifecycle:

  notice   — a stage whose preemption-marker file exists is migrated at
             the NEXT step boundary: fresh snapshot, replacement built
             from it, old stage reaped — zero steps replayed.
  crash    — a stage that dies mid-step (``fail_at``) surfaces as a
             failed apply. Surviving stages PARK (abort the in-flight
             step, roll back to the last checkpoint boundary); the lost
             stage is rebuilt from its snapshot (the in-memory one, else
             the durable shard under ``storage_path``) and the buffered
             input microbatches are REPLAYED through the identical
             per-stage op order, so post-replay optimizer state is
             bit-identical to an uninterrupted run.
  degrade  — a survivor that misses the park barrier or an exhausted
             ``FailureConfig.max_failures`` budget raises
             :class:`PipelineDegradedError`.

Snapshots are deep copies to the CPU, taken on a background thread at
each checkpoint boundary (on a side stream that first waits for the
apply's kernels), and joined before the next apply changes the
parameters in place.

Not ported yet (ROADMAP.md, Queue A item A3b): the actor and gang
transport (``remote=True``), the ``stage_step`` chaos channel, the TPU
preemption notice, the runtime's events, its ``runtime_mpmd_*`` gauges and
the step profiler.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import inspect
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ray_tpu_torch.parallel.pipeline import (OP_BWD, OP_FWD, make_schedule,
                                             op_chunk, peak_live_activations,
                                             pipeline_bubble_fraction)
from ray_tpu_torch.train.config import FailureConfig

# the JAX package's flag defaults (mpmd_replay_depth,
# mpmd_barrier_deadline_s, mpmd_step_timeout_s)
REPLAY_DEPTH = 2
BARRIER_DEADLINE_S = 30.0
STEP_TIMEOUT_S = 300.0


class StageLostError(RuntimeError):
    """One or more stages died or failed mid-step; carries the lost stage
    indexes."""

    def __init__(self, stage_idx: int, cause: str = "",
                 stages: Optional[List[int]] = None):
        self.stages = sorted(set(stages or [stage_idx]))
        super().__init__(f"pipeline stage(s) {self.stages} lost"
                         + (f": {cause}" if cause else ""))
        self.stage_idx = stage_idx
        self.cause = cause


class PipelineDegradedError(RuntimeError):
    """Stage-level recovery could not proceed (park-barrier deadline
    missed or failure budget exhausted); the caller must fall back to a
    job-level restart."""


@dataclasses.dataclass
class StageDefinition:
    """What one pipeline stage computes: a ``module`` (its parameters are
    the stage's), or ``stage_fn(params, x) -> y`` with a ``params`` dict of
    leaf tensors. The last stage's ``loss_fn(y, targets)`` -> scalar
    closes the pipeline. ``optimizer`` is a factory over the parameter
    list (``parallel.optim.adamw(...)``, ``adafactor(...)``), each tensor
    a leaf of its own. ``place`` puts a restored host (CPU) state tree
    where the stage keeps it; by default every tensor goes to the stage's
    device, except 0-dim ones, which stay on the host as ``torch.optim``
    keeps AdamW's step count."""
    module: Optional[torch.nn.Module] = None
    optimizer: Optional[Callable] = None
    loss_fn: Optional[Callable[[Any, Any], Any]] = None
    place: Optional[Callable[[Any], Any]] = None
    stage_fn: Optional[Callable[[Dict[str, torch.Tensor], Any], Any]] = None
    params: Optional[Dict[str, torch.Tensor]] = None

    def __post_init__(self):
        if (self.module is None) == (self.stage_fn is None):
            raise ValueError("give a stage either module= or stage_fn= "
                             "(with params=)")
        if self.module is not None:
            module = self.module
            self.params = dict(module.named_parameters())
            self.stage_fn = lambda p, x: torch.func.functional_call(
                module, p, (x,))
        elif not self.params:
            raise ValueError("stage_fn= needs a params dict")
        if self.optimizer is None:
            raise ValueError("a stage needs an optimizer factory")


def block_stage_builders(cfg, weights: Dict[str, torch.Tensor],
                         n_virtual: int, optimizer: Callable,
                         loss_chunk: int = 256) -> List[Callable]:
    """Builders of a decoder's blocks cut into ``n_virtual`` stages of
    ``cfg.n_layers / n_virtual`` blocks each (``models.BlockStage``), with
    the embedding and the unembedding outside the stages, as the JAX
    package's MPMD dry run keeps them: the first stage takes embedded
    inputs, and the last stage's loss is the chunked cross-entropy
    (``parallel.chunked_cross_entropy``) of its output against the
    unembedding of ``weights``, a model state_dict (``convert.init_params``),
    which stays fixed. Each build copies its blocks' weights out of
    ``weights``, so a stage rebuilt after a loss starts from them too
    (then takes its snapshot)."""
    from ray_tpu_torch.models import BlockStage, stage_state_dict
    from ray_tpu_torch.parallel.train_step import chunked_cross_entropy

    if cfg.n_layers % n_virtual:
        raise ValueError(f"{cfg.n_layers} blocks do not cut into "
                         f"{n_virtual} stages")
    per = cfg.n_layers // n_virtual
    unembed = (weights["embed"].t() if cfg.tie_embeddings
               else weights["unembed"]).to(cfg.dtype)

    def loss_fn(y, targets):
        return chunked_cross_entropy(y, unembed, targets, chunk=loss_chunk)[0]

    def builder(vs):
        stage = BlockStage(cfg, per, device="meta")
        stage.load_state_dict(
            {k: v.clone() for k, v in
             stage_state_dict(weights, vs * per, per).items()}, assign=True)
        return StageDefinition(
            module=stage, optimizer=optimizer,
            loss_fn=loss_fn if vs == n_virtual - 1 else None)
    return [builder] * n_virtual


@dataclasses.dataclass
class MPMDConfig:
    """Pipeline shape and elasticity knobs (defaults: the JAX package's
    flag defaults above)."""
    n_microbatches: int = 4
    schedule: str = "1f1b"                  # "1f1b" | "gpipe"
    virtual_stages: int = 1                 # v chunks per stage (1f1b only)
    replay_depth: Optional[int] = None      # REPLAY_DEPTH
    checkpoint_every: Optional[int] = None  # default: replay_depth
    barrier_deadline_s: Optional[float] = None
    step_timeout_s: Optional[float] = None
    storage_path: Optional[str] = None      # durable shard checkpoints
    async_checkpoint: bool = True           # snapshot off the hot path

    def resolved(self) -> "MPMDConfig":
        c = dataclasses.replace(self)
        if c.replay_depth is None:
            c.replay_depth = REPLAY_DEPTH
        if c.checkpoint_every is None:
            c.checkpoint_every = c.replay_depth
        if c.barrier_deadline_s is None:
            c.barrier_deadline_s = BARRIER_DEADLINE_S
        if c.step_timeout_s is None:
            c.step_timeout_s = STEP_TIMEOUT_S
        if c.n_microbatches < 1:
            raise ValueError("n_microbatches must be >= 1")
        if c.virtual_stages < 1:
            raise ValueError("virtual_stages must be >= 1")
        if c.virtual_stages > 1 and c.schedule != "1f1b":
            raise ValueError(
                "interleaved virtual stages require the '1f1b' schedule")
        if c.replay_depth < 1:
            raise ValueError("replay_depth must be >= 1")
        if c.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if c.checkpoint_every > c.replay_depth:
            raise ValueError(
                f"checkpoint_every={c.checkpoint_every} must be <= "
                f"replay_depth={c.replay_depth}: the replay buffer must "
                "cover every step since the last shard checkpoint")
        return c


def _host_copy(tree):
    """A deep copy with every tensor on the CPU (dicts, lists and tuples
    rebuilt, other leaves kept). A CUDA tensor is copied into pinned host
    memory, asynchronously on the current stream: synchronize it before
    reading the copies. (A copy into pageable memory is staged by CUDA
    through a bounce buffer and, from a background thread, held up the
    training thread's kernel launches: a 12-block tpu-3b stage's forward
    took 2.4 s instead of 0.1 s while its snapshot was being copied.)"""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
            return out.copy_(tree.detach(), non_blocking=True)
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _as_host_tensor(x) -> torch.Tensor:
    """A caller's microbatch (numpy array or tensor) as a CPU tensor of its
    own."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ replay buffer

class MicrobatchReplayBuffer:
    """Bounded per-step retention of input microbatches (+ targets) so a
    rebuilt stage can replay every step since the last checkpoint.
    Eviction is deterministic: strictly oldest-first once more than
    ``depth`` steps are held. Stored microbatches are CPU copies, so later
    caller mutation can't corrupt replay.

    ``budget()`` reports the bytes held and, beside them, the pipeline's
    microbatch-sized peak: the replay window (depth * M input
    microbatches) PLUS the busiest stage's in-flight stashes and grad
    buffers (``peak_live_activations`` with grad-accumulation buffers
    included)."""

    def __init__(self, depth: int, *, n_microbatches: Optional[int] = None,
                 peak_live_buffers: Optional[List[int]] = None):
        if depth < 1:
            raise ValueError("replay depth must be >= 1")
        self.depth = depth
        self.n_microbatches = n_microbatches
        self.peak_live_buffers = list(peak_live_buffers) \
            if peak_live_buffers is not None else None
        self._steps: Dict[int, Any] = {}

    def record(self, step: int, inputs: List[Any], targets: List[Any]):
        self._steps[step] = ([_as_host_tensor(x) for x in inputs],
                             [_as_host_tensor(t) for t in targets])
        while len(self._steps) > self.depth:
            del self._steps[min(self._steps)]

    def budget(self) -> Dict[str, Any]:
        """Memory accounting for the replay window: bytes actually held
        plus the microbatch-buffer peak the pipeline adds on top."""
        held = sum(a.nbytes for ins, tgts in self._steps.values()
                   for a in (*ins, *tgts))
        out: Dict[str, Any] = {"depth": self.depth,
                               "steps_held": len(self._steps),
                               "bytes_held": int(held)}
        if self.n_microbatches is not None:
            out["replay_microbatches"] = self.depth * self.n_microbatches
            if self.peak_live_buffers:
                out["peak_live_stage_buffers"] = max(self.peak_live_buffers)
                out["peak_microbatch_buffers"] = (
                    out["replay_microbatches"]
                    + out["peak_live_stage_buffers"])
        return out

    def steps(self) -> List[int]:
        return sorted(self._steps)

    def get(self, step: int):
        if step not in self._steps:
            raise KeyError(
                f"step {step} not in replay buffer (held: {self.steps()}, "
                f"depth {self.depth})")
        return self._steps[step]

    def replayable_from(self, boundary_step: int) -> List[int]:
        """Steps after ``boundary_step`` available for replay, in order;
        raises if a gap means the boundary is too old to recover from."""
        want = [s for s in self.steps() if s > boundary_step]
        expect = list(range(boundary_step + 1, boundary_step + 1 + len(want)))
        if want != expect:
            raise KeyError(
                f"replay gap: checkpoint at step {boundary_step} but "
                f"buffer holds {self.steps()}")
        return want


# ------------------------------------------------------------ stage runtime

def _shape_key(tree):
    """What a program's call is keyed by: every tensor's shape, dtype and
    device, and the structure around them."""
    if isinstance(tree, torch.Tensor):
        return ("T", tuple(tree.shape), tree.dtype, tree.device.type)
    if isinstance(tree, dict):
        return ("D",) + tuple((k, _shape_key(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return ("L",) + tuple(_shape_key(v) for v in tree)
    return ("V", type(tree).__name__)


class _Program:
    """One stage program (forward, backward, accumulate or apply), keyed by
    its inputs as the JAX ``_AotProgram`` keys its compiled executables.
    Eager PyTorch compiles nothing: ``compile_count`` counts the distinct
    keys it was called with (the JAX program's traces), so 1 still means
    "no new input shape". With ``count_flops`` (the forward), the first
    call of each key runs under ``FlopCounterMode``, whose count of the
    aten products (matrix products, convolutions, SDPA; not a
    hand-written kernel such as the flash attention's) is kept as
    ``flops``."""

    __slots__ = ("_fn", "_keys", "_count_flops", "flops")

    def __init__(self, fn, count_flops: bool = False):
        self._fn = fn
        self._keys: set = set()
        self._count_flops = count_flops
        self.flops = 0.0

    @property
    def compile_count(self) -> int:
        return len(self._keys)

    def __call__(self, *args):
        key = _shape_key(args)
        if key in self._keys or not self._count_flops:
            self._keys.add(key)
            return self._fn(*args)
        self._keys.add(key)
        counter = FlopCounterMode(display=False)
        with counter:
            out = self._fn(*args)
        self.flops = float(counter.get_total_flops())
        return out


class StageRuntime:
    """One (virtual) stage's compute engine: the forward, recompute-style
    backward, grad accumulation in schedule order (replay determinism),
    the optimizer's apply, and host-snapshot checkpoint/rollback. Under
    interleaved schedules a host holds one StageRuntime per virtual
    chunk, each with ``stage_idx`` = its VIRTUAL stage index.

    Checkpointing is asynchronous: ``checkpoint_begin`` marks the
    boundary (a CUDA event after the apply's kernels) and a background
    thread copies params and optimizer state to the host.
    ``checkpoint_result``/``rollback``/the next ``apply_step`` (which
    changes them in place) are the barrier points."""

    def __init__(self, defn: StageDefinition, *, stage_idx: int,
                 n_stages: int, n_microbatches: int):
        self.defn = defn
        self.stage_idx = stage_idx
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.is_first = stage_idx == 0
        self.is_last = stage_idx == n_stages - 1
        if self.is_last and defn.loss_fn is None:
            raise ValueError("last stage needs a loss_fn")
        self.step = 0
        self.params: Dict[str, torch.Tensor] = defn.params
        self._leaves = list(self.params.values())
        for p in self._leaves:
            p.requires_grad_(True)
        self.device = self._leaves[0].device
        self.optimizer = defn.optimizer(self._leaves)
        self._saved: Dict[tuple, Any] = {}
        self._gacc: Optional[List[torch.Tensor]] = None
        self._losses: List[Any] = []
        self._compute_s = 0.0
        self._op_s: Dict[str, float] = {}
        self._op_n: Dict[str, int] = {}
        self._ckpt_lock = threading.Lock()
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_err: Optional[BaseException] = None
        self._last_snapshot = self._snapshot_of(self.step)

        stage_fn, loss_fn = defn.stage_fn, defn.loss_fn
        leaves, M = self._leaves, n_microbatches
        want_gx = not self.is_first

        def fwd(params, x):
            with torch.no_grad():
                return stage_fn(params, x)

        def fwd_last(params, x, target):
            with torch.no_grad():
                return loss_fn(stage_fn(params, x), target)

        def grads(out, x, seed):
            inputs = leaves + [x] if want_gx else leaves
            got = torch.autograd.grad(out, inputs, seed, allow_unused=True,
                                      materialize_grads=True)
            return (got[-1] if want_gx else None), list(got[:len(leaves)])

        def bwd(params, x, gy):
            with torch.enable_grad():
                x = x.detach().requires_grad_(want_gx)
                return grads(stage_fn(params, x), x, gy)

        def bwd_last(params, x, target):
            with torch.enable_grad():
                x = x.detach().requires_grad_(want_gx)
                loss = loss_fn(stage_fn(params, x), target)
                gx, gp = grads(loss, x, None)
            return gx, gp, loss.detach()

        def acc(a, b):
            torch._foreach_add_(a, b)

        def apply(gacc):
            with torch.no_grad():
                for p, g in zip(leaves, gacc):
                    p.grad = g.div_(M)
                self.optimizer.step()
                for p in leaves:
                    p.grad = None

        self._fwd_j = _Program(fwd_last if self.is_last else fwd,
                               count_flops=True)
        self._bwd_j = _Program(bwd_last if self.is_last else bwd)
        self._acc_j = _Program(acc)
        self._apply_j = _Program(apply)

    # ------------------------------------------------------------- compute
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, kind: str, fn, *args):
        """Run one program and wait for the device (its time is the
        stage's compute), inside a profiler range ``mpmd.<kind>``
        (``trace_train --pipeline`` reads the device time under each)."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"mpmd.{kind}"):
            out = fn(*args)
            self._sync()
        dt = time.perf_counter() - t0
        self._compute_s += dt
        self._op_s[kind] = self._op_s.get(kind, 0.0) + dt
        self._op_n[kind] = self._op_n.get(kind, 0) + 1
        return out

    def _on_device(self, x):
        return None if x is None else torch.as_tensor(x).to(self.device)

    def flops_per_step(self) -> float:
        """One full step's FLOPs for this chunk: per microbatch the
        forward's products as ``FlopCounterMode`` counted them (0 before
        the first forward), and three times that for the backward (its
        recompute, and the two products of each forward product's
        gradient). The accumulation and the optimizer count no
        products."""
        return self.n_microbatches * 4 * self._fwd_j.flops

    def forward(self, step: int, mb: int, x, target=None):
        """Run F(step, mb). Non-last stages return the activation (the
        tensor the next stage consumes); the last stage returns its
        per-microbatch loss. Both leave as CPU tensors: they cross a stage
        boundary. The input is saved for the recompute-style backward and
        dropped by it (or by abort_step)."""
        x = self._on_device(x)
        if self.is_last:
            target = self._on_device(target)
            self._saved[(step, mb)] = (x, target)
            return self._timed("fwd", self._fwd_j, self.params, x,
                               target).cpu()
        self._saved[(step, mb)] = x
        return self._timed("fwd", self._fwd_j, self.params, x).cpu()

    def backward(self, step: int, mb: int, gy=None):
        """Run B(step, mb): recompute over the saved input, accumulate the
        parameter gradients IN CALL ORDER (the schedule's order — replay
        hits the same order, hence bit-identical accumulation), and return
        the input-gradient for the upstream stage as a CPU tensor (None
        on the first stage, which has no upstream)."""
        if self.is_last:
            x, target = self._saved.pop((step, mb))
            gx, gp, loss = self._timed("bwd", self._bwd_j, self.params, x,
                                       target)
            self._losses.append(loss.float().cpu().numpy())
        else:
            x = self._saved.pop((step, mb))
            gx, gp = self._timed("bwd", self._bwd_j, self.params, x,
                                 self._on_device(gy))
        if self._gacc is None:
            self._gacc = gp
        else:
            self._timed("acc", self._acc_j, self._gacc, gp)
        return None if gx is None else gx.cpu()

    def apply_step(self, step: int) -> Dict[str, Any]:
        """Step boundary: apply the accumulated (mean) gradient, clear
        per-step state, return stage metrics. Joins any in-flight async
        snapshot first: the apply changes the parameters and the
        optimizer state in place, and the snapshot thread must not be
        copying them then."""
        if self._gacc is None:
            raise RuntimeError(f"stage {self.stage_idx}: apply_step({step}) "
                               "with no accumulated gradients")
        if self._saved:
            raise RuntimeError(
                f"stage {self.stage_idx}: {len(self._saved)} saved "
                f"activations outstanding at apply_step({step})")
        self._ckpt_barrier()
        self._timed("apply", self._apply_j, self._gacc)
        metrics: Dict[str, Any] = {
            "step": step, "stage": self.stage_idx,
            "compute_s": round(self._compute_s, 6),
            **{f"{k}_compile_count": n
               for k, n in self.compile_counts().items()},
            "flops": self.flops_per_step(),
        }
        for kind in ("fwd", "bwd"):
            metrics[f"{kind}_s"] = round(self._op_s.get(kind, 0.0), 6)
            metrics[f"{kind}_n"] = self._op_n.get(kind, 0)
        if self.is_last and self._losses:
            metrics["loss"] = float(np.mean(self._losses))
        self._gacc = None
        self._losses = []
        self._compute_s = 0.0
        self._op_s = {}
        self._op_n = {}
        self.step = step
        return metrics

    def abort_step(self, step: int) -> bool:
        """Park: drop the in-flight step's saved activations, partial
        grad accumulation and losses. Params/optimizer state are
        untouched — they only move at apply_step."""
        self._saved = {k: v for k, v in self._saved.items()
                       if k[0] != step}
        self._gacc = None
        self._losses = []
        self._compute_s = 0.0
        self._op_s = {}
        self._op_n = {}
        return True

    # ------------------------------------------------------- checkpointing
    def _opt_state(self) -> List[dict]:
        """The optimizer's state, one dict per parameter, in parameter
        order (empty before the first step)."""
        return [self.optimizer.state.get(p, {}) for p in self._leaves]

    def _snapshot_of(self, step: int, ready=None) -> Dict[str, Any]:
        """Deep CPU copies of the parameters and the optimizer state. With
        ``ready`` (a CUDA event recorded after the apply), the copies run
        on a side stream that waits for it, so they overlap the next
        step's compute and read no half-updated tensor."""
        state = {"params": self.params, "opt_state": self._opt_state()}
        if self.device.type != "cuda":
            return {"step": step, "stage": self.stage_idx,
                    **_host_copy(state)}
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            if ready is not None:
                stream = torch.cuda.Stream()
                stream.wait_event(ready)
            with torch.cuda.stream(stream):
                host = _host_copy(state)
            stream.synchronize()
        return {"step": step, "stage": self.stage_idx, **host}

    def _ckpt_barrier(self):
        """Join the in-flight async snapshot, surfacing its error."""
        t = self._ckpt_thread
        if t is not None:
            t.join()
            self._ckpt_thread = None
            if self._ckpt_err is not None:
                err, self._ckpt_err = self._ckpt_err, None
                raise RuntimeError(
                    f"stage {self.stage_idx}: async checkpoint "
                    "failed") from err

    def checkpoint_begin(self, step: int) -> bool:
        """Start a step-boundary snapshot OFF the hot path: a background
        thread makes the host copy, overlapping the next step's compute."""
        if step != self.step:
            raise RuntimeError(
                f"stage {self.stage_idx}: checkpoint({step}) at "
                f"step {self.step} — checkpoints are step-boundary only")
        self._ckpt_barrier()                  # one snapshot in flight max
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))

        def work():
            try:
                snap = self._snapshot_of(step, ready)
                with self._ckpt_lock:
                    self._last_snapshot = snap
            except BaseException as e:  # noqa: B036 — raised at the barrier
                self._ckpt_err = e

        self._ckpt_thread = threading.Thread(
            target=work, name=f"stage-{self.stage_idx}-ckpt", daemon=True)
        self._ckpt_thread.start()
        return True

    def checkpoint_result(self, step: int) -> Dict[str, Any]:
        """Barrier on the async snapshot and return it (what the controller
        keeps for a replacement stage)."""
        self._ckpt_barrier()
        with self._ckpt_lock:
            snap = self._last_snapshot
        if snap.get("step") != step:
            raise RuntimeError(
                f"stage {self.stage_idx}: checkpoint_result({step}) but "
                f"last snapshot is for step {snap.get('step')}")
        return snap

    def checkpoint(self, step: int) -> Dict[str, Any]:
        """Synchronous snapshot (begin + result)."""
        self.checkpoint_begin(step)
        return self.checkpoint_result(step)

    def rollback(self) -> int:
        """Roll params/optimizer state back to the last checkpoint
        boundary; returns the boundary step. An in-flight copy is joined
        first."""
        self._ckpt_barrier()
        with self._ckpt_lock:
            snap = self._last_snapshot
        self.load_snapshot(snap)
        return self.step

    def _place(self, tree):
        if self.defn.place is not None:
            return self.defn.place(tree)
        if isinstance(tree, torch.Tensor):
            if tree.dim() == 0:
                return tree.clone()
            return tree.to(self.device, copy=True)
        if isinstance(tree, dict):
            return {k: self._place(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._place(v) for v in tree)
        return tree

    def load_snapshot(self, snap: Dict[str, Any]):
        """Copy a snapshot's parameters into the stage's own (in place, so
        the optimizer keeps them) and set its optimizer state."""
        params = self._place(snap["params"])
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(params[name])
        state = self._place(snap["opt_state"])
        if len(state) != len(self._leaves):
            raise ValueError(f"stage {self.stage_idx}: snapshot has "
                             f"optimizer state for {len(state)} parameters, "
                             f"the stage has {len(self._leaves)}")
        self.optimizer.state = collections.defaultdict(dict)
        for p, st in zip(self._leaves, state):
            if st:
                self.optimizer.state[p] = dict(st)
        self.step = int(snap["step"])
        self._last_snapshot = snap
        self._saved = {}
        self._gacc = None
        self._losses = []

    def state_digest(self) -> str:
        """sha256 over every parameter and optimizer-state entry, in a
        fixed order (parameters by name; then the state of each parameter
        in order, keys sorted), with dtype, shape and bytes — the
        bit-identity probe the elastic tests compare against an
        uninterrupted run."""
        h = hashlib.sha256()

        host = self._snapshot_of(self.step)

        def put(v):
            if isinstance(v, torch.Tensor):
                t = v.contiguous()
                h.update(str(t.dtype).encode())
                h.update(str(tuple(t.shape)).encode())
                h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
            else:
                h.update(repr(v).encode())

        for name in self.params:
            put(host["params"][name])
        for st in host["opt_state"]:
            for key in sorted(st):
                h.update(key.encode())
                put(st[key])
        return h.hexdigest()

    def compile_counts(self) -> Dict[str, int]:
        return {"fwd": self._fwd_j.compile_count,
                "bwd": self._bwd_j.compile_count,
                "apply": self._apply_j.compile_count}


# ------------------------------------------------------------- stage hosts

def _build_definition(builder: Callable, stage_idx: int) -> StageDefinition:
    """Builders may take (stage_idx) or nothing."""
    try:
        takes_arg = len(inspect.signature(builder).parameters) >= 1
    except (TypeError, ValueError):
        takes_arg = True
    defn = builder(stage_idx) if takes_arg else builder()
    if not isinstance(defn, StageDefinition):
        raise TypeError(f"stage builder must return StageDefinition, "
                        f"got {type(defn)!r}")
    return defn


def _load_chunk_snapshots(rts: List[StageRuntime], snapshot):
    """Restore a host's runtimes from a snapshot: a single dict for the
    plain one-chunk host, a list (one per virtual chunk, chunk order)
    under interleaving."""
    snaps = [snapshot] if isinstance(snapshot, dict) else list(snapshot)
    if len(snaps) != len(rts):
        raise ValueError(
            f"snapshot has {len(snaps)} chunk shards, host has "
            f"{len(rts)} virtual chunks")
    for rt, snap in zip(rts, snaps):
        rt.load_snapshot(snap)


class _Now:
    """Pre-resolved 'future' of the in-process transport."""
    __slots__ = ("value", "error")

    def __init__(self, value=None, error: Optional[BaseException] = None):
        self.value = value
        self.error = error

    def result(self):
        if self.error is not None:
            raise self.error
        return self.value


class _Later:
    """Deferred 'future' of the in-process transport: the thunk runs on
    first fetch — how the local handles keep the async-checkpoint barrier
    OFF the hot path (the controller stores this unresolved and only
    resolves it on the recovery/restore path)."""
    __slots__ = ("_fn", "_done", "_value", "_error")

    def __init__(self, fn: Callable[[], Any]):
        self._fn = fn
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None

    def result(self):
        if not self._done:
            try:
                self._value = self._fn()
            except BaseException as e:  # noqa: B036 — re-raised below
                self._error = e
            self._done = True
            self._fn = None
        if self._error is not None:
            raise self._error
        return self._value


class LocalStageHandle:
    """In-process stage host: every call returns a future (here
    pre-resolved, failures carried to the fetch as an object-ref
    dependency carries them), ``fail_at=(step, op)`` arms a deterministic
    one-shot death at that op's entry (the handle is then DEAD and every
    later call raises StageLostError, as a killed stage would), and
    ``preempting()`` polls the per-stage marker file."""

    def __init__(self, stage_idx: int, n_stages: int, n_microbatches: int,
                 builder: Optional[Callable] = None,
                 snapshot: Optional[Any] = None,
                 preempt_marker: Optional[str] = None,
                 fail_at: Optional[tuple] = None,
                 chunk_builders: Optional[List[tuple]] = None):
        self.stage_idx = stage_idx
        if chunk_builders is None:
            chunk_builders = [(stage_idx, builder)]
        self._rts = [
            StageRuntime(_build_definition(b, vs), stage_idx=vs,
                         n_stages=n_stages, n_microbatches=n_microbatches)
            for vs, b in chunk_builders]
        if snapshot is not None:
            _load_chunk_snapshots(self._rts, snapshot)
        self._marker = preempt_marker
        self._fail_at = fail_at
        self._dead = False

    def _chaos(self, step: int, op: str):
        if self._dead:
            raise StageLostError(self.stage_idx, "stage already dead")
        if self._fail_at is not None and self._fail_at == (step, op):
            self._fail_at = None
            self._dead = True
            raise StageLostError(self.stage_idx,
                                 f"armed failure at step {step} {op}")

    def _call(self, fn, *args) -> _Now:
        try:
            return _Now(fn(*args))
        except Exception as e:   # surfaced at fetch, like a ref
            return _Now(error=e)

    @staticmethod
    def _unwrap(v):
        # upstream outputs arrive as _Now futures; a poisoned one
        # re-raises the upstream loss here, as a failed object-ref
        # dependency fails the downstream task
        return v.result() if isinstance(v, _Now) else v

    # ------------------------------------------------------------ protocol
    def forward(self, step, mb, x, target=None, chunk=0) -> _Now:
        def run():
            self._chaos(step, OP_FWD)
            return self._rts[chunk].forward(step, mb, self._unwrap(x),
                                            target)
        return self._call(run)

    def backward(self, step, mb, gy=None, chunk=0) -> _Now:
        def run():
            self._chaos(step, OP_BWD)
            return self._rts[chunk].backward(step, mb, self._unwrap(gy))
        return self._call(run)

    def apply_step(self, step) -> _Now:
        def run():
            if self._dead:
                raise StageLostError(self.stage_idx, "stage already dead")
            return [rt.apply_step(step) for rt in self._rts]
        return self._call(run)

    def _if_alive(self, fn) -> _Now:
        if self._dead:
            return _Now(error=StageLostError(self.stage_idx, "dead"))
        return self._call(fn)

    def abort_step(self, step) -> _Now:
        return self._if_alive(lambda: all([rt.abort_step(step)
                                           for rt in self._rts]))

    def checkpoint(self, step) -> _Now:
        return self._if_alive(lambda: [rt.checkpoint(step)
                                       for rt in self._rts])

    def checkpoint_begin(self, step) -> _Now:
        return self._if_alive(lambda: all([rt.checkpoint_begin(step)
                                           for rt in self._rts]))

    def checkpoint_result(self, step) -> _Later:
        # deferred: the barrier on the background snapshot happens at
        # fetch time (restore path), not on the training hot path
        return _Later(lambda: [rt.checkpoint_result(step)
                               for rt in self._rts])

    def rollback(self) -> _Now:
        def run():
            bounds = [rt.rollback() for rt in self._rts]
            if len(set(bounds)) != 1:
                raise RuntimeError(
                    f"stage {self.stage_idx}: virtual chunks rolled back "
                    f"to different boundaries {bounds}")
            return bounds[0]
        return self._if_alive(run)

    def compile_counts(self) -> _Now:
        return self._call(lambda: [rt.compile_counts() for rt in self._rts])

    def state_digest(self) -> _Now:
        return self._call(lambda: [rt.state_digest() for rt in self._rts])

    def ping(self, timeout: Optional[float] = None) -> bool:
        return not self._dead

    def preempting(self) -> bool:
        return (not self._dead and bool(self._marker)
                and os.path.exists(self._marker))

    def kill(self):
        self._dead = True

    def fetch(self, fut, timeout: Optional[float] = None):
        return fut.result()


# ------------------------------------------------------------- stage gangs

class _GangFanout:
    """Composite future over every gang member for one gang-consistent
    op: fetched as a unit (rank 0's value is the gang's value, the other
    ranks are verified/drained), plus the shadow futures of earlier
    rank-fanned compute ops that resolve at this barrier."""

    __slots__ = ("items", "shadow", "reduce")

    def __init__(self, items, shadow, reduce):
        self.items = items          # [(member, fut)] — values kept
        self.shadow = shadow        # [(member, fut)] — drained, discarded
        self.reduce = reduce        # List[value] -> gang value


class GangStageHandle:
    """One pipeline stage as a GANG of replica members (in process: local
    stage handles). Dispatch is gang-consistent: every compute op goes to
    ALL members in the same order; rank 0's output is what the neighbour
    stage consumes, the other ranks' outputs become shadow futures
    drained at the step's apply barrier. State digests are gathered from
    every rank and must agree bit for bit; checkpoints ship rank 0's
    snapshot. The preemption/park/replay lifecycle is unchanged — the
    gang fails, parks, restores and replays as a unit."""

    def __init__(self, stage_idx: int, members: List[Any]):
        if not members:
            raise ValueError("a stage gang needs >= 1 member")
        self.stage_idx = stage_idx
        self.members = list(members)
        self._shadow: List[tuple] = []

    # ------------------------------------------------------------- compute
    def _fanout_compute(self, submit) -> Any:
        futs = [submit(m) for m in self.members]
        self._shadow.extend(zip(self.members[1:], futs[1:]))
        return futs[0]

    def forward(self, step, mb, x, target=None, chunk=0):
        return self._fanout_compute(
            lambda m: m.forward(step, mb, x, target, chunk=chunk))

    def backward(self, step, mb, gy=None, chunk=0):
        return self._fanout_compute(
            lambda m: m.backward(step, mb, gy, chunk=chunk))

    def apply_step(self, step):
        shadow, self._shadow = self._shadow, []
        items = [(m, m.apply_step(step)) for m in self.members]

        def reduce(vals):
            norm = [[v] if isinstance(v, dict) else list(v) for v in vals]
            steps = {m.get("step") for chunks in norm for m in chunks}
            if len(steps) > 1:
                raise StageLostError(
                    self.stage_idx,
                    f"gang ranks applied different steps {sorted(steps)}")
            return norm[0]
        return _GangFanout(items, shadow, reduce)

    # ------------------------------------------------------------- control
    def abort_step(self, step):
        # parking discards the in-flight step everywhere, shadows too
        self._shadow = []
        items = [(m, m.abort_step(step)) for m in self.members]
        return _GangFanout(items, [], lambda vals: all(vals))

    def checkpoint(self, step):
        items = [(m, m.checkpoint(step)) for m in self.members]
        return _GangFanout(items, [], lambda vals: vals[0])

    def checkpoint_begin(self, step):
        # every rank snapshots (each needs its OWN boundary for
        # rollback); only rank 0's snapshot leaves the gang
        items = [(m, m.checkpoint_begin(step)) for m in self.members]
        return _GangFanout(items, [], lambda vals: all(vals))

    def checkpoint_result(self, step):
        return self.members[0].checkpoint_result(step)

    def rollback(self):
        items = [(m, m.rollback()) for m in self.members]

        def reduce(vals):
            if len(set(vals)) != 1:
                raise RuntimeError(
                    f"stage {self.stage_idx}: gang ranks rolled back to "
                    f"different boundaries {vals}")
            return vals[0]
        return _GangFanout(items, [], reduce)

    def compile_counts(self):
        items = [(m, m.compile_counts()) for m in self.members]
        return _GangFanout(items, [], lambda vals: vals[0])

    def state_digest(self):
        items = [(m, m.state_digest()) for m in self.members]

        def reduce(vals):
            norm = [[v] if isinstance(v, str) else list(v) for v in vals]
            if any(n != norm[0] for n in norm[1:]):
                raise RuntimeError(
                    f"stage {self.stage_idx}: gang rank states diverged "
                    "(replicated-stage invariant broken)")
            return norm[0]
        return _GangFanout(items, [], reduce)

    def ping(self, timeout: Optional[float] = 5.0) -> bool:
        return all(m.ping(timeout=timeout) for m in self.members)

    def preempting(self) -> bool:
        return any(m.preempting() for m in self.members)

    def kill(self):
        for m in self.members:
            m.kill()

    def fetch(self, fut, timeout: Optional[float] = None):
        if isinstance(fut, _GangFanout):
            for m, f in fut.shadow:      # drain rank>0 compute outputs
                m.fetch(f, timeout=timeout)
            vals = [m.fetch(f, timeout=timeout) for m, f in fut.items]
            return fut.reduce(vals)
        return self.members[0].fetch(fut, timeout=timeout)


# -------------------------------------------------------------- controller

class MPMDPipelineTrainer:
    """Drives an S-stage MPMD pipeline over in-process stage handles:
    schedule dispatch, step-boundary snapshots, and the stage-loss
    lifecycle (park → rebuild → restore → replay → rejoin).

    stage_builders: one callable per VIRTUAL stage returning its
        :class:`StageDefinition`. With ``config.virtual_stages == v > 1``
        the V = len(builders) virtual stages fold onto S = V // v physical
        stage hosts in the interleaved wrap: virtual stage vs lives on
        host vs % S as chunk vs // S.
    stage_gang_sizes[s] > 1 widens physical stage s into a
        :class:`GangStageHandle` of that many in-process replicas.
    provision_fn(stage_idx, snapshot) overrides stage provisioning
        entirely (tests inject failing handles through this)."""

    def __init__(self, stage_builders: List[Callable],
                 config: Optional[MPMDConfig] = None,
                 failure_config: Optional[FailureConfig] = None,
                 *, stage_gang_sizes: Optional[List[int]] = None,
                 provision_fn: Optional[Callable] = None,
                 marker_dir: Optional[str] = None):
        self.builders = list(stage_builders)
        self.config = (config or MPMDConfig()).resolved()
        v = self.config.virtual_stages
        self.n_virtual = len(self.builders)
        if self.n_virtual % v:
            raise ValueError(
                f"virtual_stages={v} must divide the number of stage "
                f"builders ({self.n_virtual})")
        self.n_stages = self.n_virtual // v
        if self.n_stages < 2:
            raise ValueError("an MPMD pipeline needs >= 2 physical stages"
                             + (f" (got {self.n_virtual} builders at "
                                f"virtual_stages={v})" if v > 1 else ""))
        self.failure_config = failure_config or FailureConfig(
            max_failures=3, restart_policy="stage")
        self.stage_gang_sizes = stage_gang_sizes or [1] * self.n_stages
        self._provision_fn = provision_fn
        self.schedule = make_schedule(self.config.schedule, self.n_stages,
                                      self.config.n_microbatches, virtual=v)
        self.replay = MicrobatchReplayBuffer(
            self.config.replay_depth,
            n_microbatches=self.config.n_microbatches,
            peak_live_buffers=[peak_live_activations(ops)
                               for ops in self.schedule])
        self.handles: List[Any] = []
        self.last_stage_metrics: List[List[Dict[str, Any]]] = []
        self._snap_refs: Dict[int, Any] = {}   # stage -> snapshot/future
        self._ckpt_step = 0
        self._failures_left = self.failure_config.max_failures
        self.recoveries: List[Dict[str, Any]] = []
        self.history: List[Dict[str, Any]] = []
        self._markers: List[Optional[str]] = [None] * self.n_stages
        if marker_dir:
            os.makedirs(marker_dir, exist_ok=True)
            self._markers = [os.path.join(marker_dir, f"stage_{s}.preempt")
                             for s in range(self.n_stages)]

    # ---------------------------------------------------------- provision
    def _chunk_indices(self, stage_idx: int) -> List[int]:
        """Virtual-stage indices hosted by physical stage ``stage_idx``
        (the interleaved wrap: chunk c is virtual stage c*S + s)."""
        return [c * self.n_stages + stage_idx
                for c in range(self.config.virtual_stages)]

    def _provision(self, stage_idx: int, snapshot=None):
        if self._provision_fn is not None:
            return self._provision_fn(stage_idx, snapshot)
        return self._default_provision(stage_idx, snapshot)

    def _default_provision(self, stage_idx: int, snapshot=None):
        """The built-in stage host factory; provision_fn overrides can
        delegate here (it never re-enters the override)."""
        chunk_builders = [(vs, self.builders[vs])
                          for vs in self._chunk_indices(stage_idx)]
        gang = self.stage_gang_sizes[stage_idx]

        def member(r):
            return LocalStageHandle(
                stage_idx, self.n_virtual, self.config.n_microbatches,
                None, snapshot,
                preempt_marker=self._markers[stage_idx] if r == 0 else None,
                chunk_builders=chunk_builders)
        if gang > 1:
            return GangStageHandle(stage_idx, [member(r)
                                               for r in range(gang)])
        return member(0)

    def start(self):
        """Build the stages and take the step-0 checkpoint (so a loss
        before the first boundary can still restore)."""
        if self.handles:
            return self
        self.handles = [self._provision(s) for s in range(self.n_stages)]
        self._checkpoint_all(0)
        return self

    def preempt_marker(self, stage_idx: int) -> Optional[str]:
        """The per-stage notice-file path."""
        return self._markers[stage_idx]

    # -------------------------------------------------------------- fit
    def fit(self, data_fn: Callable[[int], tuple], n_steps: int
            ) -> Dict[str, Any]:
        """Run ``n_steps`` pipeline steps. ``data_fn(step)`` returns
        (inputs, targets): M first-stage input microbatches and M
        last-stage target microbatches. Returns the run summary."""
        self.start()
        step = 0
        while step < n_steps:
            step += 1
            inputs, targets = data_fn(step)
            self._check_shapes(inputs, targets)
            self.replay.record(step, inputs, targets)
            self._run_step_with_recovery(step, inputs, targets)
            if step % self.config.checkpoint_every == 0:
                self._checkpoint_all(step)
            self._migrate_preempting(step)
        return self.summary()

    def _check_shapes(self, inputs, targets):
        M = self.config.n_microbatches
        if len(inputs) != M or len(targets) != M:
            raise ValueError(
                f"data_fn must return {M} input + {M} target microbatches "
                f"(got {len(inputs)}/{len(targets)})")

    def summary(self) -> Dict[str, Any]:
        last = self.history[-1] if self.history else {}
        v = self.config.virtual_stages
        return {"steps": len({h["step"] for h in self.history}),
                "last_metrics": last,
                "history": self.history,
                "recoveries": self.recoveries,
                "schedule": self.config.schedule,
                "virtual_stages": v,
                "bubble_fraction_analytic": pipeline_bubble_fraction(
                    self.n_stages, self.config.n_microbatches, virtual=v),
                "bubble_fraction_analytic_plain": pipeline_bubble_fraction(
                    self.n_stages, self.config.n_microbatches),
                "peak_live_activations": [
                    peak_live_activations(ops) for ops in self.schedule],
                "replay_budget": self.replay.budget()}

    # ------------------------------------------------------ step execution
    def _run_step_with_recovery(self, step, inputs, targets):
        """Run one step; on stage loss, recover (park → replace →
        rollback) and replay the buffer — a loss DURING replay loops back
        into recovery against the same budget, so repeated failures
        converge or degrade deterministically."""
        try:
            self._run_step(step, inputs, targets)
            return
        except StageLostError as e:
            lost, cause = e.stages, e.cause
        while True:
            t_rec = time.perf_counter()
            boundary = self._prepare_recovery(step, lost, cause)
            try:
                replayed = self.replay.replayable_from(boundary)
                for t in replayed:
                    ins, tgts = self.replay.get(t)
                    self._run_step(t, ins, tgts)
            except StageLostError as e:
                lost, cause = e.stages, e.cause
                continue
            self.recoveries.append({
                "step": step, "stages": list(lost), "cause": cause,
                "boundary": boundary, "replayed_steps": list(replayed),
                "steps_lost": len(replayed),
                "recovery_s": round(time.perf_counter() - t_rec, 3)})
            return

    def _run_step(self, step, inputs, targets):
        """Dispatch one step's full schedule, then collect the per-stage
        apply barrier. Each history row holds the step's wall time, each
        physical stage's compute (its programs' device-synchronised time)
        and its idle share of the wall (``stage{s}_bubble_fraction``), and
        the last stage's mean microbatch loss."""
        t0 = time.perf_counter()
        apply_futs = self._dispatch(step, inputs, targets)
        metrics = self._collect_applies(step, apply_futs)
        wall = time.perf_counter() - t0
        self.last_stage_metrics = metrics
        row: Dict[str, Any] = {"step": step, "wall_s": round(wall, 6)}
        for s, per_chunk in enumerate(metrics):
            comp = sum(m.get("compute_s", 0.0) for m in per_chunk)
            row[f"stage{s}_compute_s"] = round(comp, 6)
            row[f"stage{s}_bubble_fraction"] = round(
                max(0.0, 1.0 - comp / wall), 4) if wall else 0.0
            for m in per_chunk:
                if "loss" in m:
                    row["loss"] = m["loss"]
        self.history.append(row)
        return row

    def _dispatch(self, step, inputs, targets):
        """Run the schedule over the virtual-chunk dependency graph:
        virtual stage vs = c*S + s consumes activations from vs-1 (hosted
        on stage (vs-1) % S — possibly the SAME host's previous chunk) and
        gradients from vs+1. Keys are virtual-stage indices, so the plain
        path (v=1, vs == s) is unchanged."""
        S = self.n_stages
        V = self.n_virtual
        queues = [list(ops) for ops in self.schedule]
        fwd_out: Dict[tuple, Any] = {}
        bwd_out: Dict[tuple, Any] = {}
        while any(queues):
            progressed = False
            for s in range(S):
                while queues[s]:
                    op = queues[s][0]
                    kind, mb, c = op[0], op[1], op_chunk(op)
                    vs = c * S + s
                    if kind == OP_FWD:
                        if vs == 0:
                            x = inputs[mb]
                        elif (vs - 1, mb) in fwd_out:
                            x = fwd_out[(vs - 1, mb)]
                        else:
                            break
                        tgt = targets[mb] if vs == V - 1 else None
                        fwd_out[(vs, mb)] = self.handles[s].forward(
                            step, mb, x, tgt, chunk=c)
                    else:
                        if vs < V - 1 and (vs + 1, mb) not in bwd_out:
                            break
                        gy = bwd_out[(vs + 1, mb)] if vs < V - 1 else None
                        bwd_out[(vs, mb)] = self.handles[s].backward(
                            step, mb, gy, chunk=c)
                    queues[s].pop(0)
                    progressed = True
            if not progressed:
                raise ValueError("pipeline schedule deadlocked in dispatch")
        return [h.apply_step(step) for h in self.handles]

    def _collect_applies(self, step, apply_futs):
        """Fetch every stage's apply barrier. Returns one per-chunk
        metrics LIST per stage."""
        metrics, first_err = [], None
        for s, fut in enumerate(apply_futs):
            try:
                got = self.handles[s].fetch(
                    fut, timeout=self.config.step_timeout_s)
                metrics.append([got] if isinstance(got, dict) else list(got))
            except Exception as e:
                if first_err is None:
                    first_err = (s, e)
        if first_err is not None:
            lost = [s for s, h in enumerate(self.handles)
                    if not h.ping(timeout=5.0)]
            raise StageLostError(
                lost[0] if lost else first_err[0],
                f"{type(first_err[1]).__name__}: {first_err[1]}",
                stages=lost or [first_err[0]])
        return metrics

    # ------------------------------------------------------- checkpointing
    def _checkpoint_all(self, step):
        """Step-boundary checkpoint of every stage. Async mode
        (config.async_checkpoint) splits the protocol: fetch the cheap
        ``checkpoint_begin`` acks (the host copy runs on each stage's
        background thread), then store the ``checkpoint_result`` futures
        UNRESOLVED — the barrier that waits for the snapshot moves to the
        recovery path."""
        if self.config.async_checkpoint:
            begun = [(s, h.checkpoint_begin(step))
                     for s, h in enumerate(self.handles)]
            for s, fut in begun:
                self.handles[s].fetch(fut, timeout=60.0)
            for s, h in enumerate(self.handles):
                self._snap_refs[s] = h.checkpoint_result(step)
        else:
            futs = [h.checkpoint(step) for h in self.handles]
            for s, fut in enumerate(futs):
                self._snap_refs[s] = self.handles[s].fetch(fut)
        self._ckpt_step = step

    def _resolve_snap(self, stage_idx: int):
        """Materialize a stored snapshot entry (async mode keeps
        _Later/_Now thunks; resolving one is the recovery-time barrier)."""
        snap = self._snap_refs.get(stage_idx)
        if snap is not None and hasattr(snap, "result"):
            snap = self._snap_refs[stage_idx] = snap.result()
        return snap

    def _restore_source(self, stage_idx: int):
        """Recovery ladder for a replacement stage: the in-memory snapshot
        first; the durable storage shard when it is gone."""
        snap = self._resolve_snap(stage_idx)
        if snap is not None:
            return snap
        if self.config.storage_path:
            from ray_tpu_torch.train.sharded_checkpoint import (
                restore_stage_shard)
            shards = [restore_stage_shard(self.config.storage_path, vs)
                      for vs in self._chunk_indices(stage_idx)]
            return shards[0] if len(shards) == 1 else shards
        raise PipelineDegradedError(
            f"no restore source for stage {stage_idx} (snapshot lost "
            "and no storage_path configured)")

    # ------------------------------------------------------------ recovery
    def _prepare_recovery(self, step, lost: List[int], cause: str = ""
                          ) -> int:
        """Budget check → park survivors at the bounded barrier → rebuild
        lost stages from their snapshots → roll survivors back to the
        checkpoint boundary. Returns the boundary step the replay must
        start after. Raises PipelineDegradedError when stage-level
        recovery cannot proceed (policy/budget/barrier)."""
        policy = self.failure_config.restart_policy
        if policy != "stage":
            raise PipelineDegradedError(
                f"stage {lost} lost at step {step} and "
                f"restart_policy={policy!r}: job-level restart required")
        if self._failures_left <= 0:
            raise PipelineDegradedError(
                f"stage {lost} lost at step {step}: failure budget "
                f"exhausted (max_failures="
                f"{self.failure_config.max_failures})")
        self._failures_left -= 1
        time.sleep(self.failure_config.restart_backoff_s)

        # 1. park survivors at the bounded-deadline barrier
        survivors = [s for s in range(self.n_stages) if s not in lost]
        deadline = time.monotonic() + self.config.barrier_deadline_s
        barrier = [(s, self.handles[s].abort_step(step)) for s in survivors]
        stragglers = []
        for s, fut in barrier:
            left = deadline - time.monotonic()
            try:
                self.handles[s].fetch(fut, timeout=max(0.1, left))
            except Exception:
                stragglers.append(s)
        if stragglers:
            raise PipelineDegradedError(
                f"survivors {stragglers} missed the "
                f"{self.config.barrier_deadline_s}s park barrier after "
                f"stage {lost} loss — degrading to job-level restart")

        # 2. rebuild lost stages from their snapshots
        for s in lost:
            self.handles[s].kill()
            self.handles[s] = self._provision(s, self._restore_source(s))

        # 3. roll surviving stages back to the checkpoint boundary
        boundary = self._ckpt_step
        roll = [(s, self.handles[s].rollback()) for s in survivors]
        for s, fut in roll:
            got = self.handles[s].fetch(fut, timeout=60.0)
            if got != boundary:
                raise PipelineDegradedError(
                    f"stage {s} rolled back to step {got}, controller "
                    f"checkpoint boundary is {boundary}")
        return boundary

    # --------------------------------------------------- graceful migration
    def _migrate_preempting(self, step):
        """Boundary-time migration for stages whose marker file appeared:
        fresh checkpoint, replacement built from it, old stage reaped —
        zero replayed steps, optimizer state untouched."""
        preempting = [s for s, h in enumerate(self.handles)
                      if h.preempting()]
        if not preempting:
            return
        self._checkpoint_all(step)
        for s in preempting:
            old = self.handles[s]
            self.handles[s] = self._provision(s, self._resolve_snap(s))
            old.kill()
            if self._markers[s]:
                try:
                    os.remove(self._markers[s])
                except FileNotFoundError:
                    pass

    # ------------------------------------------------------------- queries
    def _flatten_virtual(self, per_stage: List[Any]) -> List[Any]:
        """Reorder per-stage per-chunk lists into VIRTUAL-stage order
        (out[c*S + s] = stage s's chunk c) — the order a plain v=1 run
        over V single-chunk stages would report, so digests compare
        directly across schedules."""
        S, v = self.n_stages, self.config.virtual_stages
        norm = [[x] if not isinstance(x, list) else x for x in per_stage]
        out: List[Any] = [None] * self.n_virtual
        for s, chunks in enumerate(norm):
            if len(chunks) != v:
                raise RuntimeError(
                    f"stage {s} reported {len(chunks)} chunks, "
                    f"expected {v}")
            for c, val in enumerate(chunks):
                out[c * S + s] = val
        return out

    def compile_counts(self) -> List[Dict[str, int]]:
        """Per-VIRTUAL-stage program counters (virtual-stage order)."""
        futs = [h.compile_counts() for h in self.handles]
        got = [self.handles[s].fetch(f, timeout=30.0)
               for s, f in enumerate(futs)]
        return self._flatten_virtual(got)

    def state_digests(self) -> List[str]:
        """Per-VIRTUAL-stage state digests (virtual-stage order) —
        directly comparable between a v>1 run and a plain run over the
        same V builders."""
        futs = [h.state_digest() for h in self.handles]
        got = [self.handles[s].fetch(f, timeout=60.0)
               for s, f in enumerate(futs)]
        return self._flatten_virtual(got)

    def shutdown(self):
        for h in self.handles:
            h.kill()
        self.handles = []
