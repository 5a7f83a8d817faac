"""Elastic MPMD pipeline training: per-stage programs, host hand-offs
between stages, and stage-level recovery, with the stages in process or
as actors of the port's runtime.

Counterpart of ``ray_tpu/train/mpmd.py``. Each stage is its own program
with its own parameters and optimizer; the microbatch schedule (1F1B by
default, GPipe optional, interleaved virtual stages —
``parallel/pipeline.py``) is dispatched by the controller, and
activations and input-gradients cross every stage boundary as CPU tensors
(the JAX trainer hands host arrays across), keeping their dtype. Stages
are ``LocalStageHandle``s in process, or with ``remote=True``
``PipelineStageActor``s (``ActorStageHandle``; ``GangStageHandle`` for a
gang of them), each in its own worker process holding its own CUDA
context: there the controller passes object refs from stage to stage,
and the tensors ride the shared-memory object store.

A stage's forward runs under ``no_grad`` and saves its input; its
backward recomputes the forward under autograd and takes
``torch.autograd.grad`` of the output (the last stage: of its loss) with
respect to the parameters and the input, as the JAX stage takes
``jax.vjp``. Parameter gradients accumulate in CALL order, so a replayed
step accumulates exactly as the first run did; at the step boundary the
sum is divided by M and the stage's ``torch.optim`` optimizer steps in
place (the JAX programs donate their buffers instead).

Stage loss is a first-class lifecycle:

  notice   — a stage whose preemption-marker file exists (or whose
             host got the platform's preemption notice,
             ``accelerators.gpu.check_preemption_notice``) is migrated at
             the NEXT step boundary: fresh snapshot, replacement built
             from it, old stage reaped — zero steps replayed.
  crash    — a stage that dies mid-step (``fail_at``; the ``stage_step``
             chaos spec of ``util.chaos.StageKiller``, which SIGKILLs an
             actor stage's process; ``ray_tpu_torch.kill``) surfaces as a
             failed apply. Surviving stages PARK (abort the in-flight
             step, go back to the last checkpoint boundary); the lost
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
parameters in place. A boundary counts once every stage's snapshot is
sealed, as each handle's ``seal`` says: an in-process snapshot at once,
an actor's once it is in the object store, where it outlives the actor.
A stage that dies before sealing its snapshot (the ``stage_seal`` chaos
spec) loses that boundary; recovery then restores the survivors to the
last sealed one, and the replay buffer keeps every step after it.

The controller records the runtime's ``train.mpmd.*`` events and, while
the runtime is initialised, sets the ``runtime_mpmd_*`` gauges; with
``MPMDConfig.step_profile`` a ``StepProfiler("mpmd")``
(``util/profiling.py``) attributes each step, fed the FLOPs the stages
count. Not ported yet: a gang's ``topology`` (slice bundles, ROADMAP.md
Queue A item A3c-2).
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

from ray_tpu_torch.parallel.pipeline import (OP_BWD, OP_FWD, make_schedule,
                                             op_chunk, peak_live_activations,
                                             pipeline_bubble_fraction)
from ray_tpu_torch.train.config import FailureConfig
from ray_tpu_torch.util.profiling import count_flops, shape_key

# the JAX package's flag defaults (mpmd_replay_depth,
# mpmd_barrier_deadline_s, mpmd_step_timeout_s)
REPLAY_DEPTH = 2
BARRIER_DEADLINE_S = 30.0
STEP_TIMEOUT_S = 300.0


class StageLostError(RuntimeError):
    """One or more stages died or failed mid-step; carries the lost stage
    indexes (``stages=[]``: a step failed and no stage was shown lost,
    so every stage goes back to the boundary)."""

    def __init__(self, stage_idx: int, cause: str = "",
                 stages: Optional[List[int]] = None):
        self.stages = sorted(set(stages if stages is not None
                                 else [stage_idx]))
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


def block_stage_builders(cfg, weights, n_virtual: int, optimizer: Callable,
                         loss_chunk: int = 256,
                         device: Optional[str] = None) -> List[Callable]:
    """Builders of a decoder's blocks cut into ``n_virtual`` stages of
    ``cfg.n_layers / n_virtual`` blocks each (``models.BlockStage``), with
    the embedding and the unembedding outside the stages, as the JAX
    package's MPMD dry run keeps them: the first stage takes embedded
    inputs, and the last stage's loss is the chunked cross-entropy
    (``parallel.chunked_cross_entropy``) of its output against the
    unembedding of ``weights``, a model state_dict (``convert.init_params``),
    which stays fixed. Each build copies its blocks' weights out of
    ``weights``, so a stage rebuilt after a loss starts from them too
    (then takes its snapshot).

    For actor stages ``weights`` may instead be the object ref of a host
    (CPU) state_dict: each build then reads it from the object store in
    the stage's process and copies only its own blocks (and, on the last
    stage, the unembedding) to ``device`` (default ``"cuda"``)."""
    from ray_tpu_torch.models import BlockStage, stage_state_dict
    from ray_tpu_torch.parallel.train_step import chunked_cross_entropy

    if cfg.n_layers % n_virtual:
        raise ValueError(f"{cfg.n_layers} blocks do not cut into "
                         f"{n_virtual} stages")
    per = cfg.n_layers // n_virtual

    def source():
        """The state_dict and how a build copies a tensor out of it."""
        if isinstance(weights, dict):
            return weights, torch.Tensor.clone
        import ray_tpu_torch
        dev = torch.device(device or "cuda")
        return ray_tpu_torch.get(weights), lambda v: v.to(dev, copy=True)

    def builder(vs):
        w, place = source()
        stage = BlockStage(cfg, per, device="meta")
        stage.load_state_dict(
            {k: place(v) for k, v in
             stage_state_dict(w, vs * per, per).items()}, assign=True)
        loss_fn = None
        if vs == n_virtual - 1:
            table = (place(w["embed"]).t() if cfg.tie_embeddings
                     else place(w["unembed"])).to(cfg.dtype)

            def loss_fn(y, targets):
                return chunked_cross_entropy(y, table, targets,
                                             chunk=loss_chunk)[0]
        return StageDefinition(module=stage, optimizer=optimizer,
                               loss_fn=loss_fn)
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
    step_profile: bool = True               # runtime_mpmd_* attribution

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

    def record(self, step: int, inputs: List[Any], targets: List[Any],
               keep_after: Optional[int] = None):
        """Hold ``step``'s microbatches. With ``keep_after`` (the last
        boundary a recovery can restore), no step after it is evicted,
        even past ``depth``: a boundary whose snapshots take longer than
        a step to seal leaves recovery further back."""
        self._steps[step] = ([_as_host_tensor(x) for x in inputs],
                             [_as_host_tensor(t) for t in targets])
        while len(self._steps) > self.depth and (
                keep_after is None or min(self._steps) <= keep_after):
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

class _Program:
    """One stage program (forward, backward, accumulate or apply), keyed by
    its inputs as the JAX ``_AotProgram`` keys its compiled executables.
    Eager PyTorch compiles nothing: ``compile_count`` counts the distinct
    keys it was called with (the JAX program's traces), so 1 still means
    "no new input shape". With ``count_flops`` (the forward), the first
    call of each key runs under ``util/profiling.count_flops``, whose
    count of the aten products (and of attention, from its shapes) is
    kept as ``flops``."""

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
        key = shape_key(args)
        if key in self._keys or not self._count_flops:
            self._keys.add(key)
            return self._fn(*args)
        self._keys.add(key)
        out, self.flops = count_flops(self._fn, *args)
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
        forward's products as ``count_flops`` counted them (0 before
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

    def checkpoint_begin(self, step: int,
                         on_sealed: Optional[Callable] = None) -> bool:
        """Start a step-boundary snapshot OFF the hot path: a background
        thread makes the host copy, overlapping the next step's compute,
        then hands it to ``on_sealed`` (an actor stage's durable shard
        write)."""
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
                if on_sealed is not None:
                    on_sealed(snap)
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

    def restore(self, snap: Dict[str, Any]) -> int:
        """Load a given snapshot (an older boundary than the stage's own
        last one) after joining any in-flight copy; returns its step."""
        self._ckpt_barrier()
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


def _restore_chunks(rts: List[StageRuntime], snapshot) -> int:
    """Restore a host's runtimes from a boundary's snapshot: a single dict
    for the plain one-chunk host, a list (one per virtual chunk, chunk
    order) under interleaving. Returns the boundary step."""
    snaps = [snapshot] if isinstance(snapshot, dict) else list(snapshot)
    if len(snaps) != len(rts):
        raise ValueError(
            f"snapshot has {len(snaps)} chunk shards, host has "
            f"{len(rts)} virtual chunks")
    bounds = {rt.restore(snap) for rt, snap in zip(rts, snaps)}
    if len(bounds) != 1:
        raise RuntimeError(f"virtual chunks restored to different "
                           f"boundaries {sorted(bounds)}")
    return bounds.pop()


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
            _restore_chunks(self._rts, snapshot)
        self._marker = preempt_marker
        self._fail_at = fail_at
        self._dead = False
        self._incarnation = os.urandom(8).hex()

    def _chaos(self, step: int, op: str):
        if self._dead:
            raise StageLostError(self.stage_idx, "stage already dead")
        if self._fail_at is not None and self._fail_at == (step, op):
            self._fail_at = None
            self._dead = True
            raise StageLostError(self.stage_idx,
                                 f"armed failure at step {step} {op}")
        from ray_tpu_torch._private import rpc
        try:
            rpc._maybe_inject_failure("stage_step")
        except rpc.RpcError as e:
            self._dead = True
            raise StageLostError(self.stage_idx, str(e)) from e

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

    def seal(self, fut, timeout: Optional[float] = None):
        """What restores this stage from a boundary's snapshot future once
        it is sealed. An in-process snapshot cannot die with its stage, so
        it is sealed at once: a deferred one stays deferred (resolving it
        is the barrier, on the recovery path), a synchronous one is its
        value."""
        return fut if isinstance(fut, _Later) else fut.result()

    def rollback(self) -> _Now:
        def run():
            bounds = [rt.rollback() for rt in self._rts]
            if len(set(bounds)) != 1:
                raise RuntimeError(
                    f"stage {self.stage_idx}: virtual chunks rolled back "
                    f"to different boundaries {bounds}")
            return bounds[0]
        return self._if_alive(run)

    def restore(self, snapshot) -> _Now:
        return self._if_alive(lambda: _restore_chunks(self._rts, snapshot))

    def compile_counts(self) -> _Now:
        return self._call(lambda: [rt.compile_counts() for rt in self._rts])

    def state_digest(self) -> _Now:
        return self._call(lambda: [rt.state_digest() for rt in self._rts])

    def incarnation(self, timeout: Optional[float] = None) -> Optional[str]:
        """Who answers for the stage (None: nobody)."""
        return None if self._dead else self._incarnation

    def preempting(self) -> bool:
        if self._dead:
            return False
        if self._marker and os.path.exists(self._marker):
            return True
        from ray_tpu_torch._private.accelerators.gpu import \
            check_preemption_notice
        return check_preemption_notice()

    def stop(self):
        pass

    def kill(self):
        self._dead = True

    def fetch(self, fut, timeout: Optional[float] = None):
        return fut.result()


# ------------------------------------------------------------- actor stages

_KERNEL_WRAPPERS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv")


def _kernel_launches() -> Dict[str, int]:
    """This process's flash-kernel launch counters, by wrapper name (0
    before the attention module is first imported)."""
    import sys
    ops = sys.modules.get("ray_tpu_torch.ops.attention")
    return {n: int(getattr(ops, n).launches) if ops is not None else 0
            for n in _KERNEL_WRAPPERS}


class PipelineStageActor:
    """Actor hosting one pipeline stage in its own worker process (with
    ``num_gpus``, on the GPU the runtime assigned it: ``CUDA_VISIBLE_DEVICES``
    is set before this constructor runs). Compute methods ride the
    DEFAULT (ordered) concurrency group — dispatch order is execution
    order, which the replay-determinism guarantee leans on; control
    methods (incarnation/abort/rollback/...) declare the ``control`` group so
    the controller can park or probe a stage while compute is queued.
    Chaos: the ``stage_step`` injection SIGKILLs the process mid-step,
    the ``stage_seal`` one before a boundary's snapshot is sealed
    (``util.chaos.StageKiller``): the hardest deaths the recovery path
    must absorb. Each apply reports the flash-kernel launches this
    process made since the last step boundary (``launches``), which the
    controller sums over the stages."""

    def __init__(self, stage_idx: int, n_stages: int, n_microbatches: int,
                 builder: Optional[Callable] = None,
                 snapshot: Optional[Any] = None,
                 preempt_marker: Optional[str] = None,
                 chunk_builders: Optional[List[tuple]] = None):
        if chunk_builders is None:
            chunk_builders = [(stage_idx, builder)]
        self._rts = [
            StageRuntime(_build_definition(b, vs), stage_idx=vs,
                         n_stages=n_stages, n_microbatches=n_microbatches)
            for vs, b in chunk_builders]
        if snapshot is not None:
            _restore_chunks(self._rts, self._materialize(snapshot))
        self._launch_base = _kernel_launches()
        self._incarnation = f"{os.getpid()}-{os.urandom(4).hex()}"
        self._marker = preempt_marker
        self._preempting = False
        self._shard_writer = None
        self._storage_path: Optional[str] = None
        self._stop = threading.Event()
        self._watch = threading.Thread(target=self._watch_loop,
                                       name=f"stage-{stage_idx}-watch",
                                       daemon=True)
        self._watch.start()

    @staticmethod
    def _materialize(snapshot):
        """Snapshots may arrive as object refs — per chunk or whole —
        depending on the restore source."""
        import ray_tpu_torch

        def one(s):
            return s if s is None or isinstance(s, dict) \
                else ray_tpu_torch.get(s)
        if isinstance(snapshot, (list, tuple)):
            return [one(s) for s in snapshot]
        return one(snapshot)

    def _watch_loop(self):
        from ray_tpu_torch._private.accelerators.gpu import \
            check_preemption_notice
        from ray_tpu_torch._private.config import cfg
        while not self._stop.is_set():
            try:
                if (self._marker and os.path.exists(self._marker)) \
                        or check_preemption_notice():
                    self._preempting = True
            except Exception:
                pass   # rtlint: disable=RT004 — poll again next tick
            if self._stop.wait(cfg.mpmd_health_poll_s):
                return

    def _chaos(self, channel: str = "stage_step"):
        from ray_tpu_torch._private import rpc
        try:
            rpc._maybe_inject_failure(channel)
        except rpc.RpcError:
            # the chaos contract is a process DEATH mid-step, not a
            # catchable exception: survivors must recover from silence
            import signal
            os.kill(os.getpid(), signal.SIGKILL)

    def _launches_since_boundary(self) -> Dict[str, int]:
        now = _kernel_launches()
        out = {n: now[n] - self._launch_base[n] for n in now}
        self._launch_base = now
        return out

    # ------------------------------------------------------------- compute
    def forward(self, step, mb, x, target=None, chunk=0):
        self._chaos()
        return self._rts[chunk].forward(step, mb, x, target)

    def backward(self, step, mb, gy=None, chunk=0):
        self._chaos()
        return self._rts[chunk].backward(step, mb, gy)

    def apply_step(self, step):
        metrics = [rt.apply_step(step) for rt in self._rts]
        metrics[0]["launches"] = self._launches_since_boundary()
        return metrics

    def checkpoint(self, step):
        """Synchronous boundary snapshot."""
        self.checkpoint_begin(step)
        return self.checkpoint_result(step)

    def checkpoint_begin(self, step):
        """Rides the ordered compute queue (so it lands exactly at the
        step boundary) but only marks the boundary and hands the host
        copy (and the durable shard write) to background threads — the
        next step's compute is never behind a checkpoint write."""
        for rt in self._rts:
            rt.checkpoint_begin(step, on_sealed=self._sealed_hook(rt))
        return True

    def checkpoint_result(self, step):
        """Barrier + return the per-chunk snapshots (control group: the
        compute queue keeps draining while a caller waits here)."""
        self._chaos("stage_seal")
        return [rt.checkpoint_result(step) for rt in self._rts]

    def _sealed_hook(self, rt: StageRuntime):
        if not self._storage_path:
            return None
        if self._shard_writer is None:
            from ray_tpu_torch.train.sharded_checkpoint import \
                AsyncShardWriter
            self._shard_writer = AsyncShardWriter()
        writer, root, vs = self._shard_writer, self._storage_path, \
            rt.stage_idx

        def on_sealed(snap):
            writer.submit(root, vs, snap)
        return on_sealed

    def set_storage_path(self, path: Optional[str]):
        self._storage_path = path
        return True

    # ------------------------------------------------------------- control
    def abort_step(self, step):
        ok = all([rt.abort_step(step) for rt in self._rts])
        self._launch_base = _kernel_launches()
        return ok

    def rollback(self):
        # recovery is the shard-write barrier: a survivor's durable
        # state must be consistent before replay resumes over it
        if self._shard_writer is not None:
            try:
                self._shard_writer.barrier(timeout=60.0)
            except RuntimeError:
                import logging
                logging.getLogger(__name__).warning(
                    "stage %d: async shard write failed before rollback",
                    self._rts[0].stage_idx, exc_info=True)
        bounds = [rt.rollback() for rt in self._rts]
        if len(set(bounds)) != 1:
            raise RuntimeError(
                f"virtual chunks rolled back to different boundaries "
                f"{bounds}")
        self._launch_base = _kernel_launches()
        return bounds[0]

    def restore(self, snapshot):
        """Roll back to a given (older) boundary's snapshot, per chunk:
        the controller's last boundary whose snapshots all reached the
        object store, when this stage's own last one is newer."""
        step = _restore_chunks(self._rts, self._materialize(snapshot))
        self._launch_base = _kernel_launches()
        return step

    def compile_counts(self):
        return [rt.compile_counts() for rt in self._rts]

    def state_digest(self):
        return [rt.state_digest() for rt in self._rts]

    def trace_start(self):
        """Start torch.profiler in this process (CUDA kernels are
        recorded whichever thread launches them)."""
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return True

    def trace_stop(self):
        """Stop the profiler; returns this process's device time by
        kernel name, ``[(name, device_us, count)]``: kernels only, as an
        operator's row repeats its kernels' time."""
        from torch.autograd import DeviceType
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if (e.device_type == DeviceType.CUDA and us > 0
                    and not getattr(e, "is_user_annotation", False)):
                rows.append((e.key, float(us), int(e.count)))
        return rows

    def memory_stats(self):
        """This process's CUDA peak memory allocated (bytes; 0 on the
        CPU) and its pid."""
        dev = self._rts[0].device
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        return {"pid": os.getpid(), "peak_bytes": int(peak),
                "device": str(dev)}

    def incarnation(self):
        """This process's token: a restarted actor answers with another."""
        return self._incarnation

    def preempting(self):
        return self._preempting

    def stop(self):
        self._stop.set()
        return True


# control methods answer while compute is queued: tag the group on the
# plain functions (actor.py reads __concurrency_group__ through
# ray_tpu_torch.remote(), as @ray_tpu_torch.method(concurrency_group=...)).
# checkpoint_result is control-tagged on purpose: it BLOCKS on the
# background snapshot, and must not stall the ordered compute queue —
# checkpoint_begin stays on the compute queue so the capture lands
# exactly at the step boundary.
for _name in ("abort_step", "rollback", "restore", "compile_counts",
              "state_digest", "memory_stats", "trace_start", "trace_stop",
              "incarnation", "preempting", "stop",
              "set_storage_path", "checkpoint_result"):
    getattr(PipelineStageActor, _name).__concurrency_group__ = "control"
del _name


class ActorStageHandle:
    """Controller-side wrapper around a PipelineStageActor: methods
    return ObjectRefs (activations and grads stay in the object store —
    the controller passes refs between stages, never bytes)."""

    def __init__(self, stage_idx: int, actor):
        self.stage_idx = stage_idx
        self.actor = actor

    @classmethod
    def provision(cls, stage_idx: int, n_stages: int, n_microbatches: int,
                  builder: Optional[Callable] = None, snapshot=None,
                  preempt_marker: Optional[str] = None,
                  resources: Optional[Dict[str, float]] = None,
                  storage_path: Optional[str] = None,
                  chunk_builders: Optional[List[tuple]] = None,
                  extra_options: Optional[Dict[str, Any]] = None
                  ) -> "ActorStageHandle":
        """Start one stage actor. ``resources`` takes the runtime's
        resource names (``{"GPU": 0.5}`` shares one card with another
        stage); ``extra_options`` are further actor options
        (``runtime_env``, ``scheduling_strategy``)."""
        import ray_tpu_torch
        # one thread for the default group keeps it ordered (the JAX
        # package's max_concurrency=4 gives the default group four
        # threads, so an apply could run before the step's backwards)
        opts: Dict[str, Any] = {
            "max_concurrency": 1,
            "concurrency_groups": {"control": 2},
        }
        if resources:
            opts["resources"] = dict(resources)
        if extra_options:
            opts.update(extra_options)
        actor = ray_tpu_torch.remote(PipelineStageActor).options(
            **opts).remote(stage_idx, n_stages, n_microbatches, builder,
                           snapshot, preempt_marker, chunk_builders)
        h = cls(stage_idx, actor)
        if storage_path:
            h.fetch(actor.set_storage_path.remote(storage_path),
                    timeout=60.0)
        return h

    def forward(self, step, mb, x, target=None, chunk=0):
        return self.actor.forward.remote(step, mb, x, target, chunk)

    def backward(self, step, mb, gy=None, chunk=0):
        return self.actor.backward.remote(step, mb, gy, chunk)

    def apply_step(self, step):
        return self.actor.apply_step.remote(step)

    def abort_step(self, step):
        return self.actor.abort_step.remote(step)

    def checkpoint(self, step):
        return self.actor.checkpoint.remote(step)

    def checkpoint_begin(self, step):
        return self.actor.checkpoint_begin.remote(step)

    def checkpoint_result(self, step):
        return self.actor.checkpoint_result.remote(step)

    def seal(self, ref, timeout: Optional[float] = None):
        """The snapshot's ref once the snapshot is readable in the object
        store, where it outlives the actor (None: not yet, ``timeout=None``
        waits); StageLostError when the actor died before sealing it."""
        import ray_tpu_torch
        ready, _ = ray_tpu_torch.wait([ref], timeout=timeout)
        if not ready:
            return None
        try:
            ray_tpu_torch.get(ref, timeout=60.0)
        except Exception as e:
            raise StageLostError(self.stage_idx,
                                 f"snapshot never sealed: {e}") from e
        return ref

    def rollback(self):
        return self.actor.rollback.remote()

    def restore(self, snapshot):
        return self.actor.restore.remote(snapshot)

    def compile_counts(self):
        return self.actor.compile_counts.remote()

    def state_digest(self):
        return self.actor.state_digest.remote()

    def memory_stats(self):
        return self.actor.memory_stats.remote()

    def incarnation(self, timeout: Optional[float] = 5.0) -> Optional[str]:
        """The answering process's token (None: no answer in time)."""
        import ray_tpu_torch
        try:
            return ray_tpu_torch.get(self.actor.incarnation.remote(),
                                     timeout=timeout)
        except Exception:
            return None

    def preempting(self) -> bool:
        import ray_tpu_torch
        try:
            return bool(ray_tpu_torch.get(self.actor.preempting.remote(),
                                          timeout=5.0))
        except Exception:
            return False

    def stop(self):
        """Stop the actor's watch thread (before a clean kill)."""
        self.fetch(self.actor.stop.remote(), timeout=5.0)

    def kill(self):
        import ray_tpu_torch
        try:
            ray_tpu_torch.kill(self.actor)
        except Exception:
            pass   # rtlint: disable=RT004 — the actor may be gone

    def fetch(self, ref, timeout: Optional[float] = None):
        import ray_tpu_torch
        return ray_tpu_torch.get(ref, timeout=timeout)


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
    """One pipeline stage as a GANG of replica members (local stage
    handles in process, stage actors with ``provision``). Dispatch is
    gang-consistent: every compute op goes to ALL members in the same
    order; rank 0's output is what the neighbour stage consumes, the
    other ranks' outputs become shadow futures drained at the step's
    apply barrier. State digests are gathered from every rank and must
    agree bit for bit; checkpoints ship rank 0's snapshot. The
    preemption/park/replay lifecycle is unchanged — the gang fails,
    parks, restores and replays as a unit (any dead rank: the stage is
    lost and the whole gang is provisioned again)."""

    def __init__(self, stage_idx: int, members: List[Any]):
        if not members:
            raise ValueError("a stage gang needs >= 1 member")
        self.stage_idx = stage_idx
        self.members = list(members)
        self._shadow: List[tuple] = []

    @classmethod
    def provision(cls, stage_idx: int, n_stages: int, n_microbatches: int,
                  chunk_builders: List[tuple], snapshot=None, *,
                  gang_size: int, topology: Optional[str] = None,
                  resources: Optional[Dict[str, float]] = None,
                  preempt_marker: Optional[str] = None,
                  storage_path: Optional[str] = None) -> "GangStageHandle":
        """Provision a gang of stage actors, each scheduled by
        ``resources`` alone."""
        if topology:
            raise NotImplementedError(
                "a stage gang pinned to a slice topology is not ported yet "
                "(ROADMAP.md, Queue A item A3c-2)")
        members = [
            ActorStageHandle.provision(
                stage_idx, n_stages, n_microbatches, None, snapshot,
                # only rank 0 watches the notice channel; preemption of
                # any other rank surfaces as a dead rank at the barrier
                preempt_marker=preempt_marker if r == 0 else None,
                resources=resources,
                storage_path=storage_path if r == 0 else None,
                chunk_builders=chunk_builders)
            for r in range(gang_size)]
        return cls(stage_idx, members)

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

    def seal(self, fut, timeout: Optional[float] = None):
        if isinstance(fut, _GangFanout):
            # a synchronous checkpoint: every rank took its snapshot, rank
            # 0's leaves the gang
            try:
                for m, f in fut.items[1:]:
                    m.fetch(f, timeout=timeout)
            except Exception as e:
                raise StageLostError(self.stage_idx,
                                     f"a rank's snapshot failed: {e}") from e
            fut = fut.items[0][1]
        return self.members[0].seal(fut, timeout)

    def rollback(self):
        items = [(m, m.rollback()) for m in self.members]

        def reduce(vals):
            if len(set(vals)) != 1:
                raise RuntimeError(
                    f"stage {self.stage_idx}: gang ranks rolled back to "
                    f"different boundaries {vals}")
            return vals[0]
        return _GangFanout(items, [], reduce)

    def restore(self, snapshot):
        items = [(m, m.restore(snapshot)) for m in self.members]
        return _GangFanout(items, [], lambda vals: vals[0])

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

    def incarnation(self, timeout: Optional[float] = 5.0):
        """Every member's token (None: a member did not answer)."""
        got = tuple(m.incarnation(timeout=timeout) for m in self.members)
        return None if None in got else got

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


def _names_own_death(handle, err: BaseException) -> bool:
    """Whether a stage's own fetch error says that the stage's process
    died: a StageLostError the stage raised itself, or the runtime's
    ActorDiedError / WorkerCrashedError naming one of its actors. A peer's
    death carried in through an input names the peer, not this stage."""
    from ray_tpu_torch._private.serialization import (ActorDiedError,
                                                      TaskError,
                                                      WorkerCrashedError)
    ids = [m.actor._actor_id[:12]
           for m in getattr(handle, "members", [handle])
           if hasattr(m, "actor")]
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if isinstance(err, StageLostError):
            return err.stage_idx == handle.stage_idx
        if isinstance(err, (ActorDiedError, WorkerCrashedError)):
            return any(i in str(err) for i in ids)
        err = err.cause if isinstance(err, TaskError) else err.__cause__
    return False


# -------------------------------------------------------------- controller

class MPMDPipelineTrainer:
    """Drives an S-stage MPMD pipeline: schedule dispatch, step-boundary
    snapshots, and the stage-loss lifecycle (park → rebuild → restore →
    replay → rejoin).

    stage_builders: one callable per VIRTUAL stage returning its
        :class:`StageDefinition`. With ``config.virtual_stages == v > 1``
        the V = len(builders) virtual stages fold onto S = V // v physical
        stage hosts in the interleaved wrap: virtual stage vs lives on
        host vs % S as chunk vs // S.
    remote=True provisions one :class:`PipelineStageActor` per stage
        (``ray_tpu_torch.init()`` first; ``stage_resources[s]`` are stage
        s's actor resources, e.g. ``{"GPU": 0.5}``); remote=False runs the
        stages in process.
    stage_gang_sizes[s] > 1 widens physical stage s into a
        :class:`GangStageHandle` of that many replicas (actors, or
        in-process handles).
    provision_fn(stage_idx, snapshot) overrides stage provisioning
        entirely (tests inject failing handles through this)."""

    def __init__(self, stage_builders: List[Callable],
                 config: Optional[MPMDConfig] = None,
                 failure_config: Optional[FailureConfig] = None,
                 *, remote: bool = False,
                 stage_resources: Optional[List[Dict[str, float]]] = None,
                 stage_gang_sizes: Optional[List[int]] = None,
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
        self.remote = remote
        self.stage_resources = stage_resources or [None] * self.n_stages
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
        # the confirmed boundary: its step and, per stage, what restores
        # the stage to it (a snapshot, a deferred one, or a store ref)
        self._snap_refs: Dict[int, Any] = {}
        self._ckpt_step = 0
        # (step, {stage: future}) of a boundary whose snapshots are not all
        # sealed yet, and the step of the last snapshot the stages took
        # (what their rollback returns to)
        self._pending: Optional[tuple] = None
        self._stage_snap_step = 0
        # what a degraded recovery reports: the last boundary dropped
        # (step, stage, cause) and the loss being recovered (step, stages,
        # cause)
        self._dropped: Optional[tuple] = None
        self._loss: Optional[tuple] = None
        # per stage, the token of the process that answered for it since
        # it was provisioned (``incarnation``)
        self._born: Dict[int, Any] = {}
        self._failures_left = self.failure_config.max_failures
        self.recoveries: List[Dict[str, Any]] = []
        self.history: List[Dict[str, Any]] = []
        self.profiler = None
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
        if self.remote:
            if gang > 1:
                return GangStageHandle.provision(
                    stage_idx, self.n_virtual, self.config.n_microbatches,
                    chunk_builders, snapshot, gang_size=gang,
                    resources=self.stage_resources[stage_idx],
                    preempt_marker=self._markers[stage_idx],
                    storage_path=self.config.storage_path)
            return ActorStageHandle.provision(
                stage_idx, self.n_virtual, self.config.n_microbatches,
                None, snapshot,
                preempt_marker=self._markers[stage_idx],
                resources=self.stage_resources[stage_idx],
                storage_path=self.config.storage_path,
                chunk_builders=chunk_builders)

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
        self._confirm_pending(timeout=60.0)
        self._note_incarnations()
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
        from ray_tpu_torch._private import events
        self.start()
        if self.config.step_profile and self.profiler is None:
            from ray_tpu_torch.util.profiling import StepProfiler
            self.profiler = StepProfiler(name="mpmd", category="train")
        with events.record_span("train.mpmd.fit", category="train",
                                n_stages=self.n_stages,
                                n_virtual=self.n_virtual,
                                n_microbatches=self.config.n_microbatches,
                                schedule=self.config.schedule):
            step = 0
            while step < n_steps:
                step += 1
                scope = self.profiler.step() if self.profiler else None
                if scope is not None:
                    scope.__enter__()
                inputs, targets = data_fn(step)
                self._check_shapes(inputs, targets)
                self.replay.record(step, inputs, targets,
                                   keep_after=self._ckpt_step)
                if scope is not None:
                    scope.data_ready()
                self._run_step_with_recovery(step, inputs, targets)
                if scope is not None:
                    scope.__exit__(None, None, None)
                # checkpoints run outside the step's scope: their residue
                # shows up as the next step's host gap
                if step % self.config.checkpoint_every == 0:
                    self._checkpoint_all(step)
                self._confirm_pending(timeout=0.0)
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
            boundary, restored = self._prepare_recovery(step, lost, cause)
            try:
                replayed = self.replay.replayable_from(boundary)
                for t in replayed:
                    ins, tgts = self.replay.get(t)
                    self._run_step(t, ins, tgts)
            except StageLostError as e:
                lost, cause = e.stages, e.cause
                continue
            self._note_recovery(step, lost, cause, boundary, restored,
                                replayed, time.perf_counter() - t_rec)
            return

    def _note_recovery(self, step, lost, cause, boundary, restored,
                       replayed, recovery_s):
        from ray_tpu_torch._private import events
        self.recoveries.append({
            "step": step, "stages": list(lost), "cause": cause,
            "boundary": boundary, "survivors_restored": restored,
            "replayed_steps": list(replayed),
            "steps_lost": len(replayed),
            "recovery_s": round(recovery_s, 3)})
        events.record_instant(
            "train.mpmd.stage_rejoined", category="train", step=step,
            stages=",".join(map(str, lost)), boundary=boundary,
            steps_replayed=len(replayed),
            recovery_ms=round(recovery_s * 1e3, 1))

    def _run_step(self, step, inputs, targets):
        """Dispatch one step's full schedule, then collect the per-stage
        apply barrier. Each history row holds the step's wall time, each
        physical stage's compute (its programs' device-synchronised time)
        and its idle share of the wall (``stage{s}_bubble_fraction``), and
        the last stage's mean microbatch loss; with actor stages also the
        flash-kernel launches the stage processes made in the step,
        summed (``launches``)."""
        from ray_tpu_torch._private import events
        t0 = time.perf_counter()
        apply_futs = self._dispatch(step, inputs, targets)
        metrics = self._collect_applies(step, apply_futs)
        wall = time.perf_counter() - t0
        self.last_stage_metrics = metrics
        row: Dict[str, Any] = {"step": step, "wall_s": round(wall, 6)}
        total_flops = 0.0
        total_compute = 0.0
        launches: Dict[str, int] = {}
        for s, per_chunk in enumerate(metrics):
            comp = sum(m.get("compute_s", 0.0) for m in per_chunk)
            total_compute += comp
            total_flops += sum(m.get("flops", 0.0) for m in per_chunk)
            row[f"stage{s}_compute_s"] = round(comp, 6)
            row[f"stage{s}_bubble_fraction"] = round(
                max(0.0, 1.0 - comp / wall), 4) if wall else 0.0
            for m in per_chunk:
                if "loss" in m:
                    row["loss"] = m["loss"]
                for k, n in m.get("launches", {}).items():
                    launches[k] = launches.get(k, 0) + n
        if launches:
            row["launches"] = launches
        self.history.append(row)
        if self.profiler is not None and total_flops:
            self.profiler.set_cost(total_flops)
        self._emit_stage_gauges(row, wall, total_compute)
        events.record_instant(
            "train.mpmd.step", category="train", step=step,
            wall_ms=round(wall * 1e3, 3),
            **({"loss": row["loss"]} if "loss" in row else {}))
        return row

    def _emit_stage_gauges(self, row, wall, total_compute):
        """Per-stage compute/bubble/transfer attribution as
        ``runtime_mpmd_*`` gauges, while the runtime is initialised (its
        metrics pusher ships them to the GCS)."""
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            return
        from ray_tpu_torch.util.metrics import Gauge
        if not hasattr(self, "_stage_gauges"):
            self._stage_gauges = {
                "compute_ms": Gauge(
                    "runtime_mpmd_stage_compute_ms",
                    "per-stage on-device compute in the last step",
                    tag_keys=("stage",)),
                "bubble": Gauge(
                    "runtime_mpmd_stage_bubble_fraction",
                    "per-stage idle fraction of the last step wall",
                    tag_keys=("stage",)),
                "transfer_ms": Gauge(
                    "runtime_mpmd_transfer_ms",
                    "step wall not attributed to any stage's compute "
                    "(activation transfer + dispatch + collectives)"),
            }
        for s in range(self.n_stages):
            tags = {"stage": str(s)}
            self._stage_gauges["compute_ms"].set(
                row.get(f"stage{s}_compute_s", 0.0) * 1e3, tags=tags)
            self._stage_gauges["bubble"].set(
                row.get(f"stage{s}_bubble_fraction", 0.0), tags=tags)
        # stages overlap in time, so Σ compute can exceed wall; clamp —
        # the unclamped signal still lives in the per-stage gauges
        self._stage_gauges["transfer_ms"].set(
            max(0.0, wall - total_compute) * 1e3)

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
        metrics LIST per stage. When a fetch raises, a stage is named
        lost only on evidence about that stage: its ping goes unanswered,
        it answers from another incarnation than before, or its own error
        says that its process died (``_names_own_death``). The order of
        the fetches decides nothing: a stage whose apply failed because a
        peer's output never came is a survivor. With no evidence the
        error names no stage, and every stage goes back to the
        boundary."""
        metrics, errors = [], {}
        for s, fut in enumerate(apply_futs):
            try:
                got = self.handles[s].fetch(
                    fut, timeout=self.config.step_timeout_s)
                metrics.append([got] if isinstance(got, dict) else list(got))
            except Exception as e:
                errors[s] = e
        if not errors:
            return metrics
        evidence = {}
        for s, h in enumerate(self.handles):
            now = h.incarnation(timeout=5.0)
            if now is None:
                evidence[s] = "ping unanswered"
            elif self._born.get(s, now) != now:
                evidence[s] = "answered from a new incarnation"
            elif s in errors and _names_own_death(h, errors[s]):
                evidence[s] = "its own error says it died"
        first = min(errors)
        lost = sorted(evidence)
        raise StageLostError(
            lost[0] if lost else first,
            f"apply raised in stages {sorted(errors)}, stage {first}'s "
            f"{type(errors[first]).__name__}: {errors[first]}; evidence "
            f"{evidence or 'none: every stage answers as before'}",
            stages=lost)

    def _note_incarnations(self):
        """Remember who answers for each stage that has no record yet (a
        stage provisioned since), to tell a restarted process later."""
        for s, h in enumerate(self.handles):
            if s not in self._born:
                now = h.incarnation(timeout=5.0)
                if now is not None:
                    self._born[s] = now

    # ------------------------------------------------------- checkpointing
    def _checkpoint_all(self, step):
        """Step-boundary checkpoint of every stage. Async mode
        (config.async_checkpoint) fetches the cheap ``checkpoint_begin``
        acks (each stage makes its host copy on a background thread) and
        keeps the ``checkpoint_result`` futures; sync mode keeps
        ``checkpoint``'s. The boundary moves to ``step`` once every
        stage's snapshot is sealed (``_confirm_pending``; each handle's
        ``seal`` says when): an in-process snapshot at once, an actor's
        once it is in the object store, which takes a large stage seconds
        after the boundary. Until then recovery restores the last
        confirmed boundary. A new checkpoint first waits for the pending
        one."""
        self._confirm_pending(timeout=None)
        if self.config.async_checkpoint:
            begun = [(s, h.checkpoint_begin(step))
                     for s, h in enumerate(self.handles)]
            for s, fut in begun:
                self.handles[s].fetch(fut, timeout=60.0)
            futs = {s: h.checkpoint_result(step)
                    for s, h in enumerate(self.handles)}
        else:
            futs = {s: h.checkpoint(step) for s, h in enumerate(self.handles)}
        self._pending = (step, futs)
        self._stage_snap_step = step
        self._confirm_pending(
            timeout=0.0 if self.config.async_checkpoint else None)

    def _confirm_pending(self, timeout: Optional[float]) -> bool:
        """Move the boundary to the pending checkpoint once every stage's
        snapshot is sealed (``timeout=None``: wait for it). A stage that
        died before sealing its snapshot drops the pending checkpoint;
        the last confirmed boundary stays. Returns whether nothing is
        pending any more."""
        if self._pending is None:
            return True
        step, futs = self._pending
        deadline = None if timeout is None else time.monotonic() + timeout
        sealed = {}
        for s, fut in futs.items():
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            try:
                snap = self.handles[s].seal(fut, left)
            except StageLostError as e:
                self._pending = None    # this boundary is lost
                self._dropped = (step, s, e.cause)
                return True
            if snap is None:
                return False
            sealed[s] = snap
        self._pending = None
        self._snap_refs = sealed
        self._ckpt_step = step
        return True

    def _resolve_snap(self, stage_idx: int):
        """What restores a stage to the confirmed boundary (a deferred
        in-process snapshot is resolved here: the recovery-time
        barrier)."""
        snap = self._snap_refs.get(stage_idx)
        if isinstance(snap, _Later):
            snap = self._snap_refs[stage_idx] = snap.result()
        return snap

    def _restore_source(self, stage_idx: int):
        """Recovery ladder for a replacement stage: the confirmed
        boundary's snapshot first; the durable storage shard when it is
        gone."""
        snap = self._resolve_snap(stage_idx)
        if snap is not None:
            return snap
        if self.config.storage_path:
            from ray_tpu_torch.train.sharded_checkpoint import (
                restore_stage_shard)
            # actor stages: through the weight plane, so the replacement
            # reads the shard from its node's arena
            shards = [restore_stage_shard(self.config.storage_path, vs,
                                          broadcast=self.remote)
                      for vs in self._chunk_indices(stage_idx)]
            return shards[0] if len(shards) == 1 else shards
        raise PipelineDegradedError(
            f"no restore source for stage {stage_idx} (snapshot lost "
            f"and no storage_path configured): (step, stages, cause) lost "
            f"{self._loss}; confirmed boundary "
            f"{self._ckpt_step if self._snap_refs else None}; last "
            f"dropped boundary (step, stage, cause) {self._dropped}")

    # ------------------------------------------------------------ recovery
    def _prepare_recovery(self, step, lost: List[int], cause: str = ""
                          ) -> tuple:
        """Budget check → park survivors at the bounded barrier → rebuild
        lost stages from their snapshots → roll survivors back to the
        checkpoint boundary. Returns the boundary step the replay must
        start after, and whether the survivors were restored to it (their
        own last snapshot was newer) rather than rolled back. Raises PipelineDegradedError when stage-level
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
        self._loss = (step, list(lost), cause)
        from ray_tpu_torch._private import events
        events.record_instant(
            "train.mpmd.stage_lost", category="train", step=step,
            stages=",".join(map(str, lost)), cause=cause[:200])
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

        # a pending boundary counts if every snapshot of it was sealed (a
        # lost stage's either was or failed): wait out the survivors'
        self._confirm_pending(timeout=self.config.barrier_deadline_s)
        self._pending = None

        # 2. rebuild lost stages from their snapshots
        for s in lost:
            self.handles[s].kill()
            self._born.pop(s, None)
            self.handles[s] = self._provision(s, self._restore_source(s))

        # 3. roll surviving stages back to the checkpoint boundary: their
        # own last snapshot, or, when that boundary was never sealed, the
        # confirmed one
        boundary = self._ckpt_step
        restored = self._stage_snap_step != boundary
        roll = [(s, self.handles[s].restore(self._resolve_snap(s))
                 if restored else self.handles[s].rollback())
                for s in survivors]
        for s, fut in roll:
            got = self.handles[s].fetch(fut, timeout=60.0)
            if got != boundary:
                raise PipelineDegradedError(
                    f"stage {s} rolled back to step {got}, controller "
                    f"checkpoint boundary is {boundary}")
        self._stage_snap_step = boundary
        self._note_incarnations()
        return boundary, restored

    # --------------------------------------------------- graceful migration
    def _migrate_preempting(self, step):
        """Boundary-time migration for stages whose marker file appeared:
        fresh checkpoint, replacement built from it, old stage reaped —
        zero replayed steps, optimizer state untouched."""
        preempting = [s for s, h in enumerate(self.handles)
                      if h.preempting()]
        if not preempting:
            return
        from ray_tpu_torch._private import events
        self._checkpoint_all(step)
        self._confirm_pending(timeout=None)
        if self._ckpt_step != step:
            return     # a stage died unsealed: the next step recovers it
        for s in preempting:
            old = self.handles[s]
            self.handles[s] = self._provision(s, self._resolve_snap(s))
            self._born.pop(s, None)
            old.kill()
            if self._markers[s]:
                try:
                    os.remove(self._markers[s])
                except FileNotFoundError:
                    pass
            events.record_instant(
                "train.mpmd.stage_migrated", category="train", step=step,
                stage=s)
        self._note_incarnations()

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

    def memory_stats(self) -> List[Dict[str, Any]]:
        """Each actor stage process's pid and CUDA peak memory allocated
        (``peak_bytes``), one entry per actor (gang members included)."""
        out = []
        for h in self.handles:
            for m in getattr(h, "members", [h]):
                out.append(m.fetch(m.memory_stats(), timeout=30.0))
        return out

    def shutdown(self):
        for h in self.handles:
            for m in getattr(h, "members", [h]):
                try:
                    m.stop()
                except Exception:
                    pass   # rtlint: disable=RT004 — teardown best-effort
                m.kill()
        self.handles = []
