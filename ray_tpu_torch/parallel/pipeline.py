"""Pipeline parallelism: the GPipe microbatch schedule over the ``stage``
mesh axis, and the host-level schedules of the MPMD pipeline trainer.

Counterpart of ``ray_tpu/parallel/pipeline.py``. The JAX package keeps the
whole pipeline inside one jitted SPMD program: stage weights sharded over
``stage``, activations hopping stage to stage by ``lax.ppermute`` and the
tick loop a ``lax.scan``. Under PyTorch each rank is its own process, so
the tick loop runs in Python on every rank of a ``stage`` group: rank s
holds stage s's row of the stacked parameters (a ``Shard(0)`` DTensor over
the mesh's ``stage`` dim, or a plain row), and the activation shifts to
the next rank through ``ops.ring_attention.ppermute``, a differentiable
``batch_isend_irecv`` whose backward sends the gradient back.

Schedule (S stages, M microbatches, T = M + S - 1 ticks):

    tick t: stage s computes microbatch (t - s) if 0 <= t - s < M
            then shifts its output to stage s+1

Bubble fraction = (S-1)/T, the classic GPipe overhead; amortize with M >> S.

As in the JAX program, every stage computes at every tick (an idle tick
computes on an activation nobody keeps, whose gradient is zero), and the
M kept ticks are a slice of all T: so every rank builds the same autograd
graph, reaches every tick's shift in the backward, and runs the
backward's sends and receives in the same order. Two boundaries that one SPMD program gets
right by itself are made explicit here: the output is the last stage's,
sent to every rank, and its gradient is the last stage's own (every rank
computes the same loss, so summing over ranks would count it S times);
the input's gradient comes out of stage 0 alone (the others take the
shifted activation) and is sent from stage 0 to every rank, so a
replicated parameter used before the pipeline (an embedding) gets the
same gradient everywhere.

The MPMD schedules below are plain Python, copied from the JAX module.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.ring_attention import ppermute
from ray_tpu_torch.parallel.mesh import AXIS_STAGE, axis_group


def stack_stage_params(per_stage_params: list) -> Dict[str, torch.Tensor]:
    """Stack a list of per-stage param dicts (state_dicts) into one dict
    with a leading stage dim (shard it over ``stage`` with
    ``shard_stage_params``)."""
    names = list(per_stage_params[0])
    for p in per_stage_params[1:]:
        if list(p) != names:
            raise ValueError("every stage needs the same parameter names")
    return {n: torch.stack([p[n] for p in per_stage_params]) for n in names}


def stage_param_specs(stacked_params: Dict[str, torch.Tensor],
                      stage_axis: str = AXIS_STAGE) -> Dict[str, tuple]:
    """Mesh specs sharding the leading (stage) dim of every tensor: the
    JAX ``PartitionSpec(stage_axis, None, ...)`` as a tuple."""
    return {n: (stage_axis,) + (None,) * (t.dim() - 1)
            for n, t in stacked_params.items()}


def shard_stage_params(stacked_params: Dict[str, torch.Tensor], mesh,
                       stage_axis: str = AXIS_STAGE
                       ) -> Dict[str, "DTensor"]:
    """Whole stacked tensors, the same on every rank -> DTensors placed as
    ``stage_param_specs`` says (each rank keeps its own stage's row; no
    communication)."""
    specs = stage_param_specs(stacked_params, stage_axis)
    # DTensor loads here, not with the module: the MPMD schedules below
    # need none of it
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.parallel.sharding import spec_to_placements
    return {n: distribute_tensor(t, mesh, spec_to_placements(specs[n], mesh),
                                 src_data_rank=None)
            for n, t in stacked_params.items()}


class _FromLastStage(torch.autograd.Function):
    """The last stage's output sent to every rank of the stage group. Its
    gradient is the last stage's own: every rank computes the same loss
    from it, so the others' gradients are dropped, not summed."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        size = dist.get_world_size(group)
        ctx.is_last = dist.get_rank(group) == size - 1
        y = y.contiguous()
        dist.broadcast(y, dist.get_global_rank(group, size - 1),
                       group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.is_last else torch.zeros_like(grad)), None


class _ToAllStages(torch.autograd.Function):
    """The microbatches, the same on every rank, going into the pipeline.
    Only stage 0 reads them, so their gradient is stage 0's, sent to every
    rank of the stage group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.broadcast(grad, dist.get_global_rank(ctx.group, 0),
                       group=ctx.group)
        return grad, None


def _local_row(t, s: int, n_stages: int):
    """This rank's stage row of a stacked tensor: the local [1, ...] shard
    of a DTensor sharded over stage, or row s of a plain tensor holding
    every stage."""
    from torch.distributed.tensor import DTensor
    rows = t.to_local() if isinstance(t, DTensor) else t
    want = 1 if isinstance(t, DTensor) else n_stages
    if rows.shape[0] != want:
        raise ValueError(f"a stacked tensor holds {rows.shape[0]} stage "
                         f"rows here, want {want}")
    return rows[0] if isinstance(t, DTensor) else rows[s]


def pipeline_apply(stage_fn: Callable[[Dict[str, torch.Tensor],
                                       torch.Tensor], torch.Tensor],
                   stacked_params: Dict[str, Any],
                   microbatches: torch.Tensor,
                   mesh=None,
                   stage_axis: str = AXIS_STAGE) -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage GPipe pipeline over the mesh's
    ``stage_axis`` (S = 1 without a mesh, or on a mesh without that dim).

    stage_fn(params, x) -> y must preserve the activation shape (the
    classic homogeneous-stage pipeline; embed/unembed live outside);
    ``params`` is one stage's dict of tensors (``torch.func.functional_call``
    over a stage module gives such a function).

    stacked_params: dict of tensors with leading dim S (see
        ``stack_stage_params``), sharded over ``stage_axis``
        (``shard_stage_params``) or plain.
    microbatches: [M, mb, ...], the same plain tensor on every rank.
    Returns [M, mb, ...] outputs of the final stage, the same on every rank.

    Differentiable: gradients flow back through the ``ppermute`` chain, to
    the DTensor (or plain) stacked parameters and to the microbatches.
    """
    group = axis_group(mesh, stage_axis) if mesh is not None else None
    if group is not None and dist.get_world_size(group) == 1:
        group = None                             # a stage dim of size 1
    S = 1 if group is None else dist.get_world_size(group)
    s = 0 if group is None else dist.get_rank(group)
    M = microbatches.shape[0]
    T = M + S - 1

    params = {n: _local_row(t, s, S) for n, t in stacked_params.items()}
    xs = microbatches if group is None else _ToAllStages.apply(
        microbatches, group)
    first = torch.tensor(s == 0, device=xs.device)
    prev = torch.zeros_like(xs[0])               # activation shifted in
    outs = []
    for t in range(T):
        fresh = xs[min(t, M - 1)]
        out = stage_fn(params, torch.where(first, fresh, prev))
        outs.append(out)
        if t + 1 < T:
            prev = ppermute(out, group)
    # outs[t] on stage s is microbatch (t - s): keep my M valid ticks. The
    # slice of the stacked ticks gives every tick a gradient (zero where
    # it is not kept), so every rank runs each tick's ppermute backward
    mine = torch.stack(outs)[s:s + M]
    return mine if group is None else _FromLastStage.apply(mine, group)


def make_pipeline_fns(stage_fn: Callable, mesh=None,
                      stage_axis: str = AXIS_STAGE) -> Callable:
    """Convenience: returns apply(stacked_params, microbatches) closed over
    the mesh."""
    def apply(stacked_params, microbatches):
        return pipeline_apply(stage_fn, stacked_params, microbatches,
                              mesh, stage_axis)
    return apply


# --------------------------------------------------------- MPMD schedules
# Host-level microbatch schedules for the MPMD pipeline (train/mpmd.py):
# per-stage programs, activations handed stage to stage by the host
# instead of ppermute. Ops are ("F", mb) / ("B", mb) tuples in per-stage
# execution order — or ("F", mb, chunk) triples when the stage hosts
# interleaved virtual chunks (schedule_interleaved_1f1b); cross-stage data
# dependencies (F(vs, m) needs F(vs-1, m)'s activation, B(vs, m) needs
# B(vs+1, m)'s input-gradient, in VIRTUAL stage order vs = chunk*S + s)
# are enforced by the dispatcher, not the schedule — these lists only fix
# each stage's LOCAL order, which is what determines both the bubble and
# the grad-accumulation order (replay determinism depends on the latter).

OP_FWD = "F"
OP_BWD = "B"


def op_chunk(op) -> int:
    """Virtual-chunk index of a schedule op; plain (op, mb) tuples are
    chunk 0."""
    return op[2] if len(op) > 2 else 0


def _schedule_chunks(schedules) -> int:
    """Number of virtual chunks per stage in a schedule (v); 1 for the
    plain 2-tuple schedules."""
    v = 1
    for ops in schedules:
        for op in ops:
            v = max(v, op_chunk(op) + 1)
    return v


def schedule_gpipe(n_stages: int, n_microbatches: int):
    """GPipe (all-forward then all-backward) per-stage op lists. Peak
    live activations = n_microbatches on every stage."""
    if n_stages < 1 or n_microbatches < 1:
        raise ValueError("need n_stages >= 1 and n_microbatches >= 1")
    M = n_microbatches
    return [[(OP_FWD, m) for m in range(M)] + [(OP_BWD, m) for m in range(M)]
            for _ in range(n_stages)]


def schedule_1f1b(n_stages: int, n_microbatches: int):
    """Non-interleaved 1F1B (PipeDream-flush): stage s runs
    min(S-1-s, M) warmup forwards, then alternates one-forward/
    one-backward, then drains the remaining backwards. Same bubble as
    GPipe but peak live activations drop from M to min(S-s, M) — the
    schedule the MPMD trainer defaults to."""
    if n_stages < 1 or n_microbatches < 1:
        raise ValueError("need n_stages >= 1 and n_microbatches >= 1")
    S, M = n_stages, n_microbatches
    out = []
    for s in range(S):
        warmup = min(S - 1 - s, M)
        ops = [(OP_FWD, m) for m in range(warmup)]
        for i in range(M - warmup):
            ops.append((OP_FWD, warmup + i))
            ops.append((OP_BWD, i))
        for i in range(max(M - warmup, 0), M):
            ops.append((OP_BWD, i))
        out.append(ops)
    return out


def schedule_interleaved_1f1b(n_stages: int, n_microbatches: int, v: int):
    """Interleaved (virtual-stage) 1F1B, the arXiv 2412.14374 /
    Megatron-style schedule: each physical stage s hosts v virtual
    chunks, chunk c being virtual stage vs = c*S + s of a V = v*S deep
    virtual pipeline. Forwards fill in round-robin blocks of S
    microbatches per chunk, backwards drain the same way, so the flush
    bubble shrinks from (S-1)/(M+S-1) toward (S-1)/(v*M+S-1).

    Ops are (op, mb, chunk) triples, with each chunk's forwards AND
    backwards in strict microbatch order — the backward order is what
    makes grad accumulation, and therefore recovery replay, bit-
    identical to running the V virtual stages as V plain 1F1B stages.

    When M % S == 0 (Megatron's requirement) the closed-form ordering
    is used and the modeled bubble meets the analytic bound exactly:
    stage s runs 2*(S-1-s) + (v-1)*S warmup forwards, then 1F1B
    alternation, forwards/backwards drawn from chunks in round-robin
    blocks of S microbatches (backwards from the deepest chunk first).
    Otherwise a unit-time greedy simulation over the virtual-stage
    dependency DAG (F(vs, m) after F(vs-1, m); B(vs, m) after F(vs, m)
    and B(vs+1, m)) emits a valid — slightly bubblier — schedule;
    either way the result is deadlock-free (the closed form is
    validated by simulate_schedule, the greedy order is a projection
    of a global topological execution).
    """
    if n_stages < 1 or n_microbatches < 1 or v < 1:
        raise ValueError("need n_stages >= 1, n_microbatches >= 1, v >= 1")
    if v == 1:
        return [[(op, mb, 0) for op, mb in ops]
                for ops in schedule_1f1b(n_stages, n_microbatches)]
    if n_microbatches % n_stages == 0:
        return _interleaved_closed_form(n_stages, n_microbatches, v)
    return _interleaved_greedy(n_stages, n_microbatches, v)


def _interleaved_closed_form(S: int, M: int, v: int):
    """Megatron-style interleaved 1F1B for M % S == 0; bubble hits
    (S-1)/(v*M+S-1) under uniform op times."""
    total = v * M
    out = []
    for s in range(S):
        fseq, fptr = [], [0] * v
        for k in range(total):
            c = (k // S) % v
            fseq.append((OP_FWD, fptr[c], c))
            fptr[c] += 1
        bseq, bptr = [], [0] * v
        for k in range(total):
            c = v - 1 - (k // S) % v
            bseq.append((OP_BWD, bptr[c], c))
            bptr[c] += 1
        warmup = min(2 * (S - 1 - s) + (v - 1) * S, total)
        ops = list(fseq[:warmup])
        for i in range(total - warmup):
            ops.append(fseq[warmup + i])
            ops.append(bseq[i])
        ops.extend(bseq[max(total - warmup, 0):])
        out.append(ops)
    simulate_schedule(out)                 # assert deadlock-freedom
    return out


def _interleaved_greedy(S: int, M: int, v: int):
    """Greedy fallback for M % S != 0: backward-first unit-time
    simulation over the virtual-stage DAG; valid for any (S, M, v) but
    does not always reach the analytic bubble bound."""
    V = v * S
    next_f = [0] * V                     # per-virtual-stage microbatch FIFOs
    next_b = [0] * V
    f_done = [[-1] * M for _ in range(V)]   # finish tick, -1 = not yet
    b_done = [[-1] * M for _ in range(V)]
    out = [[] for _ in range(S)]
    remaining = 2 * V * M
    tick = 0
    while remaining:
        ran_this_tick = []
        for s in range(S):
            # Backward-first (1F1B steady state bounds live activations);
            # among ready ops prefer the one earliest in the interleaved
            # round-robin order: blocks of S microbatches per chunk,
            # deeper chunks drain first on the backward side.
            best = None
            for c in range(v):
                vs = c * S + s
                m = next_b[vs]
                if (m < M and 0 <= f_done[vs][m] < tick
                        and (vs == V - 1 or 0 <= b_done[vs + 1][m] < tick)):
                    key = (0, (m // S) * V + (V - 1 - vs))
                    if best is None or key < best[0]:
                        best = (key, OP_BWD, m, c, vs)
            if best is None:
                for c in range(v):
                    vs = c * S + s
                    m = next_f[vs]
                    if (m < M and
                            (vs == 0 or 0 <= f_done[vs - 1][m] < tick)):
                        key = (1, (m // S) * V + vs)
                        if best is None or key < best[0]:
                            best = (key, OP_FWD, m, c, vs)
            if best is not None:
                ran_this_tick.append(best)
        for _key, op, m, c, vs in ran_this_tick:
            if op == OP_FWD:
                next_f[vs] += 1
                f_done[vs][m] = tick
            else:
                next_b[vs] += 1
                b_done[vs][m] = tick
            out[vs % S].append((op, m, c))
            remaining -= 1
        if not ran_this_tick:          # unreachable for a DAG; guard anyway
            raise ValueError("interleaved schedule generator stalled at "
                             f"tick {tick} with {remaining} ops left")
        tick += 1
    return out


def make_schedule(kind: str, n_stages: int, n_microbatches: int,
                  virtual: int = 1):
    if virtual < 1:
        raise ValueError("virtual stage count must be >= 1")
    if kind == "1f1b":
        if virtual > 1:
            return schedule_interleaved_1f1b(
                n_stages, n_microbatches, virtual)
        return schedule_1f1b(n_stages, n_microbatches)
    if kind == "gpipe":
        if virtual > 1:
            raise ValueError(
                "interleaved virtual stages require the '1f1b' schedule")
        return schedule_gpipe(n_stages, n_microbatches)
    raise ValueError(f"unknown pipeline schedule {kind!r} "
                     "(expected '1f1b' or 'gpipe')")


def peak_live_activations(stage_ops, grad_buffers: bool = True) -> int:
    """Buffer high-water mark of one stage's op list, in microbatch-
    sized units: forwards outstanding (saved inputs awaiting their
    backward) plus — once a chunk's first backward has run — that
    chunk's grad-accumulation buffer, which stays live from first
    backward until the step-boundary apply. In 1F1B steady state a stage
    holds min(S-s, M) stashes AND its running grad sum, so the peak is
    min(S-s, M) + 1. Pass grad_buffers=False for the activation-only
    number."""
    live = peak = 0
    accumulating: set = set()
    for op in stage_ops:
        if op[0] == OP_FWD:
            live += 1
        else:
            live -= 1
            accumulating.add(op_chunk(op))
        held = live + (len(accumulating) if grad_buffers else 0)
        peak = max(peak, held)
    return peak


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int,
                             virtual: int = 1) -> float:
    """Analytic flush-bubble fraction: (S-1)/(M+S-1) for GPipe and
    plain 1F1B, shrinking to (S-1)/(v*M+S-1) under v-way interleaving
    (each stage's idle gaps are filled by the other chunks' work)."""
    return (n_stages - 1) / (virtual * n_microbatches + n_stages - 1)


def simulate_schedule(schedules):
    """Dependency-order simulation of per-stage op lists: repeatedly
    sweep the stages, running each stage's next op when its cross-stage
    input is available. Handles both plain (op, mb) and interleaved
    (op, mb, chunk) schedules — dependencies run in VIRTUAL stage order
    vs = chunk*S + s. Returns the global execution order as
    (sweep, stage, op, mb, chunk) tuples; raises if the schedule
    deadlocks (an op whose dependency can never arrive). The MPMD
    dispatcher uses the same sweep against live stage handles; recovery
    replay inherits its determinism from the same per-stage order."""
    S = len(schedules)
    V = S * _schedule_chunks(schedules)
    queues = [list(ops) for ops in schedules]
    fwd_done = [set() for _ in range(V)]   # mb whose F(vs, m) completed
    bwd_done = [set() for _ in range(V)]
    order = []
    tick = 0
    while any(queues):
        progressed = False
        for s in range(S):
            while queues[s]:
                op = queues[s][0]
                kind, mb, chunk = op[0], op[1], op_chunk(op)
                vs = chunk * S + s
                if kind == OP_FWD:
                    ready = vs == 0 or mb in fwd_done[vs - 1]
                else:
                    ready = (mb in fwd_done[vs]
                             and (vs == V - 1 or mb in bwd_done[vs + 1]))
                if not ready:
                    break
                queues[s].pop(0)
                (fwd_done if kind == OP_FWD else bwd_done)[vs].add(mb)
                order.append((tick, s, kind, mb, chunk))
                progressed = True
        if not progressed:
            raise ValueError(
                "pipeline schedule deadlocked; remaining per-stage ops: "
                f"{[q[:2] for q in queues]}")
        tick += 1
    return order


def simulate_timeline(schedules, op_time, transfer_time: float = 0.0):
    """Event-timeline model of a schedule's parallel execution: each
    stage executes its op list in order, an op starting at
    max(stage free, dependencies finished + transfer_time) and running
    for op_time(stage, op_kind, chunk) seconds. This is the physics the
    bubble bounds approximate; fed MEASURED per-op durations it models
    the parallel step time and per-stage idle fraction of stages that
    ran one after another.

    Returns {"span": makespan, "stage_busy": [...], "stage_idle_frac":
    [...], "bubble_fraction": mean idle frac} (idle measured against
    the full makespan, as the trainer's per-stage bubble_fraction is)."""
    S = len(schedules)
    order = simulate_schedule(schedules)   # also validates deadlock-freedom
    finish: dict = {}                      # (kind, mb, vs) -> finish time
    stage_free = [0.0] * S
    stage_busy = [0.0] * S
    for _tick, s, kind, mb, chunk in order:
        vs = chunk * S + s
        deps = []
        if kind == OP_FWD:
            if vs > 0:
                deps.append(finish[(OP_FWD, mb, vs - 1)] + transfer_time)
        else:
            deps.append(finish[(OP_FWD, mb, vs)])
            V = S * _schedule_chunks(schedules)
            if vs < V - 1:
                deps.append(finish[(OP_BWD, mb, vs + 1)] + transfer_time)
        start = max([stage_free[s]] + deps)
        dur = float(op_time(s, kind, chunk))
        finish[(kind, mb, vs)] = start + dur
        stage_free[s] = start + dur
        stage_busy[s] += dur
    span = max(stage_free) if S else 0.0
    idle = [1.0 - busy / span if span > 0 else 0.0 for busy in stage_busy]
    return {
        "span": span,
        "stage_busy": stage_busy,
        "stage_idle_frac": idle,
        "bubble_fraction": sum(idle) / S if S else 0.0,
    }
