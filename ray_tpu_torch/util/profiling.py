"""Per-step time/FLOP attribution: where does a train/decode step go?

Counterpart of ``ray_tpu/util/profiling.py``. ``StepProfiler`` combines
three marks per step with a FLOP/byte cost:

- **host gap**  — time between the previous step's end and this step's
  begin (logging, checkpointing, scheduler bookkeeping);
- **data wait** — begin → ``data_ready()`` (input pipeline);
- **compute**   — ``data_ready()`` → end (dispatch + device, the caller
  blocks on the step's output before ending).

and emits, per step (through the metrics registry, so the values land in
/metrics AND the GCS time-series plane):

  runtime_<name>_mfu             gauge   FLOPs / (wall * peak)
  runtime_<name>_mfu_compute     gauge   FLOPs / (compute * peak) — the
                                         hardware-bound ceiling
  runtime_<name>_phase_ms        gauge   tags: phase=compute|host_gap|
                                         data_wait
  runtime_<name>_roofline_bound  gauge   min(1, intensity / machine
                                         balance)
  runtime_<name>_tokens_per_s    gauge   when step(tokens=) given

plus (``emit_span=True``) a flight-recorder span ``<name>.step`` per step
carrying the same attribution.

Cost sources: ``wrap_step`` (the first call of each input shape is
counted by ``count_flops``, and the count reused for later calls of that
shape), ``set_cost`` (analytic formulas: the engine's decode step uses
``decode_step_flops``). PyTorch has no compiled program to ask for a cost
analysis; ``FlopCounterMode``'s formulas count the aten products (matrix
products, convolutions) but a dispatch mode neither sees a kernel
launched through ctypes nor knows a causal mask, so attention is counted
from its shapes where ``ops/attention.py`` dispatches, and the plain
version's products are hidden from the count: a step counts the same on
the CPU and on the card.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

# Peak dense-matmul FLOP/s per device by kind (bf16). The CPU entry is a
# NOMINAL figure — CPU MFU is a relative utilization signal for tests and
# dev boxes, not a hardware claim. RAY_TPU_TORCH_PEAK_FLOPS overrides
# everything.
_PEAK_FLOPS_BY_KIND = {
    "h100": 989.4e12,     # H100 SXM dense bf16 tensor-core peak
    "cpu": 1e11,
}
# memory bandwidth (bytes/s) per device for the roofline machine balance
_PEAK_BYTES_BY_KIND = {
    "h100": 3.35e12,      # H100 SXM HBM3
    "cpu": 5e10,
}


def _device_kind() -> str:
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name().lower()
    except Exception:
        pass
    return "cpu"


def _lookup(table: Dict[str, float], kind: str, default: float) -> float:
    for key, v in table.items():
        if key in kind:
            return v
    return default


def detect_peak_flops() -> float:
    env = os.environ.get("RAY_TPU_TORCH_PEAK_FLOPS")
    if env:
        return float(env)
    return _lookup(_PEAK_FLOPS_BY_KIND, _device_kind(), 1e11)


def detect_peak_bytes_per_s() -> float:
    env = os.environ.get("RAY_TPU_TORCH_PEAK_BYTES_PER_S")
    if env:
        return float(env)
    return _lookup(_PEAK_BYTES_BY_KIND, _device_kind(), 5e10)


def decode_step_flops(n_params: int, n_layers: int, n_heads: int,
                      head_dim: int, kv_lens) -> float:
    """Analytic per-decode-step FLOPs for a transformer slot batch:
    2 FLOPs/param/token for the dense path plus QK^T and AV against each
    slot's live KV length."""
    total = 0.0
    for kv in kv_lens:
        total += 2.0 * n_params \
            + 4.0 * n_layers * float(kv) * n_heads * head_dim
    return total


def decode_step_bytes(param_bytes: float, n_layers: int, n_kv_heads: int,
                      head_dim: int, kv_lens, elt_bytes: float) -> float:
    """Decode is memory-bound: every step re-reads the params plus each
    slot's K and V history."""
    kv_read = sum(2.0 * n_layers * float(kv) * n_kv_heads * head_dim
                  * elt_bytes for kv in kv_lens)
    return float(param_bytes) + kv_read


def shape_key(tree) -> tuple:
    """What a step's call is keyed by: every tensor's shape, dtype and
    device, and the structure around them (other values by type)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return ("T", tuple(tree.shape), tree.dtype, tree.device.type)
    if isinstance(tree, dict):
        return ("D",) + tuple((k, shape_key(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return ("L",) + tuple(shape_key(v) for v in tree)
    return ("V", type(tree).__name__)


def count_flops(fn: Callable, *args, **kwargs):
    """Run ``fn`` once under a dispatch mode that counts the aten products
    with ``FlopCounterMode``'s formulas (``flop_registry``), attention
    counted from its shapes (see the module docstring). Returns (its
    output, the FLOPs). ``FlopCounterMode`` itself is not used: its
    module tracker hooks every module's backward, which reorders the
    accumulation of gradients and so changes their bf16 bits."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    from ray_tpu_torch.ops import attention

    total = [0.0]

    class _Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None and not attention.plain_running():
                total[0] += formula(*args, **kwargs, out_val=out)
            return out

    def add(flops):
        total[0] += flops

    attention.add_flop_listener(add)
    try:
        with _Counter():
            out = fn(*args, **kwargs)
    finally:
        attention.remove_flop_listener(add)
    return out, float(total[0])


def _cuda_devices(tree, out: set) -> set:
    import torch
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class _StepScope:
    """Context manager for one profiled step — see StepProfiler.step()."""

    __slots__ = ("_prof", "_tokens", "_t0", "_t_data")

    def __init__(self, prof: "StepProfiler", tokens: Optional[int]):
        self._prof = prof
        self._tokens = tokens
        # a batch waited for before the step began (waiting_for_data)
        # belongs to this step's data phase
        waited, prof._data_t0 = prof._data_t0, None
        self._t0 = time.perf_counter() if waited is None else waited
        self._t_data: Optional[float] = None

    def data_ready(self):
        """Input pipeline done; compute starts now."""
        self._t_data = time.perf_counter()

    def block(self, out) -> None:
        """Wait for every CUDA device that holds one of ``out``'s tensors,
        so the compute phase includes device time, not just dispatch.
        Nothing to wait for on the CPU."""
        import torch
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        data_t = self._t_data or self._t0
        self._prof.observe(
            compute_s=end - data_t, data_s=data_t - self._t0,
            begin_t=self._t0, end_t=end, tokens=self._tokens,
            failed=exc_type is not None)
        return False


class StepProfiler:
    """Thread-compatible (one step in flight per profiler instance);
    creating one registers its gauges, which starts the metrics pusher
    lazily like any other metric."""

    def __init__(self, name: str = "train_step",
                 peak_flops: Optional[float] = None,
                 peak_bytes_per_s: Optional[float] = None,
                 emit_span: bool = True, emit_every: int = 1,
                 category: str = "profile"):
        from ray_tpu_torch.util.metrics import Gauge
        self.name = name
        self.category = category
        self.emit_span = emit_span
        self.emit_every = max(1, int(emit_every))
        self.peak_flops = peak_flops or detect_peak_flops()
        self.peak_bytes_per_s = peak_bytes_per_s or detect_peak_bytes_per_s()
        self.flops: float = 0.0
        self.bytes_accessed: float = 0.0
        self.steps = 0
        self.last: Dict[str, Any] = {}
        self._prev_end: Optional[float] = None
        self._data_t0: Optional[float] = None
        self._lock = threading.Lock()
        self._g_mfu = Gauge(f"runtime_{name}_mfu",
                            f"model FLOPs utilization of the {name} loop "
                            "(wall clock incl. host gap + data wait)")
        self._g_mfu_c = Gauge(f"runtime_{name}_mfu_compute",
                              f"{name} MFU over the compute phase only "
                              "(the hardware-bound ceiling)")
        self._g_phase = Gauge(f"runtime_{name}_phase_ms",
                              f"per-step {name} phase attribution (ms)",
                              tag_keys=("phase",))
        self._g_roof = Gauge(f"runtime_{name}_roofline_bound",
                             f"roofline MFU bound of the {name} program "
                             "(arithmetic intensity / machine balance)")
        self._g_tps = Gauge(f"runtime_{name}_tokens_per_s",
                            f"{name} tokens per wall second")

    # --------------------------------------------------------------- cost
    def set_cost(self, flops: float, bytes_accessed: float = 0.0):
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)
        return self

    def wrap_step(self, fn: Callable) -> Callable:
        """Wrap a step function so the first call of each input shape
        (``shape_key`` of its arguments) counts its FLOPs
        (``count_flops``) and later calls of that shape reuse the count;
        each call sets this profiler's cost before it runs."""
        cache: Dict[tuple, float] = {}

        def call(*args, **kwargs):
            key = shape_key((args, kwargs))
            flops = cache.get(key)
            if flops is not None:
                self.set_cost(flops)
                return fn(*args, **kwargs)
            out, flops = count_flops(fn, *args, **kwargs)
            cache[key] = flops
            self.set_cost(flops)
            return out

        return call

    # -------------------------------------------------------------- steps
    @contextlib.contextmanager
    def waiting_for_data(self):
        """Time a wait on the input pipeline that happens before the step
        function is called (``next()`` of ``iter_torch_batches``): the
        next ``step()`` then begins when this wait began, and reports the
        wait as its ``data_wait`` phase.

        ``with prof.waiting_for_data(): batch = next(batches)``"""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._data_t0 = t0

    def step(self, tokens: Optional[int] = None) -> _StepScope:
        """``with prof.step(tokens=B*L) as s: batch=...; s.data_ready();
        out = step_fn(batch); s.block(out)``"""
        return _StepScope(self, tokens)

    def observe(self, compute_s: float, data_s: float = 0.0,
                begin_t: Optional[float] = None,
                end_t: Optional[float] = None,
                tokens: Optional[int] = None,
                flops: Optional[float] = None,
                bytes_accessed: Optional[float] = None,
                failed: bool = False) -> Dict[str, Any]:
        """Low-level entry (the engine calls this directly with its own
        phase timings). Returns the attribution dict for this step."""
        now = time.perf_counter()
        end_t = now if end_t is None else end_t
        begin_t = (end_t - compute_s - data_s) if begin_t is None \
            else begin_t
        with self._lock:
            gap_s = max(0.0, begin_t - self._prev_end) \
                if self._prev_end is not None else 0.0
            self._prev_end = end_t
            self.steps += 1
            step_n = self.steps
        if flops is not None:
            self.flops = float(flops)
        if bytes_accessed is not None:
            self.bytes_accessed = float(bytes_accessed)
        compute_s = max(0.0, compute_s)
        data_s = max(0.0, data_s)
        wall_s = compute_s + data_s + gap_s
        rec: Dict[str, Any] = {
            "step": step_n,
            "compute_ms": round(compute_s * 1e3, 4),
            "data_wait_ms": round(data_s * 1e3, 4),
            "host_gap_ms": round(gap_s * 1e3, 4),
            "wall_ms": round(wall_s * 1e3, 4),
        }
        if self.flops > 0 and wall_s > 0:
            rec["mfu"] = round(self.flops / wall_s / self.peak_flops, 6)
            if compute_s > 0:
                rec["mfu_compute"] = round(
                    self.flops / compute_s / self.peak_flops, 6)
        if self.flops > 0 and self.bytes_accessed > 0:
            intensity = self.flops / self.bytes_accessed
            balance = self.peak_flops / self.peak_bytes_per_s
            rec["roofline_bound"] = round(min(1.0, intensity / balance), 6)
        if tokens is not None and wall_s > 0:
            rec["tokens_per_s"] = round(tokens / wall_s, 2)
        if failed:
            rec["failed"] = True
        self.last = rec
        if step_n % self.emit_every == 0:
            self._emit(rec, begin_t, end_t)
        return rec

    def _emit(self, rec: Dict[str, Any], begin_t: float, end_t: float):
        try:
            self._g_phase.set(rec["compute_ms"], tags={"phase": "compute"})
            self._g_phase.set(rec["data_wait_ms"],
                              tags={"phase": "data_wait"})
            self._g_phase.set(rec["host_gap_ms"],
                              tags={"phase": "host_gap"})
            if "mfu" in rec:
                self._g_mfu.set(rec["mfu"])
            if "mfu_compute" in rec:
                self._g_mfu_c.set(rec["mfu_compute"])
            if "roofline_bound" in rec:
                self._g_roof.set(rec["roofline_bound"])
            if "tokens_per_s" in rec:
                self._g_tps.set(rec["tokens_per_s"])
        except Exception:
            pass
        if self.emit_span:
            from ray_tpu_torch._private import events
            # wall-clock reconstruction: perf_counter deltas applied to
            # time.time() so the span lines up with the rest of the
            # timeline
            t_end = time.time() - (time.perf_counter() - end_t)
            t_begin = t_end - (end_t - begin_t)
            events.record_complete(
                f"{self.name}.step", t_begin, t_end,
                category=self.category,
                **{k: v for k, v in rec.items() if k != "step"})
