"""Continuous-batching inference engine: a fixed-shape KV slot pool and a
persistent decode loop.

Counterpart of ``ray_tpu/inference/engine.py``, on one device:

- The engine owns ``n_slots`` KV-cache slots, allocated once as
  ``[n_layers, n_slots, max_len, Hkv, D]`` tensors and updated IN PLACE by
  every step (the JAX engine donates the buffers to the same effect).
- Each iteration (a) admits queued prompts by *chunked prefill* under a
  per-step prefill-token budget: a prompt is split into fixed-size chunks
  that run through the cached-attention path (``chunked_prefill=True``)
  into a per-request scratch cache, which is copied into its slot when the
  prompt completes; and (b) advances every occupied slot one token in one
  batched decode step (per-slot ``idx`` tensor: each row attends and
  writes at its own length), or by 1..k+1 tokens with speculative
  decoding (``spec_decode.py``).
- Tokens stream out per request through ``RequestHandle`` queues; slots
  are freed on EOS, max-tokens, slot capacity, cancellation or deadline.
- With ``prefix_cache_slots > 0`` a radix trie (``prefix_cache.py``) over
  completed prefills addresses a block pool of ``prefix_cache_slots`` more
  rows of the slot shape, carved into ``prefill_chunk`` blocks: an
  admission that matches copies the blocks into its scratch instead of
  running prefill over them. ``kv_quant="int8"`` stores the block pool as
  int8 values + fp32 scale rows (``kv_quant.py``); the decode slot pool
  stays full precision. ``export_kv_blocks``/``import_kv_blocks`` move
  cached blocks between engines as host spans.

Sampling is shared with ``make_generate_fn`` (models/sampling.py).
``on_step`` (set by ``inference/api.py``'s ``LLMDeployment``) is called
with ``stats()`` after every step. With ``step_profile`` each decode step
is attributed by a ``StepProfiler("decode_step")`` (``util/profiling.py``)
from analytic FLOPs and bytes (``runtime_decode_step_*`` gauges). The
flight recorder gets the engine's spans, as in the JAX engine: an
``engine.slot`` span per request from admission to eviction (parented
under the submitter's trace context), ``engine.prefill`` per chunk,
``engine.decode`` per step with its attribution, and the
``engine.prefix_hit`` and ``engine.evict`` instants; eager PyTorch
compiles nothing, so there is no ``engine.compile`` instant.

With a ``mesh`` (a ``DeviceMesh`` from ``parallel.mesh.make_mesh``) the
engine is one rank of a sharded engine, as the JAX engine over a
multi-device mesh: the model's parameters are DTensors (whole tensors are
distributed in place per ``parallel.train_step.state_shardings``), the
target KV slot pools are laid out ``(None, "batch", None, "kv_heads",
None)`` under the sharding rules (a dim that does not divide is
replicated), the draft's pools likewise, pruned against the draft's
shape, and the prefix blocks, their int8 scale rows and the scratch
caches are replicated. The host arrays (lengths, last tokens,
temperatures) go in as plain tensors, which the mesh takes as replicated.
The cache writes and decode attention run on each rank's own shards
(``models/transformer.py``), logits are gathered whole before a token is
picked, and the sampling generator is seeded alike on every rank, so
every rank picks the same tokens. The ranks must run the same sequence
of collectives, so a sharded engine is driven in lockstep: its
background thread (``start``) is not started, and the caller steps it
(``step``) on every rank with the same requests
(``serve/sharded.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch._private import events
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.inference import kv_quant as kvq
from ray_tpu_torch.inference import spec_decode as spec_lib
from ray_tpu_torch.inference.prefix_cache import RadixPrefixCache
from ray_tpu_torch.inference.scheduler import (FINISH_LENGTH, PrefillChunk,
                                               Request, RequestHandle,
                                               Scheduler)
from ray_tpu_torch.models.sampling import sample_logits_dynamic
from ray_tpu_torch.parallel import sharding as sharding_lib
from ray_tpu_torch.parallel.train_step import (logical_pspec_to_mesh,
                                               state_shardings)


def _local(t):
    """(the part of ``t`` this rank holds, its offset in the whole
    tensor): a DTensor's local shard, or a plain tensor itself. Writes
    into the part land in ``t``."""
    if not isinstance(t, DTensor):
        return t, (0,) * t.dim()
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return t.to_local(), tuple(off)


def _on_device(fn):
    """Run an engine method under the engine lock and its device context
    (``InferenceEngine._device_ctx``), entered once per thread however
    deep the calls nest."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        if getattr(self._tls, "on_device", False):
            return fn(self, *args, **kwargs)
        with self._lock, self._device_ctx():
            self._tls.on_device = True
            try:
                return fn(self, *args, **kwargs)
            finally:
                self._tls.on_device = False
    return run


def _numpy_bfloat16():
    """numpy's bf16 dtype from ``ml_dtypes`` (which JAX installs), or None
    where it is not installed: numpy itself has none."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


@dataclasses.dataclass
class EngineConfig:
    """Knobs of the slot pool and admission policy.

    n_slots: decode batch width (slots advance together every step).
    max_len: per-slot KV capacity (prompt + generated tokens).
    prefill_chunk: size of one prefill call; prompts are split into
        chunks of exactly this many tokens (last chunk padded).
    prefill_budget: max prompt tokens admitted per engine step: higher
        lands prompts sooner (TTFT), lower keeps in-flight decodes moving.
    eos_id: default EOS (<0 disables); per-request override on Request.
    temperature/top_k/top_p: default sampling (temperature has a
        per-request override).
    cache_dtype: the KV slot pool's dtype (default: the model's).
    kv_quant: "int8" stores the prefix BLOCK pool as int8 values + fp32
        per-(position, head) scale rows (about itemsize*D/(D+4) more
        cached chunks per byte; the hand-off spans shrink alike). The
        decode slot pool stays full precision. The miss path publishes
        each completed chunk and reloads its dequantized values, so greedy
        output is bit-identical between a prefix-cache hit and the miss
        that populated it.
    prefix_cache_slots: extra cache-only rows of the slot shape, carved
        into prefill_chunk-aligned blocks that hold completed prefill
        spans (0 disables the prefix cache).
    step_profile: per-step time/FLOP attribution of the decode step
        (``util/profiling.py``): runtime_decode_step_mfu and the
        compute/host-gap/data-wait phase gauges.
    """
    n_slots: int = 4
    max_len: int = 512
    prefill_chunk: int = 64
    prefill_budget: int = 64
    eos_id: int = -1
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    cache_dtype: Any = None
    kv_quant: str = "none"
    prefix_cache_slots: int = 0
    step_profile: bool = True


class InferenceEngine:
    """Continuous-batching engine over one model (its weights already
    loaded) on one device, or one rank of a sharded engine over a
    ``mesh`` (module docstring)."""

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 device="cuda", seed: int = 0, mesh=None, spec=None,
                 rules=None):
        cfg = self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self.model = model
        self.mesh = mesh
        self._rules = rules
        mcfg = model.cfg
        self._kv_quant = kvq.check_mode(cfg.kv_quant) == "int8"
        # speculative decoding: both slot pools grow by k positions so the
        # fixed [len, len+k+1) verify write window never clamps back onto
        # live entries
        self._spec = spec_lib.resolve_spec(spec)
        self._spec_k = self._spec.k if self._spec is not None else 0
        self._pool_len = cfg.max_len + self._spec_k
        if self._pool_len > mcfg.max_seq_len:
            raise ValueError(
                f"max_len={cfg.max_len} (+ spec k={self._spec_k}) exceeds "
                f"the model's max_seq_len={mcfg.max_seq_len}")
        dtype = self._cache_dtype = cfg.cache_dtype or mcfg.dtype
        pool_shape = (mcfg.n_layers, cfg.n_slots, self._pool_len,
                      mcfg.n_kv_heads, mcfg.head_dim)
        # the target pools' mesh spec, decided first: a mesh that is not
        # one fails here as the JAX engine's does (AttributeError)
        self._pool_spec = self._kv_spec(pool_shape)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model weights are on {param.device}, the "
                             f"engine on {self.device}")
        self._shard_weights(model)
        self._draft_model = None
        if self._spec is not None:
            self._draft_model = spec_lib.resolve_draft(self._spec, mcfg,
                                                       self.device)
            if self._pool_len > self._draft_model.cfg.max_seq_len:
                raise ValueError(
                    f"draft max_seq_len={self._draft_model.cfg.max_seq_len}"
                    f" < max_len + k = {self._pool_len}")
            self._shard_weights(self._draft_model)
        self.prefix_cache = None
        if cfg.prefix_cache_slots > 0:
            self._blocks_per_slot = cfg.max_len // cfg.prefill_chunk
            self.prefix_cache = RadixPrefixCache(
                cfg.prefill_chunk,
                cfg.prefix_cache_slots * self._blocks_per_slot)
        self.sched = Scheduler(cfg.n_slots, cfg.prefill_budget,
                               default_temperature=cfg.temperature,
                               eos_id=cfg.eos_id,
                               chunk_size=cfg.prefill_chunk,
                               prefix_cache=self.prefix_cache)
        self._lock = threading.RLock()
        self._tls = threading.local()
        self._work = threading.Condition(self._lock)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # the pools are allocated once and written in place by every step
        self._pool_k = self._zeros(pool_shape, dtype, self._pool_spec)
        self._pool_v = self._zeros(pool_shape, dtype, self._pool_spec)
        # scratch is prefill_chunk longer than a slot so a padded final
        # chunk never clamps its write window back onto real entries
        self._scratch_len = cfg.max_len + cfg.prefill_chunk
        self._scratch_shape = (mcfg.n_layers, 1, self._scratch_len,
                               mcfg.n_kv_heads, mcfg.head_dim)
        self._dpool_k = self._dpool_v = None
        self._draft_pool_spec = None
        if self._spec is not None:
            # the draft's pools: the target pools' layout, pruned against
            # the draft's shape (its KV heads may not divide the tensor
            # axis)
            dcfg = self._draft_model.cfg
            dshape = (dcfg.n_layers, cfg.n_slots, self._pool_len,
                      dcfg.n_kv_heads, dcfg.head_dim)
            self._draft_pool_spec = self._kv_spec(dshape)
            self._dpool_k = self._zeros(dshape, dtype, self._draft_pool_spec)
            self._dpool_v = self._zeros(dshape, dtype, self._draft_pool_spec)
            self._draft_scratch_shape = (dcfg.n_layers, 1, self._scratch_len,
                                         dcfg.n_kv_heads, dcfg.head_dim)
            self._spec_step = spec_lib.build_spec_step(
                model, self._draft_model, self._spec.k, cfg.top_k,
                cfg.top_p)
        self._blocks_k = self._blocks_v = None
        self._blocks_ks = self._blocks_vs = None
        if self.prefix_cache is not None:
            # block storage: prefix_cache_slots more rows of the per-slot
            # shape; int8 stores values + fp32 per-(position, head) scales
            block_shape = (mcfg.n_layers, cfg.prefix_cache_slots,
                           cfg.max_len, mcfg.n_kv_heads, mcfg.head_dim)
            bdtype = torch.int8 if self._kv_quant else dtype
            self._blocks_k = self._zeros(block_shape, bdtype)
            self._blocks_v = self._zeros(block_shape, bdtype)
            if self._kv_quant:
                self._blocks_ks = self._zeros(block_shape[:-1],
                                              torch.float32)
                self._blocks_vs = self._zeros(block_shape[:-1],
                                              torch.float32)

        # host-side slot state (fixed width, mirrors the device tensors)
        self._lengths = np.zeros((cfg.n_slots,), np.int64)
        self._last_tok = np.zeros((cfg.n_slots,), np.int64)
        self._temps = np.zeros((cfg.n_slots,), np.float32)
        self._scratch: Dict[int, tuple] = {}          # rid -> (sk, sv)
        self._draft_scratch: Dict[int, tuple] = {}    # rid -> (dk, dv)

        # spec decode accounting (greedy rows only: sampled rows always
        # force accept = 0 and would just dilute the rate)
        self.spec_tokens_proposed = 0
        self.spec_tokens_accepted = 0
        self.steps = 0
        self.tokens_generated = 0
        # hand-off accounting
        self.kv_exports = 0
        self.kv_imports = 0
        self.remote_prefix_tokens = 0
        # called with stats() after every step (LLMDeployment's gauges)
        self.on_step: Optional[Callable[[Dict], None]] = None
        # flight-recorder root for engine-owned work that belongs to no
        # single request (multi-request decode batches)
        self._trace_id = events.new_trace_id()
        # step attribution: decode FLOPs and bytes are analytic
        self.profiler = None
        if cfg.step_profile:
            from ray_tpu_torch.util import profiling
            params = list(model.parameters())
            self._n_params = int(sum(p.numel() for p in params))
            self._param_bytes = float(sum(p.numel() * p.element_size()
                                          for p in params))
            self._kv_elt_bytes = float(
                torch.empty((), dtype=dtype).element_size())
            self.profiler = profiling.StepProfiler(
                "decode_step", emit_span=False)

    def _kv_spec(self, shape):
        """The mesh spec of a KV pool of ``shape``: slots over the batch
        axes, KV heads over ``tensor``, each pruned where it does not
        divide (the JAX engine's pool sharding); None without a mesh."""
        if self.mesh is None:
            return None
        rules = self._rules or sharding_lib.DEFAULT_RULES
        return sharding_lib._prune_indivisible(
            logical_pspec_to_mesh((None, "batch", None, "kv_heads", None),
                                  rules), shape, self.mesh)

    def _shard_weights(self, model):
        """Under a mesh, distribute a model whose weights are whole
        tensors, the same on every rank, in place per ``state_shardings``
        (each rank keeps its shards, no communication). Weights that are
        DTensors already stay as the caller placed them."""
        if self.mesh is None or isinstance(next(model.parameters()),
                                           DTensor):
            return
        sharding_lib.load_whole(
            model, {n: p.detach() for n, p in model.named_parameters()},
            self.mesh, state_shardings(model, self.mesh, self._rules))

    def _zeros(self, shape, dtype, spec=None):
        """A zero tensor; under a mesh a DTensor laid out as ``spec`` says
        (replicated when None), each rank allocating only its shard."""
        if self.mesh is None:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset

        place = sharding_lib.spec_to_placements(spec or (), self.mesh)
        local_shape, _ = compute_local_shape_and_global_offset(
            shape, self.mesh, place)
        local = torch.zeros(local_shape, dtype=dtype, device=self.device)
        return DTensor.from_local(local, self.mesh, place, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    def _device_ctx(self):
        """Inference mode on one device. Under a mesh no_grad instead (an
        inference-mode detach of a DTensor parameter fails: see
        ``parallel.sharding.constrain``), with the mesh current and plain
        tensors taken as replicated where they meet a DTensor."""
        if self.mesh is None:
            return torch.inference_mode()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        stack.enter_context(sharding_lib.on_mesh(self.mesh))
        return stack

    # ------------------------------------------------------------ device fns
    @_on_device
    def _prefill(self, model, sk, sv, tokens, pos0: int):
        """One budgeted chunk of prompt through the cached path (writes sk,
        sv in place). Returns the chunk's logits."""
        cache = {"k": sk, "v": sv, "idx": pos0}
        logits, _ = model(tokens, cache=cache, chunked_prefill=True)
        return logits

    @_on_device
    def _sample_first(self, logits, n_real: int, temp: float) -> int:
        """The would-be next token after a chunk; used only after the last
        chunk, where it is the first generated token."""
        cfg = self.config
        tok = sample_logits_dynamic(
            sharding_lib.gather_whole(logits[:, n_real - 1]), self._gen,
            torch.tensor([temp]), cfg.top_k, cfg.top_p)
        return int(tok[0])

    @_on_device
    def _insert(self, pool_k, pool_v, sk, sv, slot: int):
        # scratch carries prefill_chunk of padding tail; the slot takes the
        # first max_len entries (a spec pool's k extra positions are
        # written by the verify window before they are read). Under a mesh
        # each rank writes its own shard of the pool (if it holds the
        # slot) from the replicated scratch.
        n = self.config.max_len
        for pool, scratch in ((pool_k, sk), (pool_v, sv)):
            local, (_, s0, _, h0, _) = _local(pool)
            row = slot - s0
            if 0 <= row < local.shape[1]:
                src = _local(scratch)[0]
                local[:, row, :n] = src[:, 0, :n, h0:h0 + local.shape[3]]

    @_on_device
    def _decode(self) -> np.ndarray:
        """One token for every slot (free slots too: their writes land at
        their clamped length and are never read). Writes the pool in
        place."""
        cfg = self.config
        dev = self.device
        cache = {"k": self._pool_k, "v": self._pool_v,
                 "idx": torch.from_numpy(self._lengths).to(dev)}
        toks = torch.from_numpy(self._last_tok).to(dev)
        logits, _ = self.model(toks[:, None], cache=cache)
        tok = sample_logits_dynamic(
            sharding_lib.gather_whole(logits[:, -1]), self._gen,
            torch.from_numpy(self._temps), cfg.top_k, cfg.top_p)
        return tok.cpu().numpy()

    @_on_device
    def _spec_decode(self):
        """The fused draft+verify step; (out [S, k+1], accept [S]) brought
        to the host before anything branches on them."""
        dev = self.device
        out, acc = self._spec_step(
            self._pool_k, self._pool_v, self._dpool_k, self._dpool_v,
            torch.from_numpy(self._lengths).to(dev),
            torch.from_numpy(self._last_tok).to(dev), self._gen,
            torch.from_numpy(self._temps).to(dev))
        return out.cpu().numpy(), acc.cpu().numpy()

    # -------------------------------------------------------------- intake
    def submit(self, tokens, max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               hold: bool = False) -> RequestHandle:
        """Queue one prompt; returns a streaming RequestHandle.
        deadline_s is relative (seconds from now): a request still queued
        past it fails with finish_reason='deadline'. hold=True parks the
        request in the queue (FIFO position kept) until release_hold(),
        the window in which its prefix's KV arrives from another engine
        (``import_kv_blocks``)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if len(tokens) == 0:
            raise ValueError("empty prompt")
        if len(tokens) > self.config.max_len - 1:
            raise ValueError(
                f"prompt ({len(tokens)} tokens) must leave room to "
                f"decode in a {self.config.max_len}-token slot")
        req = Request(tokens=tokens, max_new_tokens=int(max_new_tokens),
                      temperature=temperature, eos_id=eos_id,
                      deadline_s=(time.monotonic() + deadline_s
                                  if deadline_s is not None else None),
                      trace_ctx=events.current_context())
        with self._work:
            if self._stop:
                raise RuntimeError("engine is stopped")
            h = self.sched.submit(req, hold=hold)
            self._work.notify_all()
        return h

    def release_hold(self, handle: RequestHandle):
        """End a hold-submitted request's hand-off window: it becomes
        admissible on the next step (its imported prefix, if the hand-off
        landed, now matches via the radix trie like a locally cached
        one). Safe to call on any failure path."""
        with self._work:
            self.sched.release_hold(handle.rid)
            self._work.notify_all()

    def begin_drain(self):
        """Preemption drain: refuse new submissions (submit raises), finish
        everything in flight. The loop keeps stepping until the last slot
        evicts."""
        with self._work:
            self.sched.begin_drain()
            self._work.notify_all()

    # --------------------------------------------------------------- loop
    def start(self) -> "InferenceEngine":
        with self._lock:
            if self._thread is None:
                self._stop = False
                self._thread = threading.Thread(
                    target=self._loop, name="inference-engine", daemon=True)
                self._thread.start()
        return self

    def stop(self):
        with self._work:
            self._stop = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        with self._lock:
            self.sched.fail_all(RuntimeError("engine stopped"))

    def _loop(self):
        while True:
            with self._work:
                if self._stop:
                    return
                if not self.sched.has_work():
                    # deadline sweeps still need an occasional wake
                    self._work.wait(timeout=0.05)
                    if self._stop:
                        return
            try:
                self.step()
            except Exception as e:           # engine must not die silently
                with self._lock:
                    self.sched.fail_all(e)

    # --------------------------------------------------------------- step
    @_on_device
    def step(self) -> bool:
        """One engine iteration: reap cancels/deadlines, run budgeted
        prefill chunks (admission), advance every occupied slot. Returns
        True if any device work ran."""
        with self._lock:
            t_iter0 = time.perf_counter()
            now = time.monotonic()
            for st in self.sched.reap(now):
                self._scratch.pop(st.rid, None)
                self._draft_scratch.pop(st.rid, None)
            did = False
            for ch in self.sched.plan_prefill():
                self._run_prefill_chunk(ch, now)
                did = True
            t_admit = time.perf_counter()

            # capacity eviction BEFORE the step: a full slot has nowhere
            # to write its next token
            for st in self.sched.active_states():
                if self._lengths[st.slot] >= self.config.max_len:
                    self.sched.evict(st, FINISH_LENGTH)
            active = self.sched.active_states()
            if active:
                dspan = self._decode_span(active)
                t_dec0 = time.perf_counter()
                if self._spec is not None:
                    out, acc = self._spec_decode()
                else:
                    toks = self._decode()
                t_dec1 = time.perf_counter()
                # capture before the emit: an evicted state's slot is None
                # by the time the profiler reads it
                slots = [st.slot for st in active]
                n0 = self.tokens_generated
                if self._spec is not None:
                    self._emit_spec(active, out, acc)
                else:
                    now = time.monotonic()
                    for st in active:
                        slot = st.slot
                        self._lengths[slot] += 1
                        self._last_tok[slot] = toks[slot]
                        self.tokens_generated += 1
                        self.sched.decode_emit(st, int(toks[slot]), now)
                attribution = {}
                if self.profiler is not None:
                    attribution = self._profile_decode(
                        [int(self._lengths[s]) for s in slots],
                        t_iter0, t_admit, t_dec0, t_dec1)
                dspan.end(tokens=self.tokens_generated - n0, **attribution)
                did = True
            self.steps += 1
            if self.on_step is not None:
                try:
                    self.on_step(self.stats())
                except Exception:
                    pass
            return did

    def _decode_span(self, active):
        """The step's engine.decode span. Decode is a BATCH phase: when one
        request occupies the engine the span adopts that request's trace;
        with several co-resident traces it records under the engine's own
        root trace with slot attribution instead of picking a favorite."""
        traces = {st.span.trace_id for st in active if st.span is not None}
        if len(active) == 1 and active[0].span is not None:
            d_trace = active[0].span.trace_id
            d_parent = active[0].span.span_id
        elif len(traces) == 1:
            d_trace, d_parent = next(iter(traces)), None
        else:
            d_trace, d_parent = self._trace_id, None
        return events.start_span(
            "engine.decode", category="engine", trace_id=d_trace,
            parent_span_id=d_parent, step=self.steps,
            slots_active=len(active),
            slots_occupied=self.sched.occupancy(),
            queue_depth=self.sched.queue_depth())

    def _profile_decode(self, kv_lens, t_iter0, t_admit, t_dec0, t_dec1):
        """Per-step attribution: decode compute vs prefill/admission work
        ("data wait": tokens can't advance while it runs) vs host gap
        (scheduler bookkeeping + idle between steps). Returns the attrs
        attached to the engine.decode span."""
        from ray_tpu_torch.util import profiling
        mcfg = self.model.cfg
        flops = profiling.decode_step_flops(
            self._n_params, mcfg.n_layers, mcfg.n_heads, mcfg.head_dim,
            kv_lens)
        nbytes = profiling.decode_step_bytes(
            self._param_bytes, mcfg.n_layers, mcfg.n_kv_heads,
            mcfg.head_dim, kv_lens, self._kv_elt_bytes)
        rec = self.profiler.observe(
            compute_s=t_dec1 - t_dec0, data_s=t_admit - t_iter0,
            begin_t=t_iter0, end_t=t_dec1, tokens=len(kv_lens),
            flops=flops, bytes_accessed=nbytes)
        return {k: rec[k] for k in ("mfu", "mfu_compute", "compute_ms",
                                    "host_gap_ms", "data_wait_ms",
                                    "roofline_bound") if k in rec}

    def _emit_spec(self, active, out, acc):
        """Accepted prefix + one bonus token per slot, branching on the
        accept counts as host values."""
        now = time.monotonic()
        for st in active:
            slot = st.slot
            accepted = int(acc[slot])
            if self._temps[slot] <= 0.0:
                self.spec_tokens_proposed += self._spec_k
                self.spec_tokens_accepted += accepted
            for j in range(accepted + 1):
                self._lengths[slot] += 1
                tok = int(out[slot, j])
                self._last_tok[slot] = tok
                self.tokens_generated += 1
                self.sched.decode_emit(st, tok, now)
                if st.slot is None:
                    break    # finished (EOS / max tokens)

    def _run_prefill_chunk(self, ch: PrefillChunk, now: float):
        cfg = self.config
        st = ch.state
        if st.span is None:
            # first chunk == admission: open the engine-slot span, parented
            # under the submitting request's propagated context (Serve
            # path) or rooting its own trace (direct engine use)
            ctx = st.request.trace_ctx
            st.span = events.start_span(
                "engine.slot", category="engine",
                trace_id=ctx[0] if ctx else None,
                parent_span_id=ctx[1] if ctx else None,
                rid=st.rid, slot=st.slot,
                prompt_tokens=len(st.request.tokens),
                queue_wait_ms=round(
                    (now - st.handle.submitted_t) * 1e3, 3))
        sk_sv = self._scratch.get(st.rid)
        if sk_sv is None:
            sk_sv = (self._zeros(self._scratch_shape, self._cache_dtype),
                     self._zeros(self._scratch_shape, self._cache_dtype))
            if st.prefix_nodes:
                # radix hit: the matched span's KV comes out of the block
                # pool as copies; no forward runs over [0, prefix_matched)
                self._restore_prefix(st, *sk_sv)
        sk, sv = sk_sv
        dk_dv = None
        if self._spec is not None:
            dk_dv = self._draft_scratch.get(st.rid)
            if dk_dv is None:
                dk_dv = tuple(self._zeros(self._draft_scratch_shape,
                                          self._cache_dtype)
                              for _ in range(2))
                if st.prefix_matched:
                    # the block pool holds TARGET KV only; the (cheap)
                    # draft re-prefills the matched range so its cache
                    # stays aligned with the target's
                    self._draft_replay(st, *dk_dv)
        prompt = st.request.tokens
        chunk = np.zeros((1, cfg.prefill_chunk), np.int64)
        chunk[0, :ch.length] = prompt[ch.start:ch.start + ch.length]
        chunk = torch.from_numpy(chunk).to(self.device)
        pspan = events.start_span(
            "engine.prefill", category="engine",
            trace_id=st.span.trace_id, parent_span_id=st.span.span_id,
            rid=st.rid, slot=st.slot, offset=ch.start, length=ch.length,
            is_last=ch.is_last, slots_occupied=self.sched.occupancy())
        logits = self._prefill(self.model, sk, sv, chunk, ch.start)
        tok = self._sample_first(logits, ch.length, st.temperature)
        pspan.end()
        if self._spec is not None:
            self._prefill(self._draft_model, *dk_dv, chunk, ch.start)
        if ch.is_last:
            slot = st.slot
            if self.prefix_cache is not None:
                self._populate_prefix(st, sk, sv)
            self._insert(self._pool_k, self._pool_v, sk, sv, slot)
            if self._spec is not None:
                self._insert(self._dpool_k, self._dpool_v, *dk_dv, slot)
            self._scratch.pop(st.rid, None)
            self._draft_scratch.pop(st.rid, None)
            self._lengths[slot] = len(prompt)
            self._last_tok[slot] = tok
            self._temps[slot] = st.temperature
            self.sched.prefill_done(st, tok, time.monotonic())
        else:
            if self._kv_quant and self.prefix_cache is not None:
                self._publish_chunk_quant(st, sk, sv, ch)
            self._scratch[st.rid] = (sk, sv)
            if self._spec is not None:
                self._draft_scratch[st.rid] = dk_dv
            self.sched.advance_prefill(st, ch.length)

    # ------------------------------------------------------- prefix cache
    def _block_at(self, block: int):
        """(block-pool row, token offset) of a trie block id."""
        bslot, boff = divmod(block, self._blocks_per_slot)
        return bslot, boff * self.config.prefill_chunk

    @_on_device
    def _load_span(self, sk, sv, bslot: int, src: int, dst: int):
        """Cached block -> scratch[dst:dst+C] (dequantized under int8): the
        suffix prefill then attends over it as if the chunk had just been
        computed. Blocks, scales and scratch are replicated under a mesh,
        so each rank copies its own whole copy."""
        C = self.config.prefill_chunk
        for scratch, blocks, scales in ((sk, self._blocks_k, self._blocks_ks),
                                        (sv, self._blocks_v, self._blocks_vs)):
            scratch, blocks = _local(scratch)[0], _local(blocks)[0]
            scales = None if scales is None else _local(scales)[0]
            span = blocks[:, bslot, src:src + C]
            if scales is not None:
                span = kvq.dequantize_kv(span, scales[:, bslot, src:src + C],
                                         self._cache_dtype)
            scratch[:, 0, dst:dst + C] = span

    @_on_device
    def _save_block(self, sk, sv, bslot: int, dst: int, src: int):
        """One chunk scratch[src:src+C] -> block pool (row bslot, offset
        dst), quantizing when int8 is on (replicated under a mesh, as in
        ``_load_span``)."""
        C = self.config.prefill_chunk
        for scratch, blocks, scales in ((sk, self._blocks_k, self._blocks_ks),
                                        (sv, self._blocks_v, self._blocks_vs)):
            scratch, blocks = _local(scratch)[0], _local(blocks)[0]
            scales = None if scales is None else _local(scales)[0]
            span = scratch[:, 0, src:src + C]
            if scales is not None:
                span, scale = kvq.quantize_kv(span)
                scales[:, bslot, dst:dst + C] = scale
            blocks[:, bslot, dst:dst + C] = span

    def _restore_prefix(self, st, sk, sv):
        """Copy the matched trie blocks into this request's scratch cache
        ([0, prefix_matched) chunk by chunk), then unpin them. Runs once,
        on the request's first prefill chunk, under the engine lock:
        eviction cannot race the copies."""
        C = self.config.prefill_chunk
        for i, node in enumerate(st.prefix_nodes):
            bslot, boff = self._block_at(node.block)
            self._load_span(sk, sv, bslot, boff, i * C)
        events.record_instant(
            "engine.prefix_hit", category="engine",
            trace_id=st.span.trace_id if st.span else None,
            parent_span_id=st.span.span_id if st.span else None,
            rid=st.rid, slot=st.slot, matched_tokens=st.prefix_matched,
            prompt_tokens=len(st.request.tokens))
        self.sched.unpin_prefix(st)

    def _populate_prefix(self, st, sk, sv):
        """Miss path, at prefill completion: extend the trie over every full
        chunk of the prompt and fill the newly allocated blocks from scratch
        (already-present chunks are skipped: their KV is identical by
        construction)."""
        for off, block in self.prefix_cache.insert(st.request.tokens):
            bslot, boff = self._block_at(block)
            self._save_block(sk, sv, bslot, boff, off)

    def _publish_chunk_quant(self, st, sk, sv, ch):
        """int8 miss path, non-final chunks: publish each COMPLETED full
        chunk into the quantized block pool as it finishes, then reload the
        dequantized values into this request's OWN scratch, so the miss
        attends exactly the numbers a later hit will restore (greedy output
        bit-identical hit vs miss). The final chunk is save-only in
        _populate_prefix: the admission match is capped one token short of
        the prompt, so no hit ever restores it and both paths attend it
        raw."""
        end = ch.start + ch.length
        for off, block in self.prefix_cache.insert(st.request.tokens[:end]):
            bslot, boff = self._block_at(block)
            self._save_block(sk, sv, bslot, boff, off)
            self._load_span(sk, sv, bslot, boff, off)

    def _draft_replay(self, st, dk, dv):
        """Prefix-hit draft warmup: re-prefill the matched range through the
        draft model (prefix_matched is a multiple of prefill_chunk)."""
        C = self.config.prefill_chunk
        prompt = st.request.tokens
        for off in range(0, st.prefix_matched, C):
            chunk = torch.from_numpy(
                prompt[off:off + C].astype(np.int64)[None]).to(self.device)
            self._prefill(self._draft_model, dk, dv, chunk, off)

    # ------------------------------------------------------ KV hand-off
    @_on_device
    def export_kv_blocks(self, tokens, max_chunks: Optional[int] = None):
        """Sender half of the prefill/decode hand-off: copy the cached KV
        blocks covering ``tokens``' chunk-aligned prefix out of the block
        pool as host arrays. Returns ``(covered_tokens, spans)`` where
        ``spans`` is ``[(k, v), ...]`` of span shape ``[n_layers, 1,
        prefill_chunk, Hkv, D]`` (numpy in the pool's dtype: for a bf16
        pool ``ml_dtypes.bfloat16``, 2 bytes per element as the JAX
        engine ships them, or fp32 where ``ml_dtypes`` does not import,
        which is exact), or under int8 ``[(qk, qv, ks,
        vs), ...]`` (int8 values, fp32 scales without the D axis). Defaults
        to the admission cap (one token short of the prompt) so the
        importing engine's match covers exactly what its scheduler would
        use. Blocks stay pinned for the duration of the copy."""
        if self.prefix_cache is None:
            return 0, []
        C = self.config.prefill_chunk
        cap = (max(0, len(tokens) - 1) // C if max_chunks is None
               else max(0, int(max_chunks)))

        def host(x):
            x = x[:, None].cpu()
            if x.dtype != torch.bfloat16:
                return x.numpy()
            bf16 = _numpy_bfloat16()
            if bf16 is None:
                return x.float().numpy()
            # the bits as they are: a 2-byte array, as the JAX engine's
            return x.view(torch.int16).numpy().view(bf16)
        with self._lock:
            nodes = self.prefix_cache.walk(tokens, cap)
            spans = []
            try:
                for node in nodes:
                    bslot, boff = self._block_at(node.block)
                    arrays = (self._blocks_k, self._blocks_v)
                    if self._kv_quant:
                        arrays += (self._blocks_ks, self._blocks_vs)
                    arrays = [_local(a)[0] for a in arrays]
                    spans.append(tuple(host(a[:, bslot, boff:boff + C])
                                       for a in arrays))
            finally:
                self.prefix_cache.release(nodes)
            if spans:
                self.kv_exports += 1
        return len(spans) * C, spans

    @_on_device
    def import_kv_blocks(self, tokens, spans) -> int:
        """Receiver half: land remotely prefilled spans in this engine's
        block pool and extend the trie over them, so the NEXT admission of
        ``tokens`` (or any prompt sharing the prefix) hits through the
        ordinary restore path: no forward runs over the imported range,
        and greedy output equals a local prefill's (the blocks are the
        same computation, done elsewhere). A span in the other format than
        the pool's is quantized or dequantized on the host with the same
        fp32 math. Chunks already cached locally are skipped; returns the
        number of prompt tokens newly covered."""
        if self.prefix_cache is None or not spans:
            return 0
        C = self.config.prefill_chunk
        n = min(len(spans), len(tokens) // C)
        if n <= 0:
            return 0

        def dev(x, dtype):
            if str(x.dtype) == "bfloat16":
                # a 2-byte bf16 array (ml_dtypes): its bits as they are
                t = torch.from_numpy(np.array(x).view(np.int16)).view(
                    torch.bfloat16)
            else:
                if x.dtype.kind == "V":
                    x = np.asarray(x, np.float32)
                t = torch.from_numpy(np.array(x))
            return t.to(self.device).to(dtype)[:, 0]
        with self._lock:
            created = self.prefix_cache.insert(
                [int(t) for t in tokens[:n * C]])
            for off, block in created:
                span = spans[off // C]
                bslot, boff = self._block_at(block)
                if self._kv_quant:
                    if len(span) == 4:
                        qk, qv, ks, vs = span
                    else:
                        qk, ks = kvq.quantize_kv_np(span[0])
                        qv, vs = kvq.quantize_kv_np(span[1])
                    pairs = ((self._blocks_k, qk, torch.int8),
                             (self._blocks_v, qv, torch.int8),
                             (self._blocks_ks, ks, torch.float32),
                             (self._blocks_vs, vs, torch.float32))
                else:
                    if len(span) == 4:
                        ck = kvq.dequantize_kv_np(span[0], span[2])
                        cv = kvq.dequantize_kv_np(span[1], span[3])
                    else:
                        ck, cv = span
                    pairs = ((self._blocks_k, ck, self._cache_dtype),
                             (self._blocks_v, cv, self._cache_dtype))
                for blocks, x, dtype in pairs:
                    _local(blocks)[0][:, bslot, boff:boff + C] = dev(x, dtype)
            imported = len(created) * C
            if imported:
                self.kv_imports += 1
                self.remote_prefix_tokens += imported
        return imported

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict:
        out = {
            "n_slots": self.config.n_slots,
            "slots_occupied": self.sched.occupancy(),
            "slots_free": self.config.n_slots - self.sched.occupancy(),
            "queue_depth": self.sched.queue_depth(),
            "active": len(self.sched.active_slots()),
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "draining": self.sched.draining,
        }
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.stats())
            out["kv_exports"] = self.kv_exports
            out["kv_imports"] = self.kv_imports
            out["remote_prefix_tokens"] = self.remote_prefix_tokens
        if self._spec is not None:
            prop = self.spec_tokens_proposed
            out["spec_k"] = self._spec_k
            out["spec_tokens_proposed"] = prop
            out["spec_tokens_accepted"] = self.spec_tokens_accepted
            out["spec_accept_rate"] = (
                round(self.spec_tokens_accepted / prop, 4) if prop else 0.0)
        if self._kv_quant:
            mcfg = self.model.cfg
            itemsize = torch.empty((), dtype=self._cache_dtype).element_size()
            out["kv_quant"] = "int8"
            out["kv_quant_slot_gain"] = round(
                kvq.slot_gain(mcfg.head_dim, itemsize), 3)
            out["kv_quant_slot_gain_vs_fp16"] = round(
                kvq.slot_gain(mcfg.head_dim, 2), 3)
        return out
