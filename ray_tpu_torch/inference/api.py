"""`LLMDeployment`: the continuous-batching engine behind a Serve
deployment, streaming tokens over the existing replica/handle streaming
path (replica.handle_stream -> ObjectRefGenerator).

Usage::

    from ray_tpu_torch import serve
    from ray_tpu_torch.inference import LLMDeployment

    app = serve.deployment(
        LLMDeployment, ray_actor_options={"num_gpus": 1}).bind(
            "llama-debug", n_slots=4)
    serve.run(app, name="llm")
    h = serve.get_app_handle("llm").options(stream=True)
    for tok in h.remote([1, 2, 3], max_new_tokens=32):
        ...

Each streamed request holds one engine slot; a client that drops the
iterator mid-generation cancels the request in a ``finally`` — the slot
is reclaimed by the next engine step and the queue metrics decrement
(see tests/test_serve_streaming.py). Composes with Serve multiplexing
(the deployment is an ordinary callable; sticky model-id routing works
unchanged). ``mesh=`` (a ``parallel.mesh.make_mesh`` DeviceMesh) makes
the engine a sharded one (``inference/engine.py``): the weights are
loaded whole and distributed over the mesh; a replica spanning several
processes is ``serve/sharded.py``'s ``ShardedEngineReplica``, which
steps its engine in lockstep.

The engine runs on ``device`` (default ``"cuda"``: inside a replica the
first card of the worker's ``CUDA_VISIBLE_DEVICES`` mask, so ask
``ray_actor_options={"num_gpus": ...}``). ``params_fn`` returns a state
dict (``models.convert.init_params``, ``params_from_jax``); without it the
weights are ``init_params`` from ``seed`` on an explicit
``torch.Generator``, which differ from the JAX package's init of the same
seed (as the samplers do): parity with the JAX package is held through
``params_fn``.

Metrics (ray_tpu_torch/util/metrics.py, aggregated at /metrics):
  serve_llm_ttft_ms        histogram  time to first token per request
  serve_llm_tpot_ms        histogram  per-token latency after the first
  serve_llm_requests_total counter    finished requests, by finish_reason
  serve_llm_tokens_total   counter    generated tokens
  serve_llm_slot_occupancy gauge      occupied slots (per engine step)
  serve_llm_queue_depth    gauge      queued (unadmitted) requests
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.inference.engine import EngineConfig, InferenceEngine


def _resolve_model(model):
    """Accept a registry name, a TransformerConfig, or a TransformerLM
    module. Returns a TransformerLM (a new one on the meta device) whose
    weights ``_load_params`` then assigns."""
    from ray_tpu_torch.models import MODEL_REGISTRY, TransformerLM
    from ray_tpu_torch.models.transformer import TransformerConfig
    if isinstance(model, str):
        return TransformerLM(MODEL_REGISTRY[model], device="meta")
    if isinstance(model, TransformerConfig):
        return TransformerLM(model, device="meta")
    return model


def _load_params(model, params, device):
    """Load a state dict onto ``device``, keeping each tensor's dtype (as
    ``make_generate_fn``'s init does). Host tensors read from the object
    store are views of the arena; ``.to(device)`` is their one copy."""
    model.load_state_dict(
        {name: torch.as_tensor(t).to(device) for name, t in params.items()},
        assign=True)
    return model


class LLMDeployment:
    """Serve callable hosting one InferenceEngine.

    model: registry name / TransformerConfig / TransformerLM.
    params_fn: optional zero-arg callable returning the param tree
        (checkpoint restore, sharded init, ...); defaults to random
        init with `seed` — the CI/bench shape.
    mesh: optional DeviceMesh the engine shards its weights and KV pools
        over (``InferenceEngine(mesh=)``).
    Engine knobs (n_slots, max_len, prefill_chunk, prefill_budget,
    eos_id, temperature, top_k, top_p) mirror EngineConfig.

    Streaming resume (``__serve_resumable__``): a stream severed by
    replica death is resubmitted by the handle layer with
    ``resume_tokens=<tokens already delivered>``; the generated-so-far
    suffix rides the prompt through the chunked-prefill path on the
    survivor and generation continues from the exact next position —
    zero dropped, zero duplicated tokens for greedy decoding (sampled
    decoding resumes from the same position but re-draws randomness).
    """

    # handle.py resubmits severed streams with resume_tokens= instead of
    # restarting them from scratch (serve/handle.py stream re-route)
    __serve_resumable__ = True
    # streams yield COALESCED chunks (lists of token ids) instead of one
    # token per frame: the handle layer unpacks them back to per-token
    # iteration while the wire carries ~stream_coalesce_tokens per
    # round-trip (serve/handle.py DeploymentResponseGenerator)
    __serve_coalesce_stream__ = True

    def __init__(self, model="llama-debug", *, n_slots: int = 4,
                 max_len: int = 256, prefill_chunk: int = 32,
                 prefill_budget: int = 64, eos_id: int = -1,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, params_fn=None, mesh=None,
                 seed: int = 0, prefix_cache_slots: int = 2,
                 stream_coalesce_tokens: int = 8,
                 stream_coalesce_ms: float = 20.0,
                 weights_key: Optional[str] = "auto",
                 spec_decode=None, kv_quant: str = "none",
                 device="cuda"):
        dev = resolve_device(device)
        self.model = _resolve_model(model)
        # coalescing knobs: how many decoded tokens ride one streaming
        # frame (handle->router->replica->proxy round-trip) and how long
        # a partial batch may wait before flushing. The FIRST token of
        # every request is always flushed eagerly — TTFT never pays the
        # coalesce window.
        self.stream_coalesce_tokens = max(1, int(stream_coalesce_tokens))
        self.stream_coalesce_ms = max(0.0, float(stream_coalesce_ms))
        if params_fn is not None:
            # weight-plane attach (serve/weights.py): the first replica
            # to run params_fn publishes the tree via broadcast_weights
            # (plain-put fallback) and records the ref; later attaches —
            # fleet shell revivals included — get a zero-copy local
            # arena read instead of re-running the loader. weights_key
            # "auto" derives a key from (model, seed) for registry-name
            # models; pass an explicit key for config/module models or
            # None to always re-run params_fn.
            if weights_key == "auto":
                weights_key = (f"llm/{model}/{seed}"
                               if isinstance(model, str) else None)
            from ray_tpu_torch.serve.weights import resolve_weight_source
            params = resolve_weight_source(weights_key, params_fn)
        else:
            from ray_tpu_torch.models import init_params
            params = init_params(
                self.model.cfg,
                torch.Generator(device=dev).manual_seed(seed), dev)
        _load_params(self.model, params, dev)
        del params
        cfg = EngineConfig(n_slots=n_slots, max_len=max_len,
                           prefill_chunk=prefill_chunk,
                           prefill_budget=prefill_budget, eos_id=eos_id,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, kv_quant=kv_quant,
                           prefix_cache_slots=max(0, int(prefix_cache_slots)))
        # spec_decode: None | SpecDecodeConfig | kwargs dict — draft-model
        # speculative decoding (inference/spec_decode.py); greedy output
        # is bit-identical to non-speculative serving, only throughput
        # moves. kv_quant="int8" halves+ the prefix-block HBM footprint.
        self.engine = InferenceEngine(self.model, cfg, device=dev,
                                      seed=seed, mesh=mesh, spec=spec_decode)
        self._metrics = _EngineMetrics()
        self.engine.on_step = self._metrics.on_step
        self.engine.start()

    # ------------------------------------------------------------- serving
    def __call__(self, prompt_tokens, max_new_tokens: int = 64,
                 temperature: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 resume_tokens=None,
                 stream_coalesce_tokens: Optional[int] = None,
                 stream_coalesce_ms: Optional[float] = None):
        """Streaming generator: yields COALESCED chunks — lists of token
        ids, up to ``stream_coalesce_tokens`` long, flushed at least
        every ``stream_coalesce_ms`` — so one handle/replica/proxy
        round-trip carries a batch instead of a single token. The first
        token of the stream is always its own eager chunk (TTFT is
        unaffected). Invoked with .options(stream=True) this rides the
        replica streaming path and the handle layer unpacks chunks back
        to per-token iteration (``__serve_coalesce_stream__``); the
        finally-cancel frees the slot when the client drops the iterator
        mid-generation (GeneratorExit lands here).

        resume_tokens: tokens a previous attempt already delivered —
        they re-prefill as part of the prompt (the chunked-prefill path
        makes this one budgeted admission, not a decode replay) and only
        the continuation is yielded.

        prompt_tokens may also be a dict of these arguments: the HTTP
        proxy forwards a JSON body as the one argument, so
        ``{"prompt_tokens": [...], "max_new_tokens": 32}`` sets both."""
        if isinstance(prompt_tokens, dict):
            yield from self.__call__(**prompt_tokens)
            return
        from ray_tpu_torch._private import events
        coalesce_n = (self.stream_coalesce_tokens
                      if stream_coalesce_tokens is None
                      else max(1, int(stream_coalesce_tokens)))
        flush_s = (self.stream_coalesce_ms
                   if stream_coalesce_ms is None
                   else max(0.0, float(stream_coalesce_ms))) / 1e3
        if resume_tokens:
            resume_tokens = [int(t) for t in resume_tokens]
            prompt_tokens = list(prompt_tokens) + resume_tokens
            max_new_tokens = int(max_new_tokens) - len(resume_tokens)
            if max_new_tokens <= 0:
                return   # the dead replica already delivered everything
        # the request span chains under the replica task's propagated
        # trace context (the generator body runs inside handle_stream's
        # execution, which re-establishes it per resumption), and the
        # engine parents this request's slot span under it via the
        # trace_context around submit()
        req_span = events.start_span(
            "engine.request", category="serve",
            prompt_tokens=len(prompt_tokens),
            max_new_tokens=int(max_new_tokens))
        handle = self._submit_request(prompt_tokens, max_new_tokens,
                                      temperature, eos_id, deadline_s,
                                      req_span)
        prev_t: Optional[float] = None
        n_tokens = 0
        try:
            while True:
                try:
                    if prev_t is None:
                        # eager first chunk: exactly one token, flushed
                        # the moment the engine emits it
                        batch = [handle.next()]
                    else:
                        batch = handle.next_many(coalesce_n, flush_s)
                except StopIteration:
                    break
                now = time.monotonic()
                if prev_t is None:
                    ttft = now - handle.submitted_t
                    self._metrics.first_token(ttft)
                    events.record_instant(
                        "engine.first_token", category="serve",
                        trace_id=req_span.trace_id,
                        parent_span_id=req_span.span_id,
                        ttft_ms=round(ttft * 1e3, 3))
                else:
                    # inter-token latency inside a coalesced chunk is
                    # the per-token share of the batch gap
                    self._metrics.next_token(
                        (now - prev_t) / len(batch), n=len(batch))
                prev_t = now
                n_tokens += len(batch)
                self._metrics.flushed()
                yield batch
        finally:
            # client walked away OR stream completed; cancel is a no-op
            # on a finished request
            handle.cancel()
            reason = handle.finish_reason or "cancelled"
            self._metrics.finished(reason)
            self._metrics.prefix(self.engine.prefix_cache)
            req_span.end(finish_reason=reason, tokens=n_tokens)

    def _submit_request(self, prompt_tokens, max_new_tokens, temperature,
                        eos_id, deadline_s, req_span):
        """Admission hook: submit one request to the engine under the
        request span's trace context. The disaggregated decode tier
        (serve/disagg.py) overrides this to run the KV hand-off —
        hold-submit, import remotely prefilled blocks, release — before
        admission plans any prefill."""
        from ray_tpu_torch._private import events
        with events.trace_context(req_span.trace_id, req_span.span_id):
            return self.engine.submit(prompt_tokens,
                                      max_new_tokens=max_new_tokens,
                                      temperature=temperature,
                                      eos_id=eos_id,
                                      deadline_s=deadline_s)

    def generate(self, prompt_tokens, **kw):
        """Non-streaming convenience: returns the full token list
        (coalesced chunks flattened)."""
        return [t for chunk in self.__call__(prompt_tokens, **kw)
                for t in chunk]

    # ------------------------------------------------------------- control
    def stats(self) -> Dict:
        return self.engine.stats()

    def begin_drain(self):
        """Preemption notice (serve/replica.py relays it here): the
        engine refuses new submissions — the handle layer re-routes
        them — while queued and in-flight requests run to completion."""
        self.engine.begin_drain()

    def on_shell_attach(self):
        """Fleet cold-start hook (serve/fleet.py ReplicaShell.attach):
        runs INSIDE a pre-warmed shell after construction, BEFORE the
        replica is published to routing tables. One tiny greedy
        generate runs every path of a step once here (the device's lazy
        initialisation, the allocator's first blocks), so the requests
        held through the cold start never pay it. Best-effort: a warmup
        failure still lets the replica serve."""
        try:
            for _ in self.__call__([1], max_new_tokens=1):
                pass
        except Exception:
            import logging
            logging.getLogger(__name__).warning(
                "shell-attach warmup failed; the first request warms up",
                exc_info=True)

    def drain_status(self) -> Dict:
        st = self.engine.stats()
        return {"draining": st["draining"],
                "pending": st["slots_occupied"] + st["queue_depth"]}

    def check_health(self):
        if self.engine._thread is not None \
                and not self.engine._thread.is_alive():
            raise RuntimeError("inference engine loop died")

    def reconfigure(self, user_config):
        # prefill budget is the one knob safe to move live (it is read
        # per step); everything else fixes the pools' shapes
        if isinstance(user_config, dict) and "prefill_budget" in user_config:
            self.engine.sched.prefill_budget = max(
                1, int(user_config["prefill_budget"]))

    def __del__(self):
        try:
            self.engine.stop()
        except Exception:
            pass


class _EngineMetrics:
    """TTFT/TPOT/occupancy/queue-depth wiring (util/metrics.py)."""

    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram
        ms = [1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
              2500.0, 5000.0]
        self.ttft = Histogram("serve_llm_ttft_ms",
                              "time to first token (ms)", boundaries=ms)
        self.tpot = Histogram("serve_llm_tpot_ms",
                              "inter-token latency (ms)", boundaries=ms)
        self.requests = Counter("serve_llm_requests_total",
                                "finished requests",
                                tag_keys=("finish_reason",))
        self.tokens = Counter("serve_llm_tokens_total", "generated tokens")
        self.occupancy = Gauge("serve_llm_slot_occupancy",
                               "occupied KV slots")
        self.queue_depth = Gauge("serve_llm_queue_depth",
                                 "queued (unadmitted) requests")
        self.hit_rate = Gauge("prefix_hit_rate",
                              "radix-cache hit rate over request lookups")
        self.tokens_saved = Gauge("prefix_tokens_saved",
                                  "prompt tokens whose prefill the "
                                  "radix cache skipped (cumulative)")
        self.flush_rate = Gauge("stream_flushes_per_s",
                                "coalesced stream chunks flushed per "
                                "second (1s sliding window)")
        self.flushes = Counter("serve_llm_stream_flushes_total",
                               "coalesced stream chunks flushed")
        self._lock = threading.Lock()
        self._flush_window: list = []      # monotonic stamps, last ~1s

    def on_step(self, stats: Dict):
        self.occupancy.set(stats["slots_occupied"])
        self.queue_depth.set(stats["queue_depth"])

    def first_token(self, dt_s: float):
        self.ttft.observe(dt_s * 1000.0)
        self.tokens.inc()

    def next_token(self, dt_s: float, n: int = 1):
        self.tpot.observe(dt_s * 1000.0)
        self.tokens.inc(n)

    def flushed(self):
        self.flushes.inc()
        now = time.monotonic()
        with self._lock:
            self._flush_window.append(now)
            cut = now - 1.0
            while self._flush_window and self._flush_window[0] < cut:
                self._flush_window.pop(0)
            self.flush_rate.set(float(len(self._flush_window)))

    def prefix(self, cache):
        if cache is not None:
            self.hit_rate.set(cache.hit_rate)
            self.tokens_saved.set(float(cache.tokens_saved))

    def finished(self, reason: str):
        self.requests.inc(tags={"finish_reason": reason})
