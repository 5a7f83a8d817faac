"""Continuous-batching inference engine: a fixed-shape KV slot pool and a
persistent decode loop.

Counterpart of ``ray_tpu/inference/engine.py`` (the core, on one device):

- The engine owns ``n_slots`` KV-cache slots, allocated once as
  ``[n_layers, n_slots, max_len, Hkv, D]`` tensors and updated IN PLACE by
  every step (the JAX engine donates the buffers to the same effect).
- Each iteration (a) admits queued prompts by *chunked prefill* under a
  per-step prefill-token budget: a prompt is split into fixed-size chunks
  that run through the cached-attention path (``chunked_prefill=True``)
  into a per-request scratch cache, which is copied into its slot when the
  prompt completes; and (b) advances every occupied slot one token in one
  batched decode step (per-slot ``idx`` tensor: each row attends and
  writes at its own length).
- Tokens stream out per request through ``RequestHandle`` queues; slots
  are freed on EOS, max-tokens, slot capacity, cancellation or deadline.

Sampling is shared with ``make_generate_fn`` (models/sampling.py).
Speculative decoding, the prefix cache, int8 KV, the export/import span
programs, a device mesh and step profiling are not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.inference.scheduler import (FINISH_LENGTH, PrefillChunk,
                                               Request, RequestHandle,
                                               Scheduler)
from ray_tpu_torch.models.sampling import sample_logits_dynamic

_NOT_PORTED = "is not ported yet (ROADMAP.md, Queue A item {})"


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
    kv_quant, prefix_cache_slots: only their off values are ported.
    The KV cache is kept in the model's dtype.
    """
    n_slots: int = 4
    max_len: int = 512
    prefill_chunk: int = 64
    prefill_budget: int = 64
    eos_id: int = -1
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    kv_quant: str = "none"
    prefix_cache_slots: int = 0


class InferenceEngine:
    """Continuous-batching engine over one model (its weights already
    loaded) on one device."""

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 device="cuda", seed: int = 0, mesh=None, spec=None):
        if spec is not None:
            raise NotImplementedError(
                "speculative decoding " + _NOT_PORTED.format("A2"))
        if mesh is not None:
            raise NotImplementedError(
                "a sharded engine (mesh) " + _NOT_PORTED.format("A3"))
        cfg = self.config = config or EngineConfig()
        if cfg.prefix_cache_slots > 0:
            raise NotImplementedError(
                "the prefix cache " + _NOT_PORTED.format("A2"))
        if cfg.kv_quant != "none":
            raise NotImplementedError(
                f"kv_quant={cfg.kv_quant!r} " + _NOT_PORTED.format("A2"))
        self.device = resolve_device(device)
        self.model = model
        mcfg = model.cfg
        if cfg.max_len > mcfg.max_seq_len:
            raise ValueError(f"max_len={cfg.max_len} exceeds the model's "
                             f"max_seq_len={mcfg.max_seq_len}")
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model weights are on {param.device}, the "
                             f"engine on {self.device}")
        self.sched = Scheduler(cfg.n_slots, cfg.prefill_budget,
                               default_temperature=cfg.temperature,
                               eos_id=cfg.eos_id,
                               chunk_size=cfg.prefill_chunk)
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        self._cache_dtype = mcfg.dtype
        pool_shape = (mcfg.n_layers, cfg.n_slots, cfg.max_len,
                      mcfg.n_kv_heads, mcfg.head_dim)
        # the pool is allocated once and written in place by every step
        self._pool_k = torch.zeros(pool_shape, dtype=self._cache_dtype,
                                   device=self.device)
        self._pool_v = torch.zeros_like(self._pool_k)
        # scratch is prefill_chunk longer than a slot so a padded final
        # chunk never clamps its write window back onto real entries
        self._scratch_shape = (mcfg.n_layers, 1,
                               cfg.max_len + cfg.prefill_chunk,
                               mcfg.n_kv_heads, mcfg.head_dim)

        # host-side slot state (fixed width, mirrors the device tensors)
        self._lengths = np.zeros((cfg.n_slots,), np.int64)
        self._last_tok = np.zeros((cfg.n_slots,), np.int64)
        self._temps = np.zeros((cfg.n_slots,), np.float32)
        self._scratch: Dict[int, tuple] = {}    # rid -> (sk, sv)

        self.steps = 0
        self.tokens_generated = 0

    # ------------------------------------------------------------ device fns
    @torch.inference_mode()
    def _prefill(self, sk, sv, tokens, pos0: int, n_real: int,
                 temp: float) -> int:
        """One budgeted chunk of prompt through the cached path (writes sk,
        sv in place); samples the would-be next token, which is used only
        after the last chunk, where it is the first generated token."""
        cfg = self.config
        cache = {"k": sk, "v": sv, "idx": pos0}
        logits, _ = self.model(tokens, cache=cache, chunked_prefill=True)
        tok = sample_logits_dynamic(logits[:, n_real - 1], self._gen,
                                    torch.tensor([temp]), cfg.top_k,
                                    cfg.top_p)
        return int(tok[0])

    @torch.inference_mode()
    def _insert(self, sk, sv, slot: int):
        # scratch carries prefill_chunk of padding tail; the slot takes the
        # first max_len entries
        self._pool_k[:, slot] = sk[:, 0, :self.config.max_len]
        self._pool_v[:, slot] = sv[:, 0, :self.config.max_len]

    @torch.inference_mode()
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
        tok = sample_logits_dynamic(logits[:, -1], self._gen,
                                    torch.from_numpy(self._temps),
                                    cfg.top_k, cfg.top_p)
        return tok.cpu().numpy()

    # -------------------------------------------------------------- intake
    def submit(self, tokens, max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> RequestHandle:
        """Queue one prompt; returns a streaming RequestHandle.
        deadline_s is relative (seconds from now): a request still queued
        past it fails with finish_reason='deadline'."""
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
                                  if deadline_s is not None else None))
        with self._work:
            if self._stop:
                raise RuntimeError("engine is stopped")
            h = self.sched.submit(req)
            self._work.notify_all()
        return h

    def export_kv_blocks(self, tokens, max_chunks: Optional[int] = None):
        raise NotImplementedError(
            "the KV export span program " + _NOT_PORTED.format("A2"))

    def import_kv_blocks(self, tokens, spans) -> int:
        raise NotImplementedError(
            "the KV import span program " + _NOT_PORTED.format("A2"))

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
    def step(self) -> bool:
        """One engine iteration: reap cancels/deadlines, run budgeted
        prefill chunks (admission), advance every occupied slot one token.
        Returns True if any device work ran."""
        with self._lock:
            now = time.monotonic()
            for st in self.sched.reap(now):
                self._scratch.pop(st.rid, None)
            did = False
            for ch in self.sched.plan_prefill():
                self._run_prefill_chunk(ch)
                did = True

            # capacity eviction BEFORE the step: a full slot has nowhere
            # to write its next token
            for st in self.sched.active_states():
                if self._lengths[st.slot] >= self.config.max_len:
                    self.sched.evict(st, FINISH_LENGTH)
            active = self.sched.active_states()
            if active:
                toks = self._decode()
                now = time.monotonic()
                for st in active:
                    slot = st.slot
                    self._lengths[slot] += 1
                    self._last_tok[slot] = toks[slot]
                    self.tokens_generated += 1
                    self.sched.decode_emit(st, int(toks[slot]), now)
                did = True
            self.steps += 1
            return did

    def _run_prefill_chunk(self, ch: PrefillChunk):
        cfg = self.config
        st = ch.state
        sk_sv = self._scratch.get(st.rid)
        if sk_sv is None:
            sk_sv = tuple(torch.zeros(self._scratch_shape,
                                      dtype=self._cache_dtype,
                                      device=self.device) for _ in range(2))
        sk, sv = sk_sv
        prompt = st.request.tokens
        chunk = np.zeros((1, cfg.prefill_chunk), np.int64)
        chunk[0, :ch.length] = prompt[ch.start:ch.start + ch.length]
        tok = self._prefill(sk, sv, torch.from_numpy(chunk).to(self.device),
                            ch.start, ch.length, st.temperature)
        if ch.is_last:
            slot = st.slot
            self._insert(sk, sv, slot)
            self._scratch.pop(st.rid, None)
            self._lengths[slot] = len(prompt)
            self._last_tok[slot] = tok
            self._temps[slot] = st.temperature
            self.sched.prefill_done(st, tok, time.monotonic())
        else:
            self._scratch[st.rid] = (sk, sv)
            self.sched.advance_prefill(st, ch.length)

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict:
        return {
            "n_slots": self.config.n_slots,
            "slots_occupied": self.sched.occupancy(),
            "slots_free": self.config.n_slots - self.sched.occupancy(),
            "queue_depth": self.sched.queue_depth(),
            "active": len(self.sched.active_slots()),
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
        }
