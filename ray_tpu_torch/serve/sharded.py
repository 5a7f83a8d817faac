"""Sharded-replica serving: one LLM replica IS a mesh gang (the JAX
package's serve/sharded.py, on ``torch.distributed`` and the DTensor
mesh).

Shape: :class:`ShardedEngineReplica` is the user callable every rank of
a ``num_hosts > 1`` deployment constructs (serve/sharded_replica.py
gang-places the ranks, PACK, and joins them into one
``torch.distributed`` world through the GCS KV). Each rank builds the
SAME model from the same weights over the same mesh, so the
continuous-batching engine's steps (prefill chunk / insert / decode or
the fused spec-decode step) run the same collectives on every rank:

- rank 0 owns admission and streaming — routers hold only the rank-0
  facade; a streamed request fans out so every rank's generator drives
  the same engine step sequence (ReplicaShard.handle_stream);
- the engine runs in LOCKSTEP mode: no background decode thread — the
  request generator itself steps the engine, so the order of collectives
  is a pure function of the request stream and every rank stays
  synchronized (a per-rank free-running loop would let ranks enter
  collectives in different orders and deadlock the gang);
- after each completed stream the ranks compare a digest of the tokens
  they produced (``last_stream_digest``): sampled tokens must agree
  bit-for-bit across ranks — a divergence means the SPMD invariant
  broke (a non-deterministic kernel, rank-local generator drift) and the
  gang wedges itself for replacement rather than serving split-brain
  output;
- preemption and rank death drain/replace the WHOLE gang: any rank's
  notice flips rank-0 admission off, in-flight streams finish, and the
  controller tears down every member + the placement group together.
  Severed streams re-route with ``resume_tokens`` — exactly-once token
  delivery, greedy-identical continuation.

Rank and world come from ``torch.distributed`` (the JAX package reads
``jax.process_index``/``process_count``). With ``num_hosts=1`` the
replica is an ordinary one, and the replica starts a world of one itself
(``default_serving_mesh``). ``spec_decode=`` and ``kv_quant="int8"``
thread through to the engine.

Chaos: :class:`~ray_tpu_torch.util.chaos.GangRankKiller` arms
``RAY_TPU_TORCH_TESTING_RPC_FAILURE="gang_rank=p"``; a NON-ZERO rank
checks the injection hook at each engine step and SIGKILLs its own
process when it fires.
"""

from __future__ import annotations

import hashlib
import os
import signal
from typing import Dict, Optional


def default_serving_mesh(device_type: str = "cuda"):
    """The sharded-serving mesh over every rank of the default process
    group: KV heads on ``tensor`` (2-way when the world is even), the rest
    on ``fsdp`` for weight sharding. Where no process group runs, a world
    of one is started first (NCCL on the card, gloo on the CPU)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshConfig, init_world, make_mesh
    if not dist.is_initialized():
        init_world(device=device_type)
    n = dist.get_world_size()
    tensor = 2 if n % 2 == 0 else 1
    return make_mesh(MeshConfig(data=1, fsdp=n // tensor, seq=1,
                                tensor=tensor), device_type)


class ShardedEngineReplica:
    """One rank of a mesh-gang LLM replica (see module docstring).

    Construct via ``serve.deployment(..., num_hosts=N)`` /
    :func:`build_sharded_app` — the gang machinery instantiates this on
    every rank. Single-process use works identically: the gang is then
    one rank.

    Engine knobs mirror :class:`LLMDeployment`; ``spec_decode`` /
    ``kv_quant`` thread through to the engine. ``mesh=None`` builds
    :func:`default_serving_mesh` over the world. ``device`` defaults to
    the card.
    """

    __serve_resumable__ = True
    __serve_coalesce_stream__ = True

    def __init__(self, model="llama-debug", *, n_slots: int = 4,
                 max_len: int = 256, prefill_chunk: int = 32,
                 prefill_budget: int = 64, eos_id: int = -1,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, params_fn=None, mesh=None,
                 seed: int = 0, prefix_cache_slots: int = 2,
                 spec_decode=None, kv_quant: str = "none",
                 stream_coalesce_tokens: int = 8,
                 stream_coalesce_ms: float = 20.0, device="cuda"):
        import torch.distributed as dist

        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.inference.api import _resolve_model
        from ray_tpu_torch.inference.engine import (EngineConfig,
                                                    InferenceEngine)
        dev = resolve_device(device)
        self.model = _resolve_model(model)
        self.mesh = mesh if mesh is not None else default_serving_mesh(
            dev.type)
        self._rank = dist.get_rank()
        self._world = dist.get_world_size()
        self.stream_coalesce_tokens = max(1, int(stream_coalesce_tokens))
        self.stream_coalesce_ms = max(0.0, float(stream_coalesce_ms))
        self._build_params(params_fn, seed, dev)
        cfg = EngineConfig(
            n_slots=n_slots, max_len=max_len, prefill_chunk=prefill_chunk,
            prefill_budget=prefill_budget, eos_id=eos_id,
            temperature=temperature, top_k=top_k, top_p=top_p,
            kv_quant=kv_quant,
            prefix_cache_slots=max(0, int(prefix_cache_slots)))
        # LOCKSTEP: the engine thread is never started — request
        # generators drive step() so every rank runs the same sequence of
        # collectives (module docstring)
        self.engine = InferenceEngine(self.model, cfg, device=dev,
                                      seed=seed, mesh=self.mesh,
                                      spec=spec_decode)
        self._stream_seq = 0
        self._last_digest: Optional[tuple] = None
        self._requests_served = 0

    def _build_params(self, params_fn, seed: int, device):
        """Load the weights whole on every rank: ``params_fn``'s state
        dict, which must agree across the mesh (a checkpoint, a seeded
        init), or the same seeded init on every rank's own device. The
        engine then distributes them over the mesh (each rank keeps its
        shards)."""
        import torch

        from ray_tpu_torch.inference.api import _load_params
        if params_fn is not None:
            params = params_fn()
        else:
            from ray_tpu_torch.models import init_params
            params = init_params(
                self.model.cfg,
                torch.Generator(device=device).manual_seed(seed), device)
        _load_params(self.model, params, device)

    # ------------------------------------------------------------ serving
    def __call__(self, prompt_tokens, max_new_tokens: int = 64,
                 temperature: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 resume_tokens=None,
                 stream_coalesce_tokens: Optional[int] = None,
                 stream_coalesce_ms: Optional[float] = None):
        """Streaming generator, coalesced-chunk protocol (lists of token
        ids; the first token is always its own eager chunk). EVERY rank
        runs this generator for every request — rank 0's chunks reach
        the client, peer ranks drain theirs (ReplicaShard streaming
        fan-out) — so the engine-stepping below is the gang's lockstep
        clock. One stream is admitted at a time (the rank-0 SPMD lock),
        which keeps the step sequence identical across ranks.

        prompt_tokens may also be a dict of these arguments, as the HTTP
        proxy forwards a JSON body (``LLMDeployment.__call__``)."""
        if isinstance(prompt_tokens, dict):
            yield from self.__call__(**prompt_tokens)
            return
        coalesce_n = (self.stream_coalesce_tokens
                      if stream_coalesce_tokens is None
                      else max(1, int(stream_coalesce_tokens)))
        if resume_tokens:
            # severed-stream re-route (exactly-once): the delivered
            # prefix rides the prompt through chunked prefill on the
            # replacement gang and only the continuation streams
            resume_tokens = [int(t) for t in resume_tokens]
            prompt_tokens = list(prompt_tokens) + resume_tokens
            max_new_tokens = int(max_new_tokens) - len(resume_tokens)
            if max_new_tokens <= 0:
                return
        handle = self.engine.submit(prompt_tokens,
                                    max_new_tokens=max_new_tokens,
                                    temperature=temperature, eos_id=eos_id,
                                    deadline_s=deadline_s)
        digest = hashlib.blake2b(digest_size=16)
        first = True
        pending: list = []
        try:
            for tok in self._lockstep_tokens(handle):
                digest.update(int(tok).to_bytes(4, "little", signed=True))
                pending.append(tok)
                if first:
                    yield [pending.pop(0)]
                    first = False
                elif len(pending) >= coalesce_n:
                    yield pending
                    pending = []
            if pending:
                yield pending
        except GeneratorExit:
            # client walked away mid-stream: the gang must stay in
            # lockstep, so this rank still runs the request's device
            # work to completion (peers drain theirs fully) — cancel
            # would desynchronize the collective sequence
            for tok in self._lockstep_tokens(handle):
                digest.update(int(tok).to_bytes(4, "little", signed=True))
            raise
        finally:
            handle.cancel()    # no-op on a finished request
            self._stream_seq += 1
            self._last_digest = (self._stream_seq, digest.hexdigest())
            self._requests_served += 1

    def _lockstep_tokens(self, handle):
        """Drive engine.step() and yield this request's tokens as they
        emit. The chaos hook runs per step on non-zero ranks —
        GangRankKiller's SIGKILL lands mid-decode, exactly the
        rank-death the whole-gang recovery path must absorb."""
        import queue as _queue
        while True:
            self._maybe_chaos_kill()
            self.engine.step()
            while True:
                try:
                    yield handle.next(timeout=0)
                except _queue.Empty:
                    break
                except StopIteration:
                    return

    def _maybe_chaos_kill(self):
        if self._rank == 0:
            return
        from ray_tpu_torch._private import rpc
        try:
            rpc._maybe_inject_failure("gang_rank")
        except Exception:
            os.kill(os.getpid(), signal.SIGKILL)

    def generate(self, prompt_tokens, **kw):
        """Non-streaming convenience: full token list."""
        return [t for chunk in self.__call__(prompt_tokens, **kw)
                for t in chunk]

    # ------------------------------------------------------------ control
    def last_stream_digest(self) -> Optional[tuple]:
        """(stream_seq, blake2b hex) of the tokens this rank produced
        for its most recent completed stream. ReplicaShard compares
        rank 0's against every peer's after each completed stream —
        mismatch wedges the gang (digest agreement on sampled
        tokens)."""
        return self._last_digest

    def stats(self) -> Dict:
        st = self.engine.stats()
        st["gang_rank"] = self._rank
        st["gang_world"] = self._world
        st["n_devices"] = self.mesh.size()
        st["requests_served"] = self._requests_served
        return st

    def begin_drain(self):
        """Preemption notice: rank 0 owns admission, so flipping the
        engine here drains the WHOLE gang — peers only ever see fanned
        requests, which stop arriving."""
        self.engine.begin_drain()

    def drain_status(self) -> Dict:
        st = self.engine.stats()
        return {"draining": st["draining"],
                "pending": st["slots_occupied"] + st["queue_depth"]}

    def check_health(self):
        # lockstep engine has no background thread to probe; draining
        # with nothing pending means this gang is retiring (controller
        # treats the gang as one unit either way)
        return True

    def on_shell_attach(self):
        """Gang-aware pre-warm (fleet shell attach): every rank runs
        this concurrently after construction, so the tiny generate
        below is itself a lockstep sequence of collectives on every rank
        before the gang is published."""
        try:
            for _ in self.__call__([1], max_new_tokens=1):
                pass
        except Exception:
            import logging
            logging.getLogger(__name__).warning(
                "sharded shell-attach warmup failed; the first request "
                "warms up", exc_info=True)

    def reconfigure(self, user_config):
        if isinstance(user_config, dict) and "prefill_budget" in user_config:
            self.engine.sched.prefill_budget = max(
                1, int(user_config["prefill_budget"]))


def build_sharded_app(model="llama-debug", *, num_hosts: int = 1,
                      topology: Optional[str] = None,
                      name: str = "sharded-llm",
                      deployment_kwargs: Optional[Dict] = None,
                      **engine_kwargs):
    """One-call deployment graph for a sharded serving app:
    ``serve.run(build_sharded_app("llama-debug", num_hosts=2,
    spec_decode={...}, kv_quant="int8"))``. ``topology`` (a slice gang)
    is refused when the gang is built (ROADMAP.md, Queue A item A3c-2)."""
    from ray_tpu_torch import serve
    return serve.deployment(
        ShardedEngineReplica, name=name, num_hosts=num_hosts,
        topology=topology,
        **(deployment_kwargs or {})).bind(model, **engine_kwargs)
