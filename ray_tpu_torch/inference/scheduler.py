"""Request scheduling for the continuous-batching engine.

The port's own copy of ``ray_tpu/inference/scheduler.py`` (host-only).

The scheduler owns everything about a request EXCEPT the tensors: the
FIFO admission queue, the per-step prefill-token budget (prefill must
never stall in-flight decodes, so each engine iteration spends at most
``prefill_budget`` prompt tokens), cancellation, and per-request
deadlines. The engine (engine.py) asks it three questions per step —
what to evict, what to prefill, what is active — and reports back what
happened; all device-side state (KV pool, scratch caches) stays in the
engine.

Thread model: the engine serializes all scheduler calls under its own
lock; request handles (the streaming consumer side) only touch their
thread-safe token queue and the `cancelled` flag.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import time
from typing import Any, Dict, List, Optional

FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_CANCELLED = "cancelled"
FINISH_DEADLINE = "deadline"

_SENTINEL = object()


@dataclasses.dataclass
class Request:
    """One generation request. `tokens` is the prompt (1-D int32);
    per-request sampling knobs default to the engine's config."""
    tokens: Any
    max_new_tokens: int = 64
    temperature: Optional[float] = None
    eos_id: Optional[int] = None
    # absolute monotonic deadline for STARTING (admission); a queued
    # request past it fails with FINISH_DEADLINE instead of occupying a
    # slot it can no longer use
    deadline_s: Optional[float] = None
    # (trace_id, span_id) captured at submit: the flight recorder
    # parents this request's engine-slot span under the submitting
    # task/request span, so a Serve call renders proxy -> replica ->
    # engine-slot as one trace
    trace_ctx: Optional[Any] = None


class RequestHandle:
    """Streaming consumer side of a submitted request: iterate to
    receive token ids as the engine emits them; ``cancel()`` frees the
    slot (or dequeues) at the next engine step. Dropping the iterator
    mid-stream and calling cancel() are equivalent."""

    def __init__(self, rid: int):
        self.rid = rid
        self.cancelled = False
        self.finish_reason: Optional[str] = None
        self.submitted_t = time.monotonic()
        self.first_token_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue()
        self._drained = False
        self._end_seen = False     # sentinel met inside next_many()
        # prompt tokens whose prefill the radix cache skipped (set at
        # admission; 0 = miss or cache disabled)
        self.prefix_matched = 0

    # ------------------------------------------------------ engine side
    def _emit(self, token: int, now: float):
        if self.first_token_t is None:
            self.first_token_t = now
        self._q.put(int(token))

    def _finish(self, reason: str, now: float,
                error: Optional[BaseException] = None):
        self.finish_reason = reason
        self.finished_t = now
        self.error = error
        self._q.put(_SENTINEL)

    # ---------------------------------------------------- consumer side
    def cancel(self):
        self.cancelled = True

    def __iter__(self):
        return self

    def __next__(self) -> int:
        return self.next()

    def next(self, timeout: Optional[float] = None) -> int:
        """Blocking next with an explicit timeout (raises queue.Empty).
        Safe to call past exhaustion: keeps raising StopIteration
        instead of blocking on an empty queue."""
        if self._drained or self._end_seen:
            self._drained = True
            if self.error is not None:
                raise self.error
            raise StopIteration
        item = self._q.get(timeout=timeout)
        if item is _SENTINEL:
            self._drained = True
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item

    def next_many(self, max_tokens: int, flush_s: float = 0.0,
                  timeout: Optional[float] = None) -> List[int]:
        """Coalesced drain: block for ONE token (so the first token of a
        batch is never delayed), then keep collecting already-emitted
        tokens until ``max_tokens`` are gathered or ``flush_s`` elapses.
        Returns a non-empty list; end-of-stream raises StopIteration on
        the call AFTER the one that returned the final tokens — no token
        is ever held back behind the flush timer once the engine
        finished the request."""
        first = self.next(timeout=timeout)   # raises at end of stream
        out = [first]
        deadline = time.monotonic() + max(0.0, flush_s)
        while len(out) < max_tokens:
            remaining = deadline - time.monotonic()
            try:
                if remaining > 0:
                    item = self._q.get(timeout=remaining)
                else:
                    item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _SENTINEL:
                # finish mid-batch: deliver what we have NOW; the next
                # call surfaces StopIteration (or the error)
                self._end_seen = True
                break
            out.append(item)
        return out

    def tokens(self) -> List[int]:
        """Drain to completion and return every generated token."""
        return list(self)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submitted_t


@dataclasses.dataclass
class RequestState:
    """Scheduler-internal record. Lifecycle:
    QUEUED -> PREFILLING -> ACTIVE -> (finished)."""
    rid: int
    request: Request
    handle: RequestHandle
    temperature: float
    eos_id: int
    status: str = "QUEUED"
    slot: Optional[int] = None
    prefill_pos: int = 0          # prompt tokens already prefilled
    generated: int = 0
    last_token: int = 0
    span: Optional[Any] = None    # flight-recorder engine.slot span
    # radix-cache admission state: matched prefix length (its prefill is
    # skipped: the engine copies the blocks instead) and the pinned trie
    # nodes backing it (released once the copy lands in scratch)
    prefix_matched: int = 0
    prefix_nodes: Optional[List[Any]] = None
    # remote-prefill admission state: a held request keeps its FIFO queue
    # position but is skipped by plan_prefill until release_hold, the
    # window in which its KV blocks are in flight from another engine.
    # Cancellation/deadline reaping still applies.
    hold: bool = False


@dataclasses.dataclass
class PrefillChunk:
    """One budgeted piece of prompt to run this step."""
    state: RequestState
    start: int                    # offset into the prompt
    length: int                   # real tokens in this chunk
    is_last: bool


class Scheduler:
    """FIFO admission with a per-step prefill-token budget.

    A request occupies a slot from the moment its first chunk runs
    (chunked prefill writes straight into a scratch cache that is
    inserted into the slot when the prompt completes), so admission =
    free slot AND budget. Multiple requests may be mid-prefill in one
    step if the budget covers them.
    """

    def __init__(self, n_slots: int, prefill_budget: int,
                 default_temperature: float = 0.0, eos_id: int = -1,
                 chunk_size: Optional[int] = None, prefix_cache=None):
        self.n_slots = n_slots
        self.prefill_budget = max(1, int(prefill_budget))
        # static shape of one prefill call; a planned chunk never
        # exceeds it (the engine pads shorter chunks up to it)
        self.chunk_size = int(chunk_size or self.prefill_budget)
        # optional RadixPrefixCache (prefix_cache.py): consulted once per
        # request at admission; matched spans skip prefill entirely
        self.prefix_cache = prefix_cache
        self.default_temperature = default_temperature
        self.default_eos = eos_id
        self._rid = itertools.count()
        self._queue: List[RequestState] = []      # FIFO, QUEUED only
        self._prefilling: List[RequestState] = []  # slot held, prompt wip
        self._active: Dict[int, RequestState] = {}  # slot -> state
        self._free_slots = list(range(n_slots))
        # drain mode (preemption notice): new submissions are refused
        # while everything already queued/prefilling/active runs to
        # completion
        self.draining = False

    # ----------------------------------------------------------- draining
    def begin_drain(self):
        """Flip admission off ahead of a preemption kill. Idempotent;
        there is no un-drain: a drained engine is on its way out."""
        self.draining = True

    def drained(self) -> bool:
        """True once every in-flight request has finished. Held requests
        still count as pending: their hand-off will release them."""
        return self.draining and not (self._queue or self._prefilling
                                      or self._active)

    # ------------------------------------------------------------ intake
    def submit(self, request: Request, hold: bool = False) -> RequestHandle:
        """hold=True enqueues WITHOUT making the request admissible: it
        keeps its FIFO position while a KV hand-off is in flight and
        becomes plannable on release_hold() (a hold that is never released
        is only reaped by cancel/deadline)."""
        if self.draining:
            raise RuntimeError(
                "scheduler is draining (preemption notice): new "
                "requests must be routed to another replica")
        rid = next(self._rid)
        handle = RequestHandle(rid)
        temp = (request.temperature
                if request.temperature is not None
                else self.default_temperature)
        eos = (request.eos_id if request.eos_id is not None
               else self.default_eos)
        st = RequestState(rid=rid, request=request, handle=handle,
                          temperature=float(temp), eos_id=int(eos),
                          hold=bool(hold))
        self._queue.append(st)
        return handle

    def release_hold(self, rid: int) -> bool:
        """Make a held request admissible (its hand-off landed, or failed,
        in which case admission falls back to local prefill). Idempotent;
        False when the request already left the queue."""
        for st in self._queue:
            if st.rid == rid:
                st.hold = False
                return True
        return False

    # -------------------------------------------------------- accounting
    def queue_depth(self) -> int:
        return len(self._queue)

    def occupancy(self) -> int:
        return self.n_slots - len(self._free_slots)

    def active_states(self) -> List[RequestState]:
        return list(self._active.values())

    def active_slots(self) -> List[int]:
        return list(self._active.keys())

    # ------------------------------------------------------------- sweep
    def reap(self, now: Optional[float] = None) -> List[RequestState]:
        """Remove cancelled/expired requests from every stage; returns
        the reaped states (slots already released). Called at the top of
        each engine step so a dropped client frees its slot within one
        iteration."""
        now = time.monotonic() if now is None else now
        reaped: List[RequestState] = []

        keep = []
        for st in self._queue:
            if st.handle.cancelled:
                st.status = "FINISHED"
                st.handle._finish(FINISH_CANCELLED, now)
                reaped.append(st)
            elif (st.request.deadline_s is not None
                    and now > st.request.deadline_s):
                st.status = "FINISHED"
                st.handle._finish(FINISH_DEADLINE, now)
                reaped.append(st)
            else:
                keep.append(st)
        self._queue = keep

        keep = []
        for st in self._prefilling:
            if st.handle.cancelled:
                self._release(st, FINISH_CANCELLED, now)
                reaped.append(st)
            else:
                keep.append(st)
        self._prefilling = keep

        for slot, st in list(self._active.items()):
            if st.handle.cancelled:
                self._release(st, FINISH_CANCELLED, now)
                reaped.append(st)
        return reaped

    def _release(self, st: RequestState, reason: str, now: float,
                 error: Optional[BaseException] = None):
        st.status = "FINISHED"
        self.unpin_prefix(st)
        freed_slot = st.slot
        if st.slot is not None:
            self._active.pop(st.slot, None)
            self._free_slots.append(st.slot)
            self._free_slots.sort()
            st.slot = None
        st.handle._finish(reason, now, error)
        if st.span is not None:
            # the engine-slot span covers admission -> eviction; the
            # finish reason and token count ride as attributes, and an
            # eviction instant marks the exact slot-release point
            from ray_tpu_torch._private import events
            events.record_instant(
                "engine.evict", category="engine",
                trace_id=st.span.trace_id,
                parent_span_id=st.span.span_id,
                slot=freed_slot, reason=reason)
            st.span.end(finish_reason=reason,
                        tokens_generated=st.generated)
            st.span = None

    # --------------------------------------------------------- admission
    def plan_prefill(self) -> List[PrefillChunk]:
        """Spend this step's prefill budget: continue mid-prefill
        requests first (their slot is already held), then admit queued
        requests into free slots, FIFO. Chunks never exceed the
        remaining budget, so one long prompt spreads across steps and
        never stalls in-flight decodes for more than `prefill_budget`
        tokens of work."""
        budget = self.prefill_budget
        chunks: List[PrefillChunk] = []
        for st in list(self._prefilling):
            if budget <= 0:
                break
            budget -= self._plan_one(st, budget, chunks)
        qi = 0
        while budget > 0 and qi < len(self._queue) and self._free_slots:
            if self._queue[qi].hold:
                # remote-prefill hand-off in flight: the request keeps its
                # FIFO position but later arrivals may admit past it
                qi += 1
                continue
            st = self._queue.pop(qi)
            st.slot = self._free_slots.pop(0)
            st.status = "PREFILLING"
            if self.prefix_cache is not None:
                matched, nodes = self.prefix_cache.match(st.request.tokens)
                if matched:
                    # the matched span's prefill is SKIPPED: the engine
                    # copies the pinned blocks into scratch before the
                    # first planned chunk runs; planning starts at the
                    # first uncached token
                    st.prefill_pos = matched
                    st.prefix_matched = matched
                    st.prefix_nodes = nodes
                    st.handle.prefix_matched = matched
            self._prefilling.append(st)
            budget -= self._plan_one(st, budget, chunks)
        return chunks

    def unpin_prefix(self, st: RequestState):
        """Matched blocks have been copied into the request's scratch: the
        trie nodes may be evicted again. Idempotent; also called on
        release so a cancelled mid-admission request never wedges a
        pin."""
        if st.prefix_nodes and self.prefix_cache is not None:
            self.prefix_cache.release(st.prefix_nodes)
        st.prefix_nodes = None

    def _plan_one(self, st: RequestState, budget: int,
                  chunks: List[PrefillChunk]) -> int:
        """Plan budgeted fixed-shape chunks for one request; the planned
        start offsets account for chunks earlier in THIS step's list."""
        prompt_len = len(st.request.tokens)
        pos = st.prefill_pos
        spent = 0
        while budget - spent > 0 and pos < prompt_len:
            n = min(budget - spent, self.chunk_size, prompt_len - pos)
            chunks.append(PrefillChunk(state=st, start=pos, length=n,
                                       is_last=pos + n >= prompt_len))
            pos += n
            spent += n
        return spent

    def prefill_done(self, st: RequestState, first_token: int,
                     now: float):
        """The prompt is fully in the slot and the first token sampled:
        the request joins the decode batch (or finishes immediately if
        the first token already terminates it)."""
        self._prefilling.remove(st)
        st.status = "ACTIVE"
        st.prefill_pos = len(st.request.tokens)
        st.last_token = int(first_token)
        st.generated = 1
        st.handle._emit(first_token, now)
        if self._is_finished(st, first_token):
            self._release(st, self._finish_reason(st, first_token), now)
        else:
            self._active[st.slot] = st

    def advance_prefill(self, st: RequestState, n: int):
        st.prefill_pos += n

    # ------------------------------------------------------------ decode
    def decode_emit(self, st: RequestState, token: int, now: float):
        """One decoded token for an active slot: emit, then evict on
        EOS/max-tokens (slot returns to the free list immediately)."""
        st.last_token = int(token)
        st.generated += 1
        st.handle._emit(token, now)
        if self._is_finished(st, token):
            self._release(st, self._finish_reason(st, token), now)

    def _is_finished(self, st: RequestState, token: int) -> bool:
        if st.eos_id >= 0 and int(token) == st.eos_id:
            return True
        return st.generated >= st.request.max_new_tokens

    def _finish_reason(self, st: RequestState, token: int) -> str:
        if st.eos_id >= 0 and int(token) == st.eos_id:
            return FINISH_EOS
        return FINISH_LENGTH

    def evict(self, st: RequestState, reason: str,
              error: Optional[BaseException] = None):
        """Force-evict (engine-detected condition, e.g. slot capacity
        reached before max_new_tokens)."""
        self._release(st, reason, time.monotonic(), error)

    def fail_all(self, error: BaseException):
        """Engine shutdown/crash: fail everything still in flight."""
        now = time.monotonic()
        for st in (list(self._queue) + list(self._prefilling)
                   + list(self._active.values())):
            self._release(st, FINISH_CANCELLED, now, error)
        self._queue.clear()
        self._prefilling.clear()

    def has_work(self) -> bool:
        """Actionable work only: a queue holding nothing but held requests
        doesn't spin the engine loop (release_hold notifies the loop's
        condition when a hand-off lands)."""
        return bool(self._prefilling or self._active
                    or any(not st.hold for st in self._queue))
