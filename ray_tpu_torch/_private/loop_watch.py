"""Stall watch for a daemon's event loop (GCS, node manager).

A node's liveness rides event loops: the node manager sends its heartbeat
from its loop, and the GCS reads it and judges silence from its own. A
loop held by one blocking call for longer than ``node_death_timeout_s``
therefore reads as a dead node. A thread beside the loop notices a stall
above ``threshold_s`` while it lasts, takes the loop thread's stack then,
and logs both once the loop runs again, so a stall names its call.
``stats`` keeps the count of stalls and the longest, in seconds.
"""

from __future__ import annotations

import asyncio
import logging
import sys
import threading
import time
import traceback

logger = logging.getLogger(__name__)

stats = {"stalls": 0, "longest_s": 0.0}
_ticks: list = []    # the loop keeps only a weak reference to a task


def install(name: str, threshold_s: float = 1.0,
            tick_s: float = 0.25) -> None:
    """Watch the running loop (call from inside it) for the rest of the
    process's life."""
    loop = asyncio.get_running_loop()
    loop_tid = threading.get_ident()
    last = [time.monotonic()]

    async def tick():
        while True:
            last[0] = time.monotonic()
            await asyncio.sleep(tick_s)

    def watch():
        seen = None      # (the tick the stall began after, its stack)
        while True:
            time.sleep(tick_s)
            tick_t = last[0]
            if seen is None:
                if time.monotonic() - tick_t > threshold_s:
                    frame = sys._current_frames().get(loop_tid)
                    seen = (tick_t, "".join(traceback.format_stack(frame))
                            if frame is not None else "(no frame)")
            elif tick_t != seen[0]:
                stalled = tick_t - seen[0]
                stats["stalls"] += 1
                stats["longest_s"] = max(stats["longest_s"], stalled)
                logger.warning("%s event loop stalled %.2f s; its stack "
                               "when the stall was seen:\n%s", name,
                               stalled, seen[1])
                seen = None

    _ticks.append(loop.create_task(tick()))
    threading.Thread(target=watch, name=f"{name}-loop-watch",
                     daemon=True).start()
