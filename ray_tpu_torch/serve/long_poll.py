"""Shared long-poll client loop (reference: LongPollClient,
python/ray/serve/_private/long_poll.py:64).

One protocol implementation for every listener (HTTP proxy, gRPC proxy,
handle routers): snapshot versions -> blocking listen on the controller ->
apply updates via callback -> re-listen. Errors back off and retry; a
``should_stop`` hook lets owners retire a loop when the controller
identity changes (serve.shutdown).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

LISTEN_TIMEOUT_S = 30.0
CALL_TIMEOUT_S = 60.0
ERROR_BACKOFF_S = 1.0


def run_longpoll_loop(get_controller: Callable,
                      versions: Dict[str, int],
                      on_update: Callable[[str, Dict], None],
                      should_stop: Optional[Callable[[], bool]] = None,
                      idle_sleep_s: float = 0.2) -> None:
    """Drive a long-poll listener until should_stop(). ``versions`` is
    mutated in place; ``on_update(key, data)`` is called per changed key."""
    import ray_tpu_torch

    while not (should_stop and should_stop()):
        if not versions:
            time.sleep(idle_sleep_s)
            continue
        try:
            controller = get_controller()
            updates = ray_tpu_torch.get(
                controller.listen_for_change.remote(dict(versions),
                                                    LISTEN_TIMEOUT_S),
                timeout=CALL_TIMEOUT_S)
        except Exception:
            time.sleep(ERROR_BACKOFF_S)
            continue
        for key, item in (updates or {}).items():
            versions[key] = item["version"]
            try:
                on_update(key, item["data"])
            except Exception:
                pass


def prime_snapshot(controller, versions: Dict[str, int],
                   on_update: Callable[[str, Dict], None],
                   keys=("routes",), timeout: float = 30.0) -> None:
    """Synchronous initial snapshot of `keys` before the long-poll loop
    starts: a component that reports ready() must already hold state
    deployed before it came up (first-request 404 race otherwise). The
    -1 sentinel version always returns immediately (controller versions
    start at 0). Failure is logged, not raised — the loop converges."""
    import logging

    import ray_tpu_torch
    try:
        hits = ray_tpu_torch.get(controller.listen_for_change.remote(
            {k: -1 for k in keys}, 5.0), timeout=timeout)
        for key, item in (hits or {}).items():
            versions[key] = item["version"]
            on_update(key, item["data"])
    except Exception:
        logging.getLogger(__name__).warning(
            "initial %s snapshot failed; relying on the long-poll loop "
            "to converge (first requests may miss routes)", keys,
            exc_info=True)
