"""Node liveness in the port's GCS when a daemon's event loop is held.

The GCS declares a node dead after ``node_death_timeout_s`` without a
heartbeat. A GCS whose own loop was held that long has heartbeats waiting
unread in its sockets: it must not read that silence as the node's. A
node that really falls silent is still declared dead, and the GCS reports
the longest silence it saw from each node. The loop watch logs a stall
with the stack of the call that held the loop.
"""

import asyncio
import logging
import time
import types

import pytest

from ray_tpu_torch._private import loop_watch
from ray_tpu_torch._private.config import cfg
from ray_tpu_torch._private.gcs import GcsServer


@pytest.fixture
def fast_liveness():
    cfg.set("health_check_interval_s", 0.05)
    cfg.set("node_death_timeout_s", 0.3)
    yield
    cfg.reset("health_check_interval_s")
    cfg.reset("node_death_timeout_s")


def _gcs_with_a_node():
    g = GcsServer()
    g.h_register_node(types.SimpleNamespace(peer_info={}), "n1", "addr",
                      "store", {"CPU": 1.0}, {}, "127.0.0.1")
    return g


def test_held_gcs_loop_keeps_a_beating_node_alive(fast_liveness):
    async def main():
        g = _gcs_with_a_node()
        checker = asyncio.ensure_future(g._check_node_deaths())
        await asyncio.sleep(0.1)
        time.sleep(0.6)             # the GCS's loop is held past the timeout
        for _ in range(3):          # the checker's overdue round runs first
            await asyncio.sleep(0)
        g.h_heartbeat(None, "n1")   # then the beat that waited unread
        await asyncio.sleep(0.2)
        alive_after_hold = g.nodes["n1"]["alive"]
        (node,) = g.h_get_all_nodes(None)
        await asyncio.sleep(0.6)    # now the node falls silent
        checker.cancel()
        return alive_after_hold, node, g.nodes["n1"]["alive"]

    alive_after_hold, node, alive_after_silence = asyncio.run(main())
    assert alive_after_hold and not alive_after_silence
    # the silence the hold caused, as the GCS reports it
    assert 0.6 <= node["max_heartbeat_gap_s"] < 1.5


def test_loop_watch_logs_a_stall_with_its_stack(caplog):
    def hold_the_loop():
        time.sleep(0.8)

    async def main():
        loop_watch.install("test", threshold_s=0.3, tick_s=0.05)
        await asyncio.sleep(0.1)
        hold_the_loop()
        await asyncio.sleep(0.3)

    before = loop_watch.stats["stalls"]
    with caplog.at_level(logging.WARNING, logger=loop_watch.__name__):
        asyncio.run(main())
    assert loop_watch.stats["stalls"] == before + 1
    assert loop_watch.stats["longest_s"] >= 0.7
    (msg,) = [r.getMessage() for r in caplog.records
              if "event loop stalled" in r.getMessage()]
    assert "hold_the_loop" in msg
