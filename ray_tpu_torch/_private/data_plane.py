"""Binary data plane for cross-node object transfer.

Each node manager listens on a second raw-stream TCP socket (advertised
next to the RPC address in the GCS cluster view) that carries ONLY bulk
object chunk bytes. The control plane keeps negotiating transfers
(``request_push``/``push_begin``) over the msgpack RPC connection; the
chunk payloads move here, framed as ``[u32 header_len][msgpack header]
[raw chunk bytes]`` with no serialization of the payload itself:

- the sender writes ``memoryview`` slices of the pinned arena buffer
  straight into ``loop.sock_sendall`` (no ``bytes()`` staging copy, no
  msgpack encode of the chunk);
- the receiver ``recv_into()``s straight into the ``store.create``
  region for the object (no intermediate buffer, no decode copy).

This keeps heartbeats / lease grants / pubsub off the bulk path — an
8 MB chunk can no longer head-of-line-block a lease grant behind it on
the shared RPC socket (a false node death during large
broadcasts), and drops the per-chunk copy count from ~4 to the two
irreducible kernel copies.

Large objects stripe across up to ``cfg.transfer_streams`` parallel
data connections with contiguous per-stripe offset ranges; each stripe
keeps the existing ``cfg.push_window_chunks`` in-flight window (an
8-byte ack per chunk provides the flow control and surfaces receiver
aborts mid-stream). Reference shape: the dedicated chunked transfer
path distinct from control RPCs in the reference object manager
(object_manager Push/Pull, pull_manager.h:52, push_manager.h:30).

Wire protocol (one direction per role; a connection is used by exactly
one stripe of one transfer at a time, so acks return in order):

  client -> server   MAGIC(8B) once, then per chunk:
                     [u32 header_len][msgpack [oid, offset, len, seq]]
                     [len raw bytes]
  server -> client   per chunk: [u32 seq][u32 status]

Status codes: 0 chunk ok; 1 no receive state / aborted (sender must
error the push — the pull side retries); 2 finish failed (seal or relay
subtree error); 3 final chunk ok, object sealed and relay subtree done
(the ack for the completing chunk resolves only after the receiver's
relay fan-out finishes, so a broadcast root's await still covers the
whole tree, exactly like the msgpack path's last-chunk response).
"""

from __future__ import annotations

import asyncio
import logging
import socket
import time
from collections import deque
from typing import Dict, List, Optional

import msgpack

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import cfg

logger = logging.getLogger(__name__)

MAGIC = b"RTPDATA1"
_MAX_HEADER = 4096
# ack status codes
OK = 0
ABORTED = 1
FINISH_FAILED = 2
DONE = 3


class DataPlaneError(RuntimeError):
    """Transfer failed mid-stream (bytes may be half-delivered)."""


class DataPlaneUnavailable(ConnectionError):
    """No data connection could be established; ZERO payload bytes were
    sent, so the caller may safely fall back to the msgpack path against
    the same negotiated receive state."""


def adaptive_streams(size: int) -> int:
    """Stream count for one transfer of `size` bytes: weight-sized
    objects (>= cfg.transfer_large_object_bytes) escalate from the
    cfg.transfer_streams default to cfg.transfer_streams_large — a
    multi-GB broadcast wants every core's kernel-copy bandwidth, while
    small transfers keep striping overhead off the wire. The escalation
    is off whenever transfer_streams_large <= transfer_streams."""
    streams = cfg.transfer_streams
    large = cfg.transfer_streams_large
    if large > streams and size >= cfg.transfer_large_object_bytes:
        return large
    return streams


def stripe_ranges(size: int, streams: int, stripe_min: int) -> List[tuple]:
    """Split [0, size) into contiguous (offset, length) stripes: at most
    `streams`, each at least `stripe_min` bytes (except a small final
    object's single stripe)."""
    if size <= 0:
        return [(0, 0)]
    n = max(1, min(int(streams), size // max(1, int(stripe_min))))
    base, rem = divmod(size, n)
    ranges, off = [], 0
    for i in range(n):
        length = base + (1 if i < rem else 0)
        ranges.append((off, length))
        off += length
    return ranges


def binomial_split(targets: List[str]) -> List[tuple]:
    """Binomial-tree fan-out plan: split `targets` into (head, rest)
    pairs — the sender pushes to each head with `rest` delegated as its
    relay subtree, so the source sends O(log n) copies instead of n.
    Pure planning half of NodeManager.h_broadcast_object (unit-testable
    on any interpreter)."""
    plan = []
    targets = list(targets)
    while targets:
        mid = (len(targets) + 1) // 2
        plan.append((targets[0], targets[1:mid]))
        targets = targets[mid:]
    return plan


def plan_rebroadcast(missing: List[str], holders: List[str]) -> List[tuple]:
    """Retry plan after a relay node died mid-subtree: shard the nodes
    that never received the object across every SURVIVING holder
    (round-robin), each holder re-broadcasting its shard through its own
    relay tree. Returns (holder, [targets]) pairs; empty when nothing is
    missing or no holder survives."""
    holders = [h for h in holders if h]
    if not missing or not holders:
        return []
    shards: Dict[str, List[str]] = {h: [] for h in holders}
    for i, node in enumerate(missing):
        shards[holders[i % len(holders)]].append(node)
    return [(h, nodes) for h, nodes in shards.items() if nodes]


async def _recv_exact_into(loop, sock, view: memoryview, *,
                           on_bytes=None) -> None:
    pos, total = 0, len(view)
    while pos < total:
        n = await loop.sock_recv_into(sock, view[pos:])
        if n == 0:
            raise ConnectionError("data-plane peer closed mid-frame")
        pos += n
        if on_bytes is not None:
            on_bytes(n)


class DataPlaneServer:
    """Receiver side: accepts raw data connections and writes incoming
    chunks straight into the node manager's in-progress receive regions
    (``nm._receiving``). Runs on the node manager's event loop; every
    await point is a socket op, never a Python-level copy of the payload
    (the kernel copies into the mapped arena)."""

    def __init__(self, node_manager):
        self.nm = node_manager
        self._sock: Optional[socket.socket] = None
        self._accept_task: Optional[asyncio.Task] = None
        self._conn_tasks: set = set()
        self.address: Optional[str] = None
        # observability counters (surfaced via get_node_info)
        self.bytes_in = 0
        self.chunks_in = 0

    async def start(self, host: str = "0.0.0.0", port: int = 0) -> str:
        sock = socket.create_server((host, port), backlog=128)
        sock.setblocking(False)
        self._sock = sock
        self._accept_task = asyncio.ensure_future(self._accept_loop())
        addr_port = sock.getsockname()[1]
        self.address = f"tcp:{rpc._advertise_host(host)}:{addr_port}"
        return self.address

    async def close(self):
        victims = [t for t in [self._accept_task, *self._conn_tasks]
                   if t is not None and not t.done()]
        for t in victims:
            t.cancel()
        if victims:
            await asyncio.gather(*victims, return_exceptions=True)
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    @property
    def active_conns(self) -> int:
        return len(self._conn_tasks)

    async def _accept_loop(self):
        loop = asyncio.get_event_loop()
        while True:
            try:
                conn, _peer = await loop.sock_accept(self._sock)
            except (asyncio.CancelledError, OSError):
                return
            conn.setblocking(False)
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            t = asyncio.ensure_future(self._serve_conn(conn))
            self._conn_tasks.add(t)
            t.add_done_callback(self._conn_tasks.discard)

    async def _serve_conn(self, conn: socket.socket):
        loop = asyncio.get_event_loop()
        current_oid = None
        try:
            magic = bytearray(len(MAGIC))
            await _recv_exact_into(loop, conn, memoryview(magic))
            if bytes(magic) != MAGIC:
                return
            hdr4 = bytearray(4)
            while True:
                await _recv_exact_into(loop, conn, memoryview(hdr4))
                hlen = int.from_bytes(hdr4, "little")
                if not 0 < hlen <= _MAX_HEADER:
                    raise ConnectionError(
                        f"bad data-plane header length {hlen}")
                hbuf = bytearray(hlen)
                await _recv_exact_into(loop, conn, memoryview(hbuf))
                oid, offset, length, seq = msgpack.unpackb(bytes(hbuf))
                current_oid = oid
                status = await self._receive_chunk(loop, conn, oid,
                                                   offset, length)
                current_oid = None
                await loop.sock_sendall(
                    conn, seq.to_bytes(4, "little")
                    + status.to_bytes(4, "little"))
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError):
            # pusher died (or was reaped) mid-frame: a half-written chunk
            # poisons the receive — abort it NOW so parked pulls retry on
            # a surviving path instead of waiting out the 60s sweep
            if current_oid is not None:
                self._abort_mid_chunk(current_oid)
        except Exception:
            logger.exception("data-plane connection handler failed")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _abort_mid_chunk(self, oid: bytes):
        st = self.nm._receiving.get(oid)
        if st is None:
            return
        st["aborted"] = True
        if not st.get("writers"):
            self.nm._abort_receive(
                oid, "data connection lost mid-chunk (pusher died?)")

    async def _receive_chunk(self, loop, conn, oid: bytes, offset: int,
                             length: int) -> int:
        nm = self.nm
        st = nm._receiving.get(oid)
        if st is None or st.get("aborted"):
            if st is not None and not st.get("writers"):
                # marked aborted while no writer was active (e.g. the
                # reap sweep raced a chunk boundary): release it here —
                # the deferred-to-writer cleanup has no writer to run in
                nm._abort_receive(oid, "receive aborted mid-stream")
            await self._drain(loop, conn, length)
            return ABORTED
        st["writers"] = st.get("writers", 0) + 1
        st.setdefault("conns", set()).add(conn)

        def _touch(n):
            st["t"] = time.monotonic()
            self.bytes_in += n

        try:
            view = st["data"][offset:offset + length]
            await _recv_exact_into(loop, conn, view, on_bytes=_touch)
        finally:
            st["writers"] -= 1
            st["conns"].discard(conn)
        self.chunks_in += 1
        if st.get("aborted"):
            # the reap sweep marked us stale while the chunk was in
            # flight; it deferred the store abort to the active writer
            if not st["writers"]:
                nm._abort_receive(oid, "receive reaped mid-stream")
            return ABORTED
        st["remaining"] -= length
        if st["remaining"] > 0:
            return OK
        res = nm._finish_receive(oid)
        if asyncio.isfuture(res) or isinstance(res, asyncio.Task):
            # completing chunk's ack resolves only after the relay
            # subtree: the broadcast root's await covers the whole tree
            try:
                await res
            except Exception:
                return FINISH_FAILED
        return DONE

    async def _drain(self, loop, conn, length: int):
        """Consume a chunk that has no live receive state (e.g. reaped):
        the framing must stay in sync so the NEXT transfer on this
        connection still parses."""
        scratch = bytearray(min(length, 1 << 20))
        left = length
        while left > 0:
            view = memoryview(scratch)[:min(left, len(scratch))]
            n = await loop.sock_recv_into(conn, view)
            if n == 0:
                raise ConnectionError("data-plane peer closed mid-drain")
            left -= n


class DataPlaneClient:
    """Sender side: pools raw data connections per peer data address and
    streams pinned-arena memoryview slices over them, striped across up
    to ``cfg.transfer_streams`` connections."""

    def __init__(self, name: str = "dp"):
        self.name = name
        self._free: Dict[str, List[socket.socket]] = {}
        self._max_pooled = 8
        self.bytes_out = 0
        self.chunks_out = 0

    async def _connect(self, addr: str) -> socket.socket:
        parsed = rpc.parse_address(addr)
        if parsed[0] != "tcp":
            raise DataPlaneUnavailable(f"data plane needs tcp, got {addr}")
        loop = asyncio.get_event_loop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            await loop.sock_connect(sock, (parsed[1], parsed[2]))
            await loop.sock_sendall(sock, MAGIC)
        except (OSError, asyncio.CancelledError):
            sock.close()
            raise
        return sock

    async def _acquire(self, addr: str, n: int) -> List[socket.socket]:
        socks = []
        free = self._free.get(addr)
        while free and len(socks) < n:
            socks.append(free.pop())
        try:
            while len(socks) < n:
                socks.append(await self._connect(addr))
        except OSError as e:
            for s in socks:
                self._release(addr, s)
            raise DataPlaneUnavailable(
                f"cannot reach data plane at {addr}: {e}")
        return socks

    def _release(self, addr: str, sock: socket.socket):
        free = self._free.setdefault(addr, [])
        if len(free) < self._max_pooled:
            free.append(sock)
        else:
            sock.close()

    def _discard(self, sock: socket.socket):
        try:
            sock.close()
        except OSError:
            pass

    def close(self):
        for socks in self._free.values():
            for s in socks:
                self._discard(s)
        self._free.clear()

    async def push(self, addr: str, oid: bytes, data: memoryview,
                   size: int) -> List[int]:
        """Stream `data` (the object's pinned arena view) to the peer's
        data plane. Returns per-stripe byte counts. Raises
        DataPlaneUnavailable before any payload byte moved,
        DataPlaneError after (the receive state is then poisoned; the
        caller must error the push and let the pull side retry)."""
        ranges = stripe_ranges(size, adaptive_streams(size),
                               cfg.transfer_stripe_min_bytes)
        socks = await self._acquire(addr, len(ranges))
        sent = [0]      # payload bytes this push put on the wire
        tasks = [asyncio.ensure_future(
            self._send_stripe(socks[i], oid, data, off, length, sent))
            for i, (off, length) in enumerate(ranges)]
        try:
            await asyncio.gather(*tasks)
        except BaseException as e:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            # a failed/cancelled stripe leaves its connection mid-frame:
            # never return it to the pool
            for s in socks:
                self._discard(s)
            if isinstance(e, (DataPlaneError, asyncio.CancelledError)):
                raise
            if not sent[0]:
                # a stale pooled connection died on the first header:
                # nothing moved, the msgpack fallback is still safe
                raise DataPlaneUnavailable(
                    f"data plane at {addr} dropped before payload: {e}")
            raise DataPlaneError(
                f"data-plane push of {oid.hex()[:16]} failed: {e}") from e
        for s in socks:
            self._release(addr, s)
        return [length for _off, length in ranges]

    async def _send_stripe(self, sock, oid: bytes, data: memoryview,
                           start: int, length: int, sent: List[int]):
        loop = asyncio.get_event_loop()
        chunk = cfg.transfer_chunk_bytes
        window: deque = deque()
        seq = 0
        off, stop = start, start + length
        while off < stop:
            n = min(chunk, stop - off)
            # same chaos spec key as the msgpack path: the fault-
            # injection suites keep covering chunk pushes on this
            # transport (RAY_TPU_TORCH_TESTING_RPC_FAILURE="push_chunk=p")
            rpc._maybe_inject_failure("push_chunk")
            hdr = msgpack.packb([oid, off, n, seq])
            await loop.sock_sendall(
                sock, len(hdr).to_bytes(4, "little") + hdr)
            # header committed: the receiver is now engaged mid-chunk, so
            # a later failure must NOT fall back to msgpack (count the
            # chunk as sent before the payload write can partially fail)
            sent[0] += n
            # the payload leaves as a memoryview slice of the pinned
            # arena: the only copy is the kernel's
            await loop.sock_sendall(sock, data[off:off + n])
            self.bytes_out += n
            self.chunks_out += 1
            window.append(seq)
            seq += 1
            off += n
            if len(window) >= cfg.push_window_chunks:
                await self._read_ack(loop, sock, window.popleft(), oid)
        while window:
            await self._read_ack(loop, sock, window.popleft(), oid)

    async def _read_ack(self, loop, sock, want_seq: int, oid: bytes):
        buf = bytearray(8)
        await _recv_exact_into(loop, sock, memoryview(buf))
        seq = int.from_bytes(buf[:4], "little")
        status = int.from_bytes(buf[4:], "little")
        if seq != want_seq:
            raise DataPlaneError(
                f"data-plane ack out of order (got {seq}, want {want_seq})")
        if status == ABORTED:
            raise DataPlaneError(
                f"receiver aborted transfer of {oid.hex()[:16]} mid-stream")
        if status == FINISH_FAILED:
            raise DataPlaneError(
                f"receiver failed to seal/relay {oid.hex()[:16]}")
