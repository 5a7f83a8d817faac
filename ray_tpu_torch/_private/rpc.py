"""Asyncio RPC: length-prefixed msgpack frames over unix/tcp sockets.

The control-plane transport for the whole runtime — the role gRPC plays in
the reference (reference: src/ray/rpc/grpc_server.h, client_call.h). Design
differences, deliberately: one tiny symmetric protocol instead of per-service
protobuf schemas; connections are bidirectional (either side may issue
requests over an established connection), which removes the server→client
callback channels the reference needs (pubsub long-polling, owner RPCs).

Frame:   [u32 little-endian length][msgpack payload]
Payload: [type, seq, method, kwargs]          type: 0=request 1=response
         [1, seq, ok, result_or_error]              2=notify (no response)
Large binary values ride inside msgpack bin fields; bulk object payloads
never transit this layer (they live in the shm store / object transfer path).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import socket
import traceback
from typing import Any, Awaitable, Callable, Dict, Optional

import msgpack

logger = logging.getLogger(__name__)

REQUEST = 0
RESPONSE = 1
NOTIFY = 2
PARTIAL = 3     # [3, seq, idx, ok, payload] — streamed per-item response

_MAX_FRAME = 1 << 31
_EAGER_FLUSH_BYTES = 1 << 20    # frames this large skip the per-turn coalesce


class RpcError(Exception):
    """Remote handler raised; carries the remote traceback text."""

    def __init__(self, kind: str, message: str, remote_tb: str = ""):
        super().__init__(f"{kind}: {message}")
        self.kind = kind
        self.message = message
        self.remote_tb = remote_tb


_CHAOS_SPEC = None
_CHAOS_CALLS: dict = {}


def _maybe_inject_failure(method: str):
    """RPC chaos for fault-injection tests (reference: RpcFailureManager
    src/ray/rpc/rpc_chaos.cc:35 + RAY_testing_rpc_failure). Spec via env
    RAY_TPU_TORCH_TESTING_RPC_FAILURE="method=prob,method2=prob"; a value
    "#N" in place of a probability fails only the Nth check of that
    method in this process (counted from when the spec is parsed)."""
    global _CHAOS_SPEC, _CHAOS_CALLS
    if _CHAOS_SPEC is None:
        import os
        spec = {}
        raw = os.environ.get("RAY_TPU_TORCH_TESTING_RPC_FAILURE", "")
        for part in raw.split(","):
            if "=" in part:
                m, p = part.split("=", 1)
                try:
                    spec[m.strip()] = (int(p.strip()[1:])
                                       if p.strip().startswith("#")
                                       else float(p))
                except ValueError:
                    pass
        _CHAOS_SPEC = spec
        _CHAOS_CALLS = {}
    prob = _CHAOS_SPEC.get(method)
    if isinstance(prob, int):
        _CHAOS_CALLS[method] = n = _CHAOS_CALLS.get(method, 0) + 1
        if n == prob:
            raise RpcError("ChaosInjected",
                           f"injected chaos failure for {method!r} at "
                           f"check {n}")
    elif prob:
        import random
        if random.random() < prob:
            raise RpcError("ChaosInjected",
                           f"injected chaos failure for {method!r}")


class ConnectionLost(Exception):
    pass


def _pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _unpack(data) -> Any:
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


class Connection:
    """One bidirectional framed connection. Both peers can call/notify."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 handlers: Optional[Dict[str, Callable]] = None, name: str = "?"):
        self.reader = reader
        self.writer = writer
        self.handlers = handlers if handlers is not None else {}
        self.name = name
        self._seq = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._part_handlers: Dict[int, Callable] = {}
        self._out: list = []          # frames awaiting the per-turn flush
        self._closed = False
        self._drainer: Optional[asyncio.Task] = None
        self._task: Optional[asyncio.Task] = None
        self._dispatch_tasks: set = set()
        self.on_close: Optional[Callable[["Connection"], None]] = None
        # opaque slot for servers to stash peer identity (node id, worker id)
        self.peer_info: Dict[str, Any] = {}

    def start(self):
        self._task = asyncio.ensure_future(self._read_loop())
        return self

    @property
    def closed(self) -> bool:
        return self._closed

    async def _read_loop(self):
        try:
            while True:
                hdr = await self.reader.readexactly(4)
                n = int.from_bytes(hdr, "little")
                if n > _MAX_FRAME:
                    raise ConnectionLost(f"frame too large: {n}")
                body = await self.reader.readexactly(n)
                msg = _unpack(body)
                mtype = msg[0]
                if mtype == REQUEST or mtype == NOTIFY:
                    self._dispatch_msg(msg)
                elif mtype == RESPONSE:
                    _, seq, ok, payload = msg
                    self._part_handlers.pop(seq, None)
                    fut = self._pending.pop(seq, None)
                    if fut is not None and not fut.done():
                        if ok:
                            fut.set_result(payload)
                        else:
                            fut.set_exception(RpcError(*payload))
                elif mtype == PARTIAL:
                    _, seq, idx, ok, payload = msg
                    h = self._part_handlers.get(seq)
                    if h is not None:
                        try:
                            h(idx, ok, payload)
                        except Exception:
                            logger.exception("partial handler failed")
        except (asyncio.IncompleteReadError, ConnectionResetError,
                ConnectionLost, BrokenPipeError, OSError):
            pass
        except Exception:
            logger.exception("rpc read loop error on %s", self.name)
        finally:
            await self._shutdown()

    async def _shutdown(self):
        if self._closed:
            return
        self._flush_out()      # last frames (e.g. a final error response)
        self._closed = True
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost(f"connection {self.name} lost"))
        self._pending.clear()
        try:
            self.writer.close()
        except Exception:
            pass
        if self.on_close is not None:
            try:
                cb = self.on_close
                self.on_close = None
                res = cb(self)
                if asyncio.iscoroutine(res):
                    await res
            except Exception:
                logger.exception("on_close callback failed for %s", self.name)

    def _dispatch_msg(self, msg):
        """Run a request/notify. Sync handlers and Future-returning handlers
        complete without spawning a task (the hot actor-call path); only
        true coroutines get one (reference keeps its hot path allocation-
        free the same way, src/ray/rpc/grpc_server.h ServerCall reuse)."""
        mtype, seq, method, kwargs = msg
        handler = self.handlers.get(method)
        if handler is None:
            if mtype == REQUEST:
                self._respond(seq, False, ("NotImplementedError",
                                           f"no handler {method!r}", ""))
            return
        if getattr(handler, "streaming", False) and mtype == REQUEST:
            # streaming handler: receives its seq and answers with
            # send_partial(...) + send_final(...) itself
            try:
                handler(self, seq, **kwargs)
            except Exception as e:
                self._handler_error(REQUEST, seq, method, e)
            return
        try:
            result = handler(self, **kwargs)
        except Exception as e:
            self._handler_error(mtype, seq, method, e)
            return
        if isinstance(result, asyncio.Future):
            if mtype == REQUEST:
                result.add_done_callback(
                    lambda f, s=seq, m=method: self._finish_request(s, m, f))
            return
        if asyncio.iscoroutine(result) or isinstance(result, Awaitable):
            t = asyncio.ensure_future(
                self._dispatch_async(mtype, seq, method, result))
            self._dispatch_tasks.add(t)
            t.add_done_callback(self._dispatch_tasks.discard)
            return
        if mtype == REQUEST:
            self._respond(seq, True, result)

    def _finish_request(self, seq, method, fut: asyncio.Future):
        if fut.cancelled():
            self._handler_error(REQUEST, seq, method,
                                asyncio.CancelledError("cancelled"))
            return
        exc = fut.exception()
        if exc is not None:
            self._handler_error(REQUEST, seq, method, exc)
        else:
            self._respond(seq, True, fut.result())

    async def _dispatch_async(self, mtype, seq, method, coro):
        try:
            result = await coro
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._handler_error(mtype, seq, method, e)
            return
        if mtype == REQUEST:
            self._respond(seq, True, result)

    def _handler_error(self, mtype, seq, method, e: BaseException):
        if mtype == REQUEST:
            try:
                self._respond(seq, False, (type(e).__name__, str(e),
                                           traceback.format_exc()))
            except (ConnectionLost, ConnectionError):
                pass
        else:
            logger.error("notify handler %s failed: %s", method, e)

    def _respond(self, seq, ok, payload):
        try:
            self._send_nowait([RESPONSE, seq, ok, payload])
        except (ConnectionLost, ConnectionError):
            pass   # peer gone; response undeliverable

    def _send_nowait(self, obj):
        """Serialize and queue for the next loop-iteration flush: every
        frame produced in one event-loop turn (pipelined requests, a
        burst of PARTIAL acks) leaves in ONE writelines/syscall. All
        sends happen on the event-loop thread, so frames never
        interleave. TCP backpressure: async senders await maybe_drain();
        a background drainer backstops fire-and-forget sends (a
        drain() per message made the pipelined path 10x slower)."""
        if self._closed:
            raise ConnectionLost(f"connection {self.name} closed")
        data = _pack(obj)
        out = self._out
        out.append(len(data).to_bytes(4, "little"))
        out.append(data)
        if len(data) >= _EAGER_FLUSH_BYTES:
            # bulk frame (object transfer chunk, big inline value): hand
            # it to the transport NOW so the kernel overlaps the send with
            # the rest of this loop turn instead of buffering megabytes
            # behind a call_soon
            self._flush_out()
            return
        if len(out) == 2:       # first frame this turn: schedule the flush
            asyncio.get_event_loop().call_soon(self._flush_out)

    def _flush_out(self):
        out = self._out
        if not out or self._closed:
            out.clear()
            return
        self._out = []
        try:
            self.writer.writelines(out)
        except Exception:
            return
        if self._drainer is None:
            transport = self.writer.transport
            if transport is not None and \
                    transport.get_write_buffer_size() > (1 << 20):
                self._drainer = asyncio.ensure_future(self._drain_bg())

    async def _drain_bg(self):
        try:
            await self.writer.drain()
        except Exception:
            pass
        finally:
            self._drainer = None

    def over_highwater(self) -> bool:
        transport = self.writer.transport
        return transport is not None and \
            transport.get_write_buffer_size() > (1 << 20)

    async def maybe_drain(self):
        """Await real TCP backpressure when the write buffer is past the
        high-water mark — async senders call this so a slow peer throttles
        them instead of buffering without bound."""
        if self._out:
            self._flush_out()
        if self.over_highwater():
            try:
                await self.writer.drain()
            except (ConnectionResetError, BrokenPipeError, OSError):
                raise ConnectionLost(f"connection {self.name} lost")

    async def _send(self, obj):
        self._send_nowait(obj)
        await self.maybe_drain()

    async def call(self, method: str, timeout: Optional[float] = None, **kwargs) -> Any:
        fut = self.call_start_nowait(method, kwargs)
        await self.maybe_drain()
        if timeout is not None:
            return await asyncio.wait_for(fut, timeout)
        return await fut

    def call_start_nowait(self, method: str, kwargs) -> asyncio.Future:
        """Issue the request and return the response future — sync, so
        submission order is the caller's statement order."""
        _maybe_inject_failure(method)
        seq = next(self._seq)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[seq] = fut
        try:
            self._send_nowait([REQUEST, seq, method, kwargs])
        except BaseException:
            self._pending.pop(seq, None)
            fut.cancel()
            raise
        return fut

    async def call_start(self, method: str, **kwargs) -> asyncio.Future:
        return self.call_start_nowait(method, kwargs)

    def call_start_parts(self, method: str, kwargs,
                         on_part: Callable) -> asyncio.Future:
        """Batched request with streamed per-item responses: `on_part(idx,
        ok, payload)` fires as each item completes on the peer; the
        returned future resolves when the peer sends the final RESPONSE.
        One frame out, per-item acks back — a worker death mid-batch
        only loses the unacked items."""
        seq = next(self._seq)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[seq] = fut
        self._part_handlers[seq] = on_part
        try:
            self._send_nowait([REQUEST, seq, method, kwargs])
        except BaseException:
            self._pending.pop(seq, None)
            self._part_handlers.pop(seq, None)
            fut.cancel()
            raise
        return fut

    def send_partial(self, seq: int, idx: int, ok: bool, payload):
        try:
            self._send_nowait([PARTIAL, seq, idx, ok, payload])
        except (ConnectionLost, ConnectionError):
            pass

    def send_final(self, seq: int, payload):
        self._respond(seq, True, payload)

    async def notify(self, method: str, **kwargs):
        self._send_nowait([NOTIFY, 0, method, kwargs])
        await self.maybe_drain()

    async def close(self):
        me = asyncio.current_task()
        victims = [t for t in [self._task, self._drainer,
                               *self._dispatch_tasks]
                   if t is not None and t is not me and not t.done()]
        for t in victims:
            t.cancel()
        if victims:
            await asyncio.gather(*victims, return_exceptions=True)
        await self._shutdown()


def parse_address(addr: str):
    """'unix:/path' or 'tcp:host:port' -> (kind, ...)."""
    if addr.startswith("unix:"):
        return ("unix", addr[5:])
    if addr.startswith("tcp:"):
        host, port = addr[4:].rsplit(":", 1)
        return ("tcp", host, int(port))
    # bare host:port
    host, port = addr.rsplit(":", 1)
    return ("tcp", host, int(port))


class Server:
    """RPC server accepting unix and/or tcp connections with shared handlers."""

    def __init__(self, handlers: Dict[str, Callable], name: str = "server"):
        self.handlers = handlers
        self.name = name
        self._servers = []
        self.connections: set = set()
        self.on_connection: Optional[Callable[[Connection], None]] = None
        self.on_disconnect: Optional[Callable[[Connection], None]] = None

    async def _on_client(self, reader, writer):
        sock = writer.get_extra_info("socket")
        if sock is not None and sock.family != socket.AF_UNIX:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = Connection(reader, writer, self.handlers,
                          name=f"{self.name}-peer").start()
        self.connections.add(conn)

        def _closed(c):
            self.connections.discard(c)
            if self.on_disconnect is not None:
                self.on_disconnect(c)

        conn.on_close = _closed
        if self.on_connection is not None:
            self.on_connection(conn)

    async def listen_unix(self, path: str):
        if os.path.exists(path):
            os.unlink(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        srv = await asyncio.start_unix_server(self._on_client, path=path)
        self._servers.append(srv)
        return f"unix:{path}"

    async def listen_tcp(self, host: str = "0.0.0.0", port: int = 0) -> str:
        srv = await asyncio.start_server(self._on_client, host=host, port=port,
                                         reuse_address=True)
        self._servers.append(srv)
        port = srv.sockets[0].getsockname()[1]
        return f"tcp:{_advertise_host(host)}:{port}"

    async def close(self):
        # connections BEFORE wait_closed: py3.12's Server.wait_closed()
        # waits for every live connection handler, so closing the
        # listening socket first deadlocks against our own still-open
        # peers (observed: driver shutdown hanging >5s after Data runs,
        # whose workers keep result-push conns to the driver open)
        for conn in list(self.connections):
            await conn.close()
        for srv in self._servers:
            srv.close()
            try:
                await asyncio.wait_for(srv.wait_closed(), 2.0)
            except asyncio.TimeoutError:
                pass


def _advertise_host(bind_host: str) -> str:
    if bind_host not in ("0.0.0.0", "::", ""):
        return bind_host
    return node_ip_address()


_cached_ip: Optional[str] = None


def node_ip_address() -> str:
    global _cached_ip
    if _cached_ip is None:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            # no traffic is sent; just picks the interface with a default route
            s.connect(("8.8.8.8", 80))
            _cached_ip = s.getsockname()[0]
        except OSError:
            _cached_ip = "127.0.0.1"
        finally:
            s.close()
    return _cached_ip


async def connect(addr: str, handlers: Optional[Dict[str, Callable]] = None,
                  name: str = "client", retries: int = 0,
                  retry_delay: float = 0.1) -> Connection:
    parsed = parse_address(addr)
    last_err: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            if parsed[0] == "unix":
                reader, writer = await asyncio.open_unix_connection(parsed[1])
            else:
                reader, writer = await asyncio.open_connection(parsed[1], parsed[2])
                sock = writer.get_extra_info("socket")
                if sock is not None:
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return Connection(reader, writer, handlers, name=name).start()
        except (ConnectionRefusedError, FileNotFoundError, OSError) as e:
            last_err = e
            if attempt < retries:
                await asyncio.sleep(min(retry_delay * (1.5 ** attempt), 2.0))
    raise ConnectionError(f"cannot connect to {addr}: {last_err}")


class ConnectionPool:
    """Caches one Connection per address; reconnects lazily on loss."""

    def __init__(self, handlers: Optional[Dict[str, Callable]] = None,
                 name: str = "pool"):
        self.handlers = handlers or {}
        self.name = name
        self._conns: Dict[str, Connection] = {}
        self._locks: Dict[str, asyncio.Lock] = {}
        self._closing: set = set()

    async def get(self, addr: str) -> Connection:
        conn = self._conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        lock = self._locks.setdefault(addr, asyncio.Lock())
        async with lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn.closed:
                return conn
            conn = await connect(addr, self.handlers,
                                 name=f"{self.name}->{addr}", retries=3)
            self._conns[addr] = conn
            return conn

    async def call(self, addr: str, method: str, **kwargs):
        conn = await self.get(addr)
        return await conn.call(method, **kwargs)

    def invalidate(self, addr: str):
        conn = self._conns.pop(addr, None)
        if conn is not None and not conn.closed:
            t = asyncio.ensure_future(conn.close())
            self._closing.add(t)
            t.add_done_callback(self._closing.discard)

    async def close(self):
        conns, self._conns = list(self._conns.values()), {}
        if conns:
            await asyncio.gather(*(c.close() for c in conns),
                                 return_exceptions=True)
        if self._closing:
            await asyncio.gather(*list(self._closing),
                                 return_exceptions=True)
