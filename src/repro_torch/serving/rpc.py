"""Network RPC serving surface: the tenant-routed frontend on a socket.
Port of ``repro.serving.rpc``, byte for byte on the wire: the same
frames, opcodes, error codes and codecs, so that either package's
``RpcClient`` talks to either package's ``RpcServer``, and one request
encodes to the same bytes in both.

The paper's case is serving economics, and serving economics are only
real over a wire: this module puts an asyncio server in front of the
tenant-routed ``QueryFrontend`` so the whole stack — corpus cache,
shared runtime, micro-batch coalescing, admission control, breakers,
fault injection — is measurable as a network service under open-loop
load.

Wire protocol (little-endian, length-prefixed binary)
-----------------------------------------------------
Every frame on the socket, both directions, is::

    u32 length | payload (length bytes, 1 <= length <= MAX_FRAME)

The payload's first byte is the opcode.  A ranking request
(``OP_RANK``)::

    u8  opcode = 0x01
    u32 request_id            caller-chosen correlation id
    u8  tenant_len | tenant   utf-8 ("" routes the single-tenant lane)
    u16 k                     winners wanted
    f64 deadline_rel          seconds from server receipt; <= 0 = none
    u16 n_ctx | n_ctx x i32   context slot ids
    u8  has_weights | [n_ctx x f32]   context weights (absent = ones)

A reply (``OP_REPLY``) correlates by ``request_id`` — replies to
pipelined requests may arrive OUT OF ORDER::

    u8  opcode = 0x81
    u32 request_id
    u8  status                0 = ok, else an error code (table below)
    ok:    u16 served_k | u8 degraded | served_k x f32 | served_k x i32
    error: u8 tenant_len | tenant | u16 msg_len | message

Scores and slot ids are the frontend's reply verbatim (f32/i32), so a
socket reply is bit-exact vs a direct ``frontend.submit(...).result()``
of the same request — the load harness asserts this.

Error frames map 1:1 from the ``ServingError`` taxonomy via
``WIRE_ERRORS`` (a test keeps that dict covering every ``ServingError``
subclass of the package); two extra codes cover caller bugs
(``CODE_BAD_REQUEST``: the server's ``ValueError``/``TypeError``) and
anything unclassifiable (``CODE_INTERNAL``).  ``RpcClient`` rebuilds the
TYPED exception from the code, so ``except Overloaded`` works the same
across the wire as in process.

Threading model (one loop, one frontend thread)
-----------------------------------------------
``QueryFrontend`` blocks (its RLock, device reads), so the event loop
never touches it directly: every frontend call — submit, the pump tick,
resolve, drain, close — runs on a dedicated single-worker executor
thread, serialized by construction.  The server requires
``auto_pump=False`` (the knob added for exactly this) and schedules the
pump itself: a loop task ticks ``pump()`` + ``resolve()`` on the
executor every ``pump_interval`` seconds, then completes the asyncio
futures of finished requests (the sweep).  Replies are written by
per-request handler tasks; a per-connection write lock keeps concurrent
reply frames from interleaving.  On the card, torch's current stream is
per thread: the executor thread launches the kernels and reads their
results on its own current stream, the device's default stream unless
the caller changed it, so a batch's launch and its read are always on
one stream.

Backpressure, hardening, chaos
------------------------------
Each connection holds a semaphore of ``max_inflight_per_conn`` slots;
the read loop acquires a slot BEFORE parsing the next request, so a
client that pipelines past its window stops being read — TCP
backpressure, per connection, with no global stall.  Framing violations
(oversized or zero declared length) and mid-frame disconnects close
that connection only; a garbage payload inside an intact frame gets a
typed error frame back and the connection lives on.  All per-request
state is per-connection, so none of this can corrupt a neighbor's
replies (``tests/test_torch_rpc.py`` fuzzes exactly these paths).
The ``rpc_accept``/``rpc_read``/``rpc_write`` fault sites let the chaos
suite (``tests/test_torch_rpc.py``) kill connections at every stage
and prove accepted requests still resolve.

Graceful drain: ``shutdown()`` — wired to SIGTERM/SIGINT by
``install_signal_handlers`` — stops the listener, drains the frontend
(every accepted request resolves to a result or a typed error), waits
for the reply writers, then takes the frontend's existing ``close()``
path.  ``serve_in_thread`` runs the whole server on a daemon thread for
tests, benchmarks, and ``serve.py --rpc``.
"""
from __future__ import annotations

import asyncio
import contextlib
import signal
import socket
import struct
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.serving.errors import (
    DeadlineExceeded,
    Degraded,
    DispatchFailed,
    NotReady,
    Overloaded,
    RefreshFailed,
    ServingError,
    Unservable,
)
from repro_torch.serving.faults import InjectedFault

MAX_FRAME = 1 << 20          # largest accepted payload (1 MiB)
OP_RANK = 0x01
OP_REPLY = 0x81

# ServingError taxonomy -> wire error code, 1:1 over the closure (a test
# fails if a serving/*.py ServingError subclass is missing here).  Codes
# are wire ABI: append, never renumber.
WIRE_ERRORS = {
    "Overloaded": 1,
    "DeadlineExceeded": 2,
    "Unservable": 3,
    "DispatchFailed": 4,
    "RefreshFailed": 5,
    "NotReady": 6,
    "Degraded": 7,
    "InjectedFault": 8,
    "ServingError": 9,          # the base: any subclass without own code
    "RpcProtocolError": 10,
    "RpcDisconnected": 11,
}
CODE_BAD_REQUEST = 100       # caller bug: ValueError/TypeError at submit
CODE_INTERNAL = 101          # anything unclassifiable (server-side bug)

_ERROR_TYPES = {cls.__name__: cls for cls in (
    Overloaded, DeadlineExceeded, Unservable, DispatchFailed,
    RefreshFailed, NotReady, Degraded, InjectedFault, ServingError)}
_CODE_TO_NAME = {v: k for k, v in WIRE_ERRORS.items()}


class RpcProtocolError(ServingError):
    """The peer violated the wire protocol: bad framing, a garbage or
    truncated payload, an unknown opcode.  Framing-level violations
    (the length prefix itself) close the connection — the stream can no
    longer be parsed; payload-level violations answer with this error's
    frame and keep the connection."""


class RpcDisconnected(ConnectionError, ServingError):
    """The stream died mid-conversation: the peer closed (or the
    transport dropped) while a frame was still owed.  Raised client-side
    by ``RpcClient`` when the server hangs up before a pending reply;
    inherits ``ConnectionError`` so socket-level handlers still catch
    it, and ``ServingError`` so it stays inside the typed taxonomy."""

    def __init__(self, message: str = "", *, tenant: str | None = None):
        # OSError.__init__ would win the MRO race; route to the taxonomy
        ServingError.__init__(self, message, tenant=tenant)


# -- frame codecs (module-level so tests fuzz them directly) --------------

def frame(payload: bytes) -> bytes:
    """Length-prefix one payload for the socket."""
    if not 1 <= len(payload) <= MAX_FRAME:
        raise ValueError(f"payload length {len(payload)} outside "
                         f"[1, {MAX_FRAME}]")
    return struct.pack("<I", len(payload)) + payload


def encode_rank_request(request_id: int, context_ids, context_weights=None,
                        *, k: int = 10, deadline_rel: float | None = None,
                        tenant: str | None = None) -> bytes:
    """Encode one OP_RANK payload (not yet length-prefixed)."""
    ctx = np.ascontiguousarray(context_ids, np.int32).reshape(-1)
    tb = (tenant or "").encode()
    if len(tb) > 0xFF:
        raise ValueError(f"tenant name longer than 255 bytes: {tenant!r}")
    out = [struct.pack("<BIB", OP_RANK, request_id & 0xFFFFFFFF, len(tb)),
           tb,
           struct.pack("<Hd", k,
                       0.0 if deadline_rel is None else float(deadline_rel)),
           struct.pack("<H", ctx.shape[0]), ctx.tobytes()]
    if context_weights is None:
        out.append(struct.pack("<B", 0))
    else:
        w = np.ascontiguousarray(context_weights, np.float32).reshape(-1)
        if w.shape != ctx.shape:
            raise ValueError(f"weights shape {w.shape} != context "
                             f"shape {ctx.shape}")
        out.append(struct.pack("<B", 1))
        out.append(w.tobytes())
    return b"".join(out)


class RankRequest:
    """One decoded OP_RANK payload."""

    __slots__ = ("request_id", "tenant", "k", "deadline_rel", "ctx", "w")

    def __init__(self, request_id, tenant, k, deadline_rel, ctx, w):
        self.request_id = request_id
        self.tenant = tenant
        self.k = k
        self.deadline_rel = deadline_rel
        self.ctx = ctx
        self.w = w


def decode_rank_request(payload: bytes) -> RankRequest:
    """Parse one OP_RANK payload; raises ``RpcProtocolError`` on any
    malformation (short buffer, bad lengths, trailing garbage)."""
    tenant = None
    try:
        op, request_id, tlen = struct.unpack_from("<BIB", payload, 0)
        off = 6
        if op != OP_RANK:
            raise RpcProtocolError(f"opcode {op:#x} is not OP_RANK",
                                   tenant=tenant)
        tenant = payload[off:off + tlen].decode() or None
        if off + tlen > len(payload):
            raise RpcProtocolError("tenant field overruns payload",
                                   tenant=tenant)
        off += tlen
        k, deadline_rel = struct.unpack_from("<Hd", payload, off)
        off += 10
        (n_ctx,) = struct.unpack_from("<H", payload, off)
        off += 2
        ctx = np.frombuffer(payload, np.int32, n_ctx, off)
        if ctx.shape[0] != n_ctx:
            raise RpcProtocolError(f"context field declares {n_ctx} slots "
                                   f"but carries {ctx.shape[0]}",
                                   tenant=tenant)
        off += 4 * n_ctx
        (has_w,) = struct.unpack_from("<B", payload, off)
        off += 1
        w = None
        if has_w:
            w = np.frombuffer(payload, np.float32, n_ctx, off)
            if w.shape[0] != n_ctx:
                raise RpcProtocolError("weights field truncated",
                                       tenant=tenant)
            off += 4 * n_ctx
        if off != len(payload):
            raise RpcProtocolError(f"{len(payload) - off} trailing bytes "
                                   f"after request", tenant=tenant)
    except (struct.error, ValueError, UnicodeDecodeError) as e:
        raise RpcProtocolError(f"malformed rank request: {e}",
                               tenant=tenant) from e
    return RankRequest(request_id, tenant, k,
                       deadline_rel if deadline_rel > 0.0 else None,
                       ctx, w)


def encode_ok_reply(request_id: int, scores, slots,
                    degraded: bool = False) -> bytes:
    """Encode a success reply: the frontend's (scores, slots) verbatim
    (f32/i32 — bit-exact across the wire)."""
    s = np.ascontiguousarray(scores, np.float32).reshape(-1)
    i = np.ascontiguousarray(slots, np.int32).reshape(-1)
    return (struct.pack("<BIBHB", OP_REPLY, request_id & 0xFFFFFFFF, 0,
                        s.shape[0], int(degraded))
            + s.tobytes() + i.tobytes())


def error_code_of(err: BaseException) -> int:
    """Wire code for an exception: nearest ``WIRE_ERRORS`` ancestor for
    the taxonomy, ``CODE_BAD_REQUEST`` for caller bugs, else
    ``CODE_INTERNAL``."""
    for cls in type(err).__mro__:
        if cls.__name__ in WIRE_ERRORS and issubclass(cls, ServingError):
            return WIRE_ERRORS[cls.__name__]
    if isinstance(err, (ValueError, TypeError)):
        return CODE_BAD_REQUEST
    return CODE_INTERNAL


def encode_error_reply(request_id: int, err: BaseException) -> bytes:
    """Encode a typed error frame from any exception."""
    tb = (getattr(err, "tenant", None) or "").encode()[:0xFF]
    mb = str(err).encode()[:0xFFFF]
    return (struct.pack("<BIB", OP_REPLY, request_id & 0xFFFFFFFF,
                        error_code_of(err))
            + struct.pack("<B", len(tb)) + tb
            + struct.pack("<H", len(mb)) + mb)


class RankReply:
    """One decoded OP_REPLY payload.  ``error`` is ``None`` on success,
    else the RECONSTRUCTED typed exception (``raise_for_status`` throws
    it); ``scores``/``slots`` are the frontend's arrays verbatim."""

    __slots__ = ("request_id", "code", "scores", "slots", "degraded",
                 "error")

    def __init__(self, request_id, code, scores, slots, degraded, error):
        self.request_id = request_id
        self.code = code
        self.scores = scores
        self.slots = slots
        self.degraded = degraded
        self.error = error

    @property
    def ok(self) -> bool:
        return self.code == 0

    def raise_for_status(self) -> None:
        if self.error is not None:
            raise self.error


def _rebuild_error(code: int, message: str, tenant: str | None):
    """Typed exception from an error frame: the taxonomy class for its
    wire code (so remote errors hit the same except-clauses as local
    ones), ``ValueError`` for BAD_REQUEST, ``ServingError`` otherwise."""
    if code == CODE_BAD_REQUEST:
        return ValueError(message)
    name = _CODE_TO_NAME.get(code)
    if name == "RpcProtocolError":
        return RpcProtocolError(message, tenant=tenant)
    if name == "RpcDisconnected":
        return RpcDisconnected(message, tenant=tenant)
    cls = _ERROR_TYPES.get(name) if name is not None else None
    if cls is None:
        return ServingError(message, tenant=tenant)
    err = cls.__new__(cls)                 # subclass ctors vary; bypass
    ServingError.__init__(err, message, tenant=tenant)
    if cls is InjectedFault:
        err.site = None                    # the frame carries prose only
    return err


def decode_reply(payload: bytes) -> RankReply:
    """Parse one OP_REPLY payload; raises ``RpcProtocolError`` on
    malformation."""
    try:
        op, request_id, code = struct.unpack_from("<BIB", payload, 0)
        off = 6
        if op != OP_REPLY:
            raise RpcProtocolError(f"opcode {op:#x} is not OP_REPLY",
                                   tenant=None)
        if code == 0:
            served_k, degraded = struct.unpack_from("<HB", payload, off)
            off += 3
            scores = np.frombuffer(payload, np.float32, served_k, off)
            off += 4 * served_k
            slots = np.frombuffer(payload, np.int32, served_k, off)
            off += 4 * served_k
            if scores.shape[0] != served_k or slots.shape[0] != served_k:
                raise RpcProtocolError("reply arrays truncated",
                                       tenant=None)
            return RankReply(request_id, 0, scores, slots, bool(degraded),
                             None)
        (tlen,) = struct.unpack_from("<B", payload, off)
        off += 1
        tenant = payload[off:off + tlen].decode() or None
        off += tlen
        (mlen,) = struct.unpack_from("<H", payload, off)
        off += 2
        message = payload[off:off + mlen].decode()
    except (struct.error, ValueError, UnicodeDecodeError) as e:
        raise RpcProtocolError(f"malformed reply: {e}", tenant=None) from e
    return RankReply(request_id, code, None, None, False,
                     _rebuild_error(code, message, tenant))


def _peek_request_id(payload: bytes) -> int:
    """Best-effort correlation id from a possibly-garbage payload, so
    even a malformed request's error frame can be matched by the
    caller.  0 when the bytes do not reach."""
    if len(payload) >= 5:
        return struct.unpack_from("<I", payload, 1)[0]
    return 0


# -- the server -----------------------------------------------------------

class _Conn:
    """Per-connection state: the streams, the inflight-slot semaphore
    (backpressure), the reply write lock (frame integrity), and the live
    handler tasks (awaited by the drain)."""

    __slots__ = ("reader", "writer", "sem", "wlock", "tasks", "alive")

    def __init__(self, reader, writer, max_inflight):
        self.reader = reader
        self.writer = writer
        self.sem = asyncio.Semaphore(max_inflight)
        self.wlock = asyncio.Lock()
        self.tasks: set = set()
        self.alive = True


class RpcServer:
    """Asyncio RPC server over one ``QueryFrontend``.

    The frontend MUST be constructed with ``auto_pump=False``: the
    server owns the pump, ticking it (plus ``resolve``) on its executor
    thread every ``pump_interval`` seconds.  ``max_inflight_per_conn``
    bounds pipelining per connection (backpressure via the read loop);
    ``drain_timeout`` bounds how long ``shutdown()`` waits for reply
    writers.  ``fault_injector`` arms the ``rpc_accept``/``rpc_read``/
    ``rpc_write`` sites.

    Lifecycle: ``await start()`` binds and serves (``port`` is then
    live — bind to port 0 for an ephemeral one); ``await shutdown()``
    drains gracefully.  ``serve_in_thread`` wraps both for callers
    without a loop.
    """

    def __init__(self, frontend, *, host: str = "127.0.0.1",
                 port: int = 0, max_inflight_per_conn: int = 32,
                 pump_interval: float = 1e-3, drain_timeout: float = 10.0,
                 fault_injector=None):
        if frontend.auto_pump:
            raise ValueError(
                "RpcServer needs QueryFrontend(auto_pump=False): the "
                "server schedules the pump on its own loop")
        if max_inflight_per_conn < 1:
            raise ValueError(f"max_inflight_per_conn must be >= 1, "
                             f"got {max_inflight_per_conn}")
        self.frontend = frontend
        self.host = host
        self.port = port                   # rebound after start()
        self.max_inflight_per_conn = max_inflight_per_conn
        self.pump_interval = float(pump_interval)
        self.drain_timeout = float(drain_timeout)
        self._injector = fault_injector
        self.stats = {"connections": 0, "requests": 0, "replies": 0,
                      "errors": 0, "protocol_errors": 0, "disconnects": 0,
                      "accept_faults": 0, "read_faults": 0,
                      "write_errors": 0, "tick_errors": 0}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._fe_exec: ThreadPoolExecutor | None = None
        self._tick_task: asyncio.Task | None = None
        self._conns: set[_Conn] = set()
        self._waiters: dict = {}           # PendingQuery -> asyncio.Future
        self._running = False
        self._shutdown_started = False
        self._shutdown_done: asyncio.Event | None = None
        # serve_in_thread plumbing
        self._thread: threading.Thread | None = None
        self._own_loop: asyncio.AbstractEventLoop | None = None

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        """Bind, start serving, and start the pump tick."""
        self._loop = asyncio.get_running_loop()
        self._fe_exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rpc-frontend")
        self._shutdown_done = asyncio.Event()
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._running = True
        self._tick_task = self._loop.create_task(self._tick_loop())

    def install_signal_handlers(self, signums=(signal.SIGTERM,
                                               signal.SIGINT)) -> None:
        """Route SIGTERM/SIGINT to ``shutdown()`` — the graceful-drain
        path — instead of killing the process mid-reply."""
        for signum in signums:
            self._loop.add_signal_handler(
                signum, lambda: asyncio.ensure_future(self.shutdown()))

    async def shutdown(self) -> None:
        """Graceful drain: stop accepting, let the frontend answer every
        accepted request (result or typed error), flush the reply
        writers, then ``frontend.close()``.  Idempotent; concurrent
        callers await the first one.

        Unlike the reference, the listener's ``wait_closed`` comes last:
        since Python 3.12 it waits for every open connection to close, so
        awaited first (as the reference does) it blocks the drain for as
        long as a client keeps its connection open."""
        if self._shutdown_started:
            await self._shutdown_done.wait()
            return
        self._shutdown_started = True
        self._running = False
        self._server.close()
        try:
            # every accepted request resolves (the close() path below
            # answers late-queued stragglers typed; drain answers the
            # rest real)
            await self._fe(self.frontend.drain)
        except Exception:                  # noqa: BLE001 — close() sweeps
            self.stats["tick_errors"] += 1
        try:
            await self._fe(self.frontend.close)
        except Exception:                  # noqa: BLE001 — already closing
            self.stats["tick_errors"] += 1
        self._sweep()
        # every waiter future is now complete, so the handler tasks only
        # have reply frames left to write
        pending = [t for conn in self._conns for t in conn.tasks]
        if pending:
            await asyncio.wait(pending, timeout=self.drain_timeout)
        if self._tick_task is not None:
            self._tick_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._tick_task
        for conn in list(self._conns):
            self._close_conn(conn)
        try:
            await asyncio.wait_for(self._server.wait_closed(), self.drain_timeout)
        except asyncio.TimeoutError:       # a handler still unwinding: counted
            self.stats["disconnects"] += 1
        self._fe_exec.shutdown(wait=False)
        self._shutdown_done.set()

    def stop(self, timeout: float = 30.0) -> None:
        """Thread-safe shutdown for ``serve_in_thread`` servers: drains
        via ``shutdown()`` on the server's loop, then stops and joins
        the loop thread.  A second call does nothing."""
        if self._thread is None:
            raise ValueError("stop() is for serve_in_thread servers; "
                             "await shutdown() on the loop instead")
        if self._loop.is_closed():
            return
        fut = asyncio.run_coroutine_threadsafe(self.shutdown(), self._loop)
        fut.result(timeout=timeout)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=timeout)
        if not self._thread.is_alive():
            self._loop.close()

    # -- the pump tick ----------------------------------------------------

    def _fe(self, fn, *args):
        """Run one frontend call on the dedicated executor thread."""
        return self._loop.run_in_executor(
            self._fe_exec, lambda: fn(*args))

    def _tick_sync(self) -> None:
        """One scheduler turn on the frontend thread: dispatch aged/full
        buckets, then materialize every dispatched batch so the sweep
        can answer its waiters."""
        self.frontend.pump()
        if self.frontend.inflight_depth:
            self.frontend.resolve()

    async def _tick_loop(self) -> None:
        while self._running:
            try:
                await self._fe(self._tick_sync)
            except Exception:              # noqa: BLE001 — tick lost
                # a lost tick is survivable (the next tick redoes the
                # same aged work) but never silent
                self.stats["tick_errors"] += 1
            self._sweep()
            await asyncio.sleep(self.pump_interval)

    def _sweep(self) -> None:
        """Complete the asyncio future of every finished request (runs
        on the loop thread; the waiter map is loop-thread-only)."""
        done = [p for p in self._waiters if p.done()]
        for p in done:
            fut = self._waiters.pop(p)
            if not fut.done():
                fut.set_result(None)

    # -- connection handling ----------------------------------------------

    def _close_conn(self, conn: _Conn) -> None:
        conn.alive = False
        self._conns.discard(conn)
        try:
            conn.writer.close()
        except Exception:                  # noqa: BLE001 — already dead
            self.stats["disconnects"] += 1

    async def _serve_conn(self, reader, writer) -> None:
        if self._injector is not None:
            try:
                self._injector.check("rpc_accept")
            except ServingError:
                # a refused accept: the client sees a clean close; its
                # reconnect lands on a fresh (possibly unarmed) accept
                self.stats["accept_faults"] += 1
                writer.close()
                return
        self.stats["connections"] += 1
        conn = _Conn(reader, writer, self.max_inflight_per_conn)
        self._conns.add(conn)
        try:
            while self._running:
                payload = await self._read_frame(reader)
                if payload is None:
                    break                          # clean EOF
                # backpressure: no new frame is parsed while this
                # connection already has max_inflight_per_conn requests
                # unanswered — the kernel buffer fills, the client blocks
                await conn.sem.acquire()
                op = payload[0]
                if op == OP_RANK:
                    task = self._loop.create_task(
                        self._handle_rank(conn, payload))
                    conn.tasks.add(task)
                    task.add_done_callback(conn.tasks.discard)
                else:
                    self.stats["protocol_errors"] += 1
                    err = RpcProtocolError(f"unknown opcode {op:#x}")
                    await self._send(conn, encode_error_reply(
                        _peek_request_id(payload), err))
                    conn.sem.release()
        except RpcProtocolError:
            # framing is broken (bad length prefix): the stream can no
            # longer be parsed — this connection closes, neighbors live
            self.stats["protocol_errors"] += 1
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self.stats["disconnects"] += 1
        except ServingError:
            # an armed rpc_read fault: treated as the connection dying
            self.stats["read_faults"] += 1
        finally:
            self._close_conn(conn)

    async def _read_frame(self, reader) -> bytes | None:
        """One length-prefixed frame; ``None`` on clean EOF.  Raises
        ``RpcProtocolError`` for unparseable framing (caller closes the
        connection) and ``IncompleteReadError`` for mid-frame death."""
        try:
            head = await reader.readexactly(4)
        except asyncio.IncompleteReadError as e:
            if e.partial:
                raise                      # truncated length prefix
            return None
        if self._injector is not None:
            self._injector.check("rpc_read")
        (n,) = struct.unpack("<I", head)
        if not 1 <= n <= MAX_FRAME:
            raise RpcProtocolError(
                f"declared frame length {n} outside [1, {MAX_FRAME}]")
        return await reader.readexactly(n)

    async def _handle_rank(self, conn: _Conn, payload: bytes) -> None:
        """One request end to end: decode, submit on the frontend
        thread, await the sweep, write the (ok or typed-error) reply."""
        request_id = _peek_request_id(payload)
        try:
            try:
                rq = decode_rank_request(payload)
            except RpcProtocolError as e:
                self.stats["protocol_errors"] += 1
                await self._send(conn,
                                 encode_error_reply(request_id, e))
                return
            request_id = rq.request_id
            self.stats["requests"] += 1
            try:
                pending = await self._fe(self._submit_sync, rq)
            except Exception as e:         # noqa: BLE001 — typed on wire
                self.stats["errors"] += 1
                await self._send(conn, encode_error_reply(request_id, e))
                return
            fut = self._loop.create_future()
            self._waiters[pending] = fut
            await fut
            # done() held before the sweep completed the future, so
            # result() below cannot block
            try:
                scores, slots = pending.result()
            except Exception as e:         # noqa: BLE001 — typed on wire
                self.stats["errors"] += 1
                await self._send(conn, encode_error_reply(request_id, e))
                return
            await self._send(conn, encode_ok_reply(
                request_id, scores, slots, pending.degraded))
            self.stats["replies"] += 1
        except (ConnectionError, OSError, ServingError):
            # the client died (or rpc_write fired) before its reply
            # could land: the REQUEST still resolved above — nothing is
            # stuck in the frontend — only the bytes were undeliverable
            self.stats["write_errors"] += 1
            self._close_conn(conn)
        finally:
            conn.sem.release()

    def _submit_sync(self, rq: RankRequest):
        """Frontend-thread submit: the relative wire deadline becomes an
        absolute frontend-clock deadline HERE (one clock, the
        frontend's)."""
        deadline = (None if rq.deadline_rel is None
                    else self.frontend.clock() + rq.deadline_rel)
        return self.frontend.submit(rq.ctx, rq.w, k=rq.k,
                                    deadline=deadline, tenant=rq.tenant)

    async def _send(self, conn: _Conn, payload: bytes) -> None:
        async with conn.wlock:
            if self._injector is not None:
                self._injector.check("rpc_write")
            conn.writer.write(frame(payload))
            await conn.writer.drain()


def serve_in_thread(frontend, **kwargs) -> RpcServer:
    """Start an ``RpcServer`` on a daemon thread running its own event
    loop; returns once the socket is bound (``server.port`` is live).
    Stop with ``server.stop()``.  The shape tests, benchmarks, and
    ``serve.py --rpc`` use — no asyncio in the caller."""
    server = RpcServer(frontend, **kwargs)
    loop = asyncio.new_event_loop()
    started = threading.Event()
    boot_error: list[BaseException] = []

    def _run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(server.start())
        except BaseException as e:         # noqa: BLE001 — re-raised below
            boot_error.append(e)
            started.set()
            return
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=_run, daemon=True, name="rpc-server")
    thread.start()
    started.wait()
    if boot_error:
        raise boot_error[0]
    server._thread = thread
    server._own_loop = loop
    return server


# -- the client -----------------------------------------------------------

class RpcClient:
    """Blocking client for the wire protocol (tests/benchmarks/demos).

    ``rank()`` is the one-shot call: send, wait for THE reply, raise its
    reconstructed typed error or return ``(scores, slots)``.  For
    pipelining, ``send_rank()`` queues any number of requests and
    ``recv()`` yields replies in ARRIVAL order (out-of-order completion
    is normal); ``recv_for(request_id)`` buffers strays until the wanted
    one lands."""

    def __init__(self, host: str, port: int, *, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = b""
        self._strays: dict[int, RankReply] = {}
        self._next_id = 1

    def send_rank(self, context_ids, context_weights=None, *,
                  k: int = 10, deadline_rel: float | None = None,
                  tenant: str | None = None,
                  request_id: int | None = None) -> int:
        """Send one request (no wait); returns its correlation id."""
        if request_id is None:
            request_id = self._next_id
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF or 1
        self._sock.sendall(frame(encode_rank_request(
            request_id, context_ids, context_weights, k=k,
            deadline_rel=deadline_rel, tenant=tenant)))
        return request_id

    def send_raw(self, data: bytes) -> None:
        """Raw bytes on the socket — the fuzz tests' entry point."""
        self._sock.sendall(data)

    def _read_exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RpcDisconnected("server closed the connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_socket(self) -> RankReply:
        """One reply frame straight off the socket."""
        (n,) = struct.unpack("<I", self._read_exactly(4))
        if not 1 <= n <= MAX_FRAME:
            raise RpcProtocolError(f"server sent frame length {n}")
        return decode_reply(self._read_exactly(n))

    def recv(self) -> RankReply:
        """Next reply: replies ``recv_for`` buffered as strays first,
        then socket arrival order."""
        if self._strays:
            return self._strays.pop(next(iter(self._strays)))
        return self._recv_socket()

    def recv_for(self, request_id: int) -> RankReply:
        """The reply to ONE request, buffering any others that arrive
        first (pipelined replies may complete out of order)."""
        if request_id in self._strays:
            return self._strays.pop(request_id)
        while True:
            reply = self._recv_socket()
            if reply.request_id == request_id:
                return reply
            self._strays[reply.request_id] = reply

    def rank(self, context_ids, context_weights=None, *, k: int = 10,
             deadline_rel: float | None = None,
             tenant: str | None = None):
        """One request, one reply: ``(scores, slots)`` or the raised
        reconstructed typed error."""
        rid = self.send_rank(context_ids, context_weights, k=k,
                             deadline_rel=deadline_rel, tenant=tenant)
        reply = self.recv_for(rid)
        reply.raise_for_status()
        return reply.scores, reply.slots

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
