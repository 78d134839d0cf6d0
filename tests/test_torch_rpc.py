"""The port's RPC server and client on the CPU: the counterparts of the JAX
package's ``tests/test_rpc_protocol.py`` and ``tests/test_rpc_faults.py``
at their smoke size, and the wire held to the reference's byte for byte.

* Codecs round-trip; a socket reply is bitwise the port frontend's direct
  ``submit(...).result()`` of the same request (one request at a time,
  so both are lone rows); pipelined replies correlate by id; garbage in
  a frame answers with a typed error frame, garbage in the framing
  closes that connection only; serving errors cross the wire as their
  class.
* Socket chaos: an armed ``rpc_accept``/``rpc_read``/``rpc_write`` site
  costs one connection; a slow-loris writer or a reconnect flood never
  stalls a neighbour; the breaker trips, sheds and recovers over the
  wire; under a seeded dispatch storm every wire request resolves to an
  ok frame or a typed error frame, survivors bitwise the in-process
  reply (which the reference does not give for a coalesced row under
  JAX 0.9: the reason its
  ``test_dispatch_storm_every_wire_request_resolves_typed`` fails there).
  Every reply is also held bitwise against a lone ``topk`` on its state.
  The reference's ``trace_count`` asserts have no counterpart: nothing
  here is traced.
  Timing does not decide an outcome: the breaker test steps a fake
  clock, and every client has a timeout.
* Against the JAX package: ``encode_rank_request`` and the reply codecs
  give the same bytes in both packages for drawn requests; either
  package's client gets the right replies from the other's server
  serving the same weights; ``WIRE_ERRORS`` and the error classes
  rebuilt from each code agree; and ``WIRE_ERRORS`` covers every
  ``ServingError`` subclass of the port (the analyzer's ERR-WIRE rule)."""
import importlib
import inspect
import pkgutil
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.serving.rpc as jrpc  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.core.fields import uniform_layout as juniform  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.serving import CorpusState as JState  # noqa: E402
from repro.serving import QueryFrontend as JFrontend  # noqa: E402
from repro.serving import ScorerRuntime as JRuntime  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CorpusState,
    DeadlineExceeded,
    Degraded,
    DispatchFailed,
    FaultInjector,
    Overloaded,
    QueryFrontend,
    RpcClient,
    RpcProtocolError,
    ScorerRuntime,
    ServingError,
    serve_in_thread,
)
from repro_torch.serving import rpc  # noqa: E402
from repro_torch.serving.rpc import (  # noqa: E402
    MAX_FRAME,
    WIRE_ERRORS,
    decode_rank_request,
    decode_reply,
    encode_error_reply,
    encode_ok_reply,
    encode_rank_request,
    error_code_of,
    frame,
)

from test_torch_frontend import _base, _ctx  # noqa: E402
from test_torch_parity import assert_topk  # noqa: E402

MAX_K = 8
TIMEOUT = 10.0


def _states(cfg, params, data, tenants, runtime=None):
    runtime = runtime or ScorerRuntime(cfg, device="cpu")
    states = {}
    for i, name in enumerate(tenants):
        q = data.ranking_query(20, 100 + i)
        states[name] = CorpusState(None, q["item_ids"][0], q["item_weights"][0],
                                   capacity=32, runtime=runtime)
        states[name].refresh(params, step=0)
    return states


def assert_reply(reply, state, ctx, k):
    """A reply is bitwise a lone ``state.topk(ctx, k)``."""
    vals, ids = state.topk(np.asarray(ctx).reshape(1, -1), k)
    np.testing.assert_array_equal(reply[0], vals[0].numpy())
    np.testing.assert_array_equal(reply[1], ids[0].numpy())


def _client(server) -> RpcClient:
    return RpcClient("127.0.0.1", server.port, timeout=TIMEOUT)


@pytest.fixture(scope="module")
def stack():
    cfg, params, data = _base()
    states = _states(cfg, params, data, ["a", "b", "c"])
    fe = QueryFrontend(states, max_batch=4, max_k=MAX_K, max_wait=1e-3, auto_pump=False)
    fe.warmup(_ctx(data, 0), tenant="a")
    server = serve_in_thread(fe)
    yield {"fe": fe, "server": server, "data": data, "states": states}
    server.stop(timeout=TIMEOUT)


# -- codecs round-trip ---------------------------------------------------------

def test_request_codec_roundtrip():
    ctx = np.array([3, 1, 4, 1, 5], np.int32)
    w = np.array([0.5, 0.25, 1.0, 2.0, 0.125], np.float32)
    rq = decode_rank_request(encode_rank_request(7, ctx, w, k=5, deadline_rel=0.25,
                                                 tenant="ads-eu"))
    assert rq.request_id == 7 and rq.k == 5 and rq.tenant == "ads-eu"
    assert rq.deadline_rel == 0.25
    np.testing.assert_array_equal(rq.ctx, ctx)
    np.testing.assert_array_equal(rq.w, w)
    rq2 = decode_rank_request(encode_rank_request(8, ctx, k=1))
    assert rq2.tenant is None and rq2.deadline_rel is None and rq2.w is None


def test_reply_codec_roundtrip_ok_and_error():
    scores = np.array([2.5, 1.5, 0.5], np.float32)
    slots = np.array([9, 4, 31], np.int32)
    rep = decode_reply(encode_ok_reply(11, scores, slots, True))
    assert rep.ok and rep.request_id == 11 and rep.degraded
    np.testing.assert_array_equal(rep.scores, scores)
    np.testing.assert_array_equal(rep.slots, slots)
    err = decode_reply(encode_error_reply(12, Overloaded("queue full", tenant="b")))
    assert not err.ok and err.code == WIRE_ERRORS["Overloaded"]
    assert isinstance(err.error, Overloaded) and err.error.tenant == "b"
    with pytest.raises(Overloaded, match="queue full"):
        err.raise_for_status()


def test_error_codes_cover_taxonomy_and_walk_mro():
    class Custom(Overloaded):
        pass

    assert error_code_of(Custom("x")) == WIRE_ERRORS["Overloaded"]
    assert error_code_of(ServingError("x")) == WIRE_ERRORS["ServingError"]
    assert error_code_of(RpcProtocolError("x")) == WIRE_ERRORS["RpcProtocolError"]
    assert error_code_of(ValueError("x")) == rpc.CODE_BAD_REQUEST
    assert error_code_of(KeyError("x")) == rpc.CODE_INTERNAL


# -- live-socket parity and pipelining ------------------------------------------

def test_socket_replies_bitexact_vs_direct_submit(stack):
    fe, data = stack["fe"], stack["data"]
    rng = np.random.default_rng(0)
    with _client(stack["server"]) as cli:
        for s in range(12):
            tenant = ["a", "b", "c"][s % 3]
            k = int(rng.integers(1, MAX_K + 1))
            sc, sl = cli.rank(_ctx(data, s), k=k, tenant=tenant)
            wv, wi = fe.submit(_ctx(data, s), k=k, tenant=tenant).result()
            np.testing.assert_array_equal(sc, wv)
            np.testing.assert_array_equal(sl, wi)
            assert_reply((sc, sl), stack["states"][tenant], _ctx(data, s), k)


def test_pipelined_requests_correlate_out_of_order(stack):
    data = stack["data"]
    with _client(stack["server"]) as cli:
        rids = [cli.send_rank(_ctx(data, s), k=(s % MAX_K) + 1, tenant="b") for s in range(8)]
        for s, rid in reversed(list(enumerate(rids))):
            reply = cli.recv_for(rid)          # strays buffer the rest
            reply.raise_for_status()
            assert reply.request_id == rid
            assert reply.scores.shape == ((s % MAX_K) + 1,)
            assert_reply((reply.scores, reply.slots), stack["states"]["b"], _ctx(data, s),
                         (s % MAX_K) + 1)


# -- typed error frames: requests fail typed, the connection keeps serving --------

def test_bad_request_and_unknown_tenant_answer_typed(stack):
    data = stack["data"]
    with _client(stack["server"]) as cli:
        with pytest.raises(ValueError, match="outside"):
            cli.rank(_ctx(data, 0), k=MAX_K + 50, tenant="a")
        with pytest.raises(ValueError, match="unknown tenant"):
            cli.rank(_ctx(data, 0), k=1, tenant="zzz")
        for bad_id in (50, -1, 2**31 - 1):   # outside the 50-id vocabulary
            ctx = np.array(_ctx(data, 0)).reshape(-1)
            ctx[2] = bad_id
            with pytest.raises(ValueError, match="outside"):
                cli.rank(ctx, k=1, tenant="b")
        sc, _ = cli.rank(_ctx(data, 0), k=2, tenant="a")
        assert sc.shape == (2,)


def test_deadline_crosses_wire_as_taxonomy_class(stack):
    data = stack["data"]
    with _client(stack["server"]) as cli:
        reply = cli.recv_for(cli.send_rank(_ctx(data, 1), k=1, tenant="a",
                                           deadline_rel=1e-9))
        assert isinstance(reply.error, DeadlineExceeded)
        assert reply.error.tenant == "a"
        with pytest.raises(DeadlineExceeded):
            reply.raise_for_status()


def test_unknown_opcode_and_garbage_payload_keep_conn_alive(stack):
    data = stack["data"]
    with _client(stack["server"]) as cli:
        cli.send_raw(frame(bytes([0x7F]) + struct.pack("<I", 501) + b"xx"))
        reply = cli.recv()
        assert isinstance(reply.error, RpcProtocolError) and reply.request_id == 501
        cli.send_raw(frame(bytes([0x01]) + struct.pack("<I", 502) + b"\x01"))
        reply = cli.recv()
        assert isinstance(reply.error, RpcProtocolError) and reply.request_id == 502
        sc, _ = cli.rank(_ctx(data, 2), k=1, tenant="a")
        assert sc.shape == (1,)


# -- stream-level garbage: only the offending connection dies -----------------------

def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def test_oversized_declared_length_closes_only_that_conn(stack):
    data, srv = stack["data"], stack["server"]
    before = srv.stats["protocol_errors"]
    with _client(srv) as neighbor:
        nrid = neighbor.send_rank(_ctx(data, 3), k=3, tenant="b")
        with _client(srv) as bad:
            bad.send_raw(struct.pack("<I", MAX_FRAME + 1) + b"junk")
            with pytest.raises((ConnectionError, RpcProtocolError)):
                bad.recv()                 # the server closed the stream
        reply = neighbor.recv_for(nrid)
        reply.raise_for_status()
        assert reply.scores.shape == (3,)
    assert srv.stats["protocol_errors"] >= before + 1


def test_truncated_prefix_and_midframe_disconnect_spare_neighbors(stack):
    data, srv = stack["data"], stack["server"]
    before = srv.stats["disconnects"]
    with _client(srv) as neighbor:
        nrid = neighbor.send_rank(_ctx(data, 4), k=2, tenant="c")
        t = socket.create_connection(("127.0.0.1", srv.port), timeout=TIMEOUT)
        t.sendall(b"\x10\x00")             # 2 of 4 header bytes, then death
        t.close()
        m = socket.create_connection(("127.0.0.1", srv.port), timeout=TIMEOUT)
        m.sendall(struct.pack("<I", 100) + b"\x01" * 10)   # half a payload
        m.close()
        reply = neighbor.recv_for(nrid)
        reply.raise_for_status()
        assert reply.scores.shape == (2,)
        with _client(srv) as fresh:
            assert fresh.rank(_ctx(data, 5), k=1, tenant="a")[0].shape == (1,)
    assert _wait_for(lambda: srv.stats["disconnects"] >= before + 2)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_fuzzed_frames_never_crash_server(stack, seed):
    data = stack["data"]
    rng = np.random.default_rng(seed)
    with _client(stack["server"]) as cli:
        for _ in range(3):
            cli.send_raw(frame(rng.bytes(int(rng.integers(1, 64)))))
        for _ in range(3):                 # some reply frame for each
            cli.recv()
        sc, _ = cli.rank(_ctx(data, 6), k=1, tenant="a")
        assert sc.shape == (1,)


# -- socket chaos ------------------------------------------------------------------

class StepClock:
    """A fake clock that moves 1 ms a read, so that queued requests age
    past ``max_wait`` without the test sleeping; ``jump`` moves it far."""

    def __init__(self):
        self.t = 0.0
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self.t += 1e-3
            return self.t

    def jump(self, dt: float) -> None:
        with self._lock:
            self.t += dt


@pytest.fixture
def chaos_stack(request):
    servers = []

    def make(*, tenants=("a", "b"), inj=None, **fe_kwargs):
        cfg, params, data = _base()
        states = _states(cfg, params, data, tenants)
        fe_kwargs.setdefault("max_batch", 4)
        fe_kwargs.setdefault("max_wait", 1e-3)
        fe = QueryFrontend(states, max_k=MAX_K, auto_pump=False, fault_injector=inj,
                           **fe_kwargs)
        fe.warmup(_ctx(data, 0), tenant=tenants[0])
        server = serve_in_thread(fe, fault_injector=inj)
        servers.append(server)
        return fe, server, data, states

    yield make
    for server in servers:
        server.stop(timeout=TIMEOUT)


def test_rpc_accept_fault_drops_one_dial_reconnect_lands(chaos_stack):
    inj = FaultInjector(seed=0)
    fe, server, data, _ = chaos_stack(inj=inj)
    inj.arm("rpc_accept", count=1)
    with _client(server) as refused:
        refused.send_rank(_ctx(data, 0), k=2, tenant="a")
        with pytest.raises(ConnectionError):
            refused.recv()
    assert server.stats["accept_faults"] == 1
    with _client(server) as cli:
        assert cli.rank(_ctx(data, 0), k=2, tenant="a")[0].shape == (2,)


def test_rpc_read_fault_kills_conn_neighbor_survives(chaos_stack):
    inj = FaultInjector(seed=0)
    fe, server, data, _ = chaos_stack(inj=inj)
    with _client(server) as neighbor:
        assert neighbor.rank(_ctx(data, 1), k=1, tenant="b")[0].shape == (1,)
        inj.arm("rpc_read", count=1)
        with _client(server) as victim:
            victim.send_rank(_ctx(data, 0), k=2, tenant="a")
            with pytest.raises(ConnectionError):
                victim.recv()              # the connection died at the read probe
        assert server.stats["read_faults"] == 1
        assert neighbor.rank(_ctx(data, 2), k=3, tenant="a")[0].shape == (3,)


def test_rpc_write_fault_request_resolves_only_bytes_lost(chaos_stack):
    inj = FaultInjector(seed=0)
    fe, server, data, _ = chaos_stack(inj=inj)
    completed = fe.stats["completed"]
    inj.arm("rpc_write", count=1)
    with _client(server) as victim:
        victim.send_rank(_ctx(data, 0), k=2, tenant="a")
        with pytest.raises(ConnectionError):
            victim.recv()                  # the reply write fired the fault
    assert _wait_for(lambda: server.stats["write_errors"] >= 1)
    assert server.stats["write_errors"] == 1
    assert fe.stats["completed"] == completed + 1   # the request resolved
    with _client(server) as cli:
        assert cli.rank(_ctx(data, 1), k=1, tenant="b")[0].shape == (1,)


def test_slow_loris_writer_never_stalls_neighbor(chaos_stack):
    fe, server, data, states = chaos_stack()
    loris = socket.create_connection(("127.0.0.1", server.port), timeout=TIMEOUT)
    stop = threading.Event()

    def dribble():
        # a declared 200-byte frame fed one byte every 25 ms
        loris.sendall(struct.pack("<I", 200))
        for _ in range(200):
            if stop.is_set():
                return
            loris.sendall(b"\x01")
            time.sleep(0.025)

    t = threading.Thread(target=dribble, daemon=True)
    t.start()
    try:
        with _client(server) as cli:
            for s in range(20):
                k = (s % MAX_K) + 1
                reply = cli.rank(_ctx(data, s), k=k, tenant=["a", "b"][s % 2])
                assert_reply(reply, states[["a", "b"][s % 2]], _ctx(data, s), k)
            assert t.is_alive()            # the loris is still on its first frame
    finally:
        stop.set()
        loris.close()
        t.join(timeout=TIMEOUT)


def test_reconnect_flood_every_dial_served(chaos_stack):
    fe, server, data, _ = chaos_stack()
    for i in range(30):
        with _client(server) as cli:
            sc, _ = cli.rank(_ctx(data, i), k=(i % MAX_K) + 1, tenant=["a", "b"][i % 2])
            assert sc.shape == ((i % MAX_K) + 1,)
    assert server.stats["connections"] >= 30


def test_breaker_trips_sheds_and_recovers_over_the_wire(chaos_stack):
    inj = FaultInjector(seed=0)
    clock = StepClock()
    fe, server, data, states = chaos_stack(inj=inj, retries=0, retry_backoff=0.0,
                                           breaker_threshold=2, breaker_cooldown=1e6,
                                           clock=clock)
    with _client(server) as cli:
        inj.arm("dispatch")
        for s in range(2):                 # two exhausted dispatches: trip
            reply = cli.recv_for(cli.send_rank(_ctx(data, s), k=2, tenant="a"))
            assert isinstance(reply.error, DispatchFailed)
        assert fe.health()["tenants"]["a"]["breaker"] == "open"
        reply = cli.recv_for(cli.send_rank(_ctx(data, 2), k=2, tenant="a"))
        assert isinstance(reply.error, Degraded) and reply.error.tenant == "a"
        inj.clear()
        assert cli.rank(_ctx(data, 3), k=2, tenant="b")[0].shape == (2,)
        clock.jump(2e6)                    # the cooldown passes: a half-open probe
        reply = cli.rank(_ctx(data, 4), k=2, tenant="a")
        assert_reply(reply, states["a"], _ctx(data, 4), 2)
        assert fe.health()["tenants"]["a"]["breaker"] == "closed"
        assert fe.lane_stats("a")["trips"] == 1


def test_dispatch_storm_every_wire_request_resolves_typed(chaos_stack):
    inj = FaultInjector(seed=7)
    fe, server, data, states = chaos_stack(inj=inj, retries=1, retry_backoff=1e-4)
    rng = np.random.default_rng(7)
    n = 60
    reqs = [(s, int(rng.integers(1, MAX_K + 1)), ["a", "b"][s % 2]) for s in range(n)]
    # rate 0.5 with one retry: a batch fails typed at p = 0.25
    inj.arm("dispatch", rate=0.5)
    replies = {}
    with _client(server) as cli:
        rids = {cli.send_rank(_ctx(data, s), k=k, tenant=t): s for s, k, t in reqs}
        for rid, s in rids.items():
            replies[s] = cli.recv_for(rid)
    inj.clear()
    ok = sum(1 for r in replies.values() if r.ok)
    typed = sum(1 for r in replies.values() if not r.ok and isinstance(r.error, ServingError))
    assert ok + typed == n                 # nothing dropped, nothing untyped
    assert typed > 0 and ok > 0
    for s, k, t in reqs:                   # survivors: the fault-free in-process reply
        if replies[s].ok:
            wv, wi = fe.submit(_ctx(data, s), k=k, tenant=t).result()
            np.testing.assert_array_equal(replies[s].scores, wv)
            np.testing.assert_array_equal(replies[s].slots, wi)
            assert_reply((replies[s].scores, replies[s].slots), states[t], _ctx(data, s), k)


def test_unparseable_frame_during_storm_is_isolated(chaos_stack):
    inj = FaultInjector(seed=3)
    fe, server, data, _ = chaos_stack(inj=inj, retries=1, retry_backoff=1e-4)
    inj.arm("dispatch", rate=0.2)
    with _client(server) as cli:
        rids = [cli.send_rank(_ctx(data, s), k=2, tenant="a") for s in range(10)]
        bad = socket.create_connection(("127.0.0.1", server.port), timeout=TIMEOUT)
        bad.sendall(struct.pack("<I", 0))  # a zero-length frame
        bad.close()
        for rid in rids:
            reply = cli.recv_for(rid)
            assert reply.ok or isinstance(reply.error, ServingError)
    assert _wait_for(lambda: server.stats["protocol_errors"] >= 1)


def test_shutdown_drains_every_accepted_request(chaos_stack):
    fe, server, data, states = chaos_stack(max_wait=1e9)   # nothing ages: stays queued
    cli = _client(server)
    try:
        rids = [cli.send_rank(_ctx(data, s), k=2, tenant="a") for s in range(3)]
        assert _wait_for(lambda: server.stats["requests"] == 3)
        server.stop(timeout=TIMEOUT)       # the drain answers them all
        for s, rid in enumerate(rids):
            reply = cli.recv_for(rid)
            assert reply.ok
            assert_reply((reply.scores, reply.slots), states["a"], _ctx(data, s), 2)
    finally:
        cli.close()
    assert fe.health()["closed"] and server.stats["replies"] == 3


# -- against the JAX package ---------------------------------------------------------

def _draw_request(rng):
    n_ctx = int(rng.integers(1, 40))
    tenant = (None if rng.random() < 0.3 else
              "".join(rng.choice(list("abcxyz-_0123é"), int(rng.integers(1, 20)))))
    return dict(request_id=int(rng.integers(0, 2**32)),
                context_ids=rng.integers(-2**31, 2**31, n_ctx).astype(np.int32),
                context_weights=(None if rng.random() < 0.5
                                 else rng.standard_normal(n_ctx).astype(np.float32)),
                k=int(rng.integers(0, 2**16)),
                deadline_rel=None if rng.random() < 0.4 else float(rng.random() * 10),
                tenant=tenant)


def _errors(mod):
    """One instance of each wire-coded error class of a package, plus a
    caller bug and an unclassifiable error."""
    e = mod.__dict__
    made = [e["RpcProtocolError"]("bad frame", tenant="t1"),
            e["RpcDisconnected"]("gone", tenant=None), ValueError("caller bug"),
            KeyError("server bug")]
    for name in ("Overloaded", "DeadlineExceeded", "Unservable", "NotReady", "Degraded",
                 "ServingError"):
        made.append(e[name](f"{name} happened", tenant="ads-eu"))
    made.append(e["DispatchFailed"]("dispatch", tenant="x", attempts=3))
    made.append(e["RefreshFailed"]("bad push", tenant=None, step=4))
    made.append(e["InjectedFault"]("dispatch"))
    return made


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_codecs_give_the_same_bytes_in_both_packages(seed):
    rng = np.random.default_rng(seed)
    rq = _draw_request(rng)
    kw = dict(rq)
    rid, ctx, w = kw.pop("request_id"), kw.pop("context_ids"), kw.pop("context_weights")
    got = encode_rank_request(rid, ctx, w, **kw)
    assert got == jrpc.encode_rank_request(rid, ctx, w, **kw)
    for decode in (decode_rank_request, jrpc.decode_rank_request):
        d = decode(got)
        assert (d.request_id, d.tenant, d.k) == (rid, rq["tenant"], rq["k"])
        np.testing.assert_array_equal(d.ctx, ctx)
    kk = int(rng.integers(0, 50))
    scores = rng.standard_normal(kk).astype(np.float32)
    slots = rng.integers(0, 2**31, kk).astype(np.int32)
    degraded = bool(rng.random() < 0.5)
    ok = encode_ok_reply(rid, scores, slots, degraded)
    assert ok == jrpc.encode_ok_reply(rid, scores, slots, degraded)
    for decode in (decode_reply, jrpc.decode_reply):
        r = decode(ok)
        assert r.ok and r.degraded == degraded
        np.testing.assert_array_equal(r.scores, scores)
        np.testing.assert_array_equal(r.slots, slots)
    for mine, theirs in zip(_errors(rpc), _errors(jrpc)):
        assert encode_error_reply(rid, mine) == jrpc.encode_error_reply(rid, theirs)


def test_wire_tables_and_rebuilt_errors_agree():
    assert WIRE_ERRORS == jrpc.WIRE_ERRORS
    for name in ("MAX_FRAME", "OP_RANK", "OP_REPLY", "CODE_BAD_REQUEST", "CODE_INTERNAL"):
        assert getattr(rpc, name) == getattr(jrpc, name)
    for code in [*WIRE_ERRORS.values(), rpc.CODE_BAD_REQUEST, rpc.CODE_INTERNAL, 55]:
        payload = rpc.encode_error_reply(9, ServingError("m", tenant="t"))
        payload = payload[:5] + bytes([code]) + payload[6:]
        mine, theirs = decode_reply(payload).error, jrpc.decode_reply(payload).error
        assert type(mine).__name__ == type(theirs).__name__
        assert str(mine) == str(theirs) == "m"
        assert getattr(mine, "tenant", None) == getattr(theirs, "tenant", None)
        if code in WIRE_ERRORS.values():
            assert isinstance(mine, ServingError)
            assert type(mine) is getattr(tserving.rpc, type(mine).__name__, None) or \
                type(mine) is getattr(tserving, type(mine).__name__)


def _serving_error_classes():
    """Every ServingError subclass defined in a module of the port's
    ``serving`` package (the ERR-WIRE closure)."""
    found = {}
    for info in pkgutil.iter_modules(tserving.__path__, "repro_torch.serving."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if (inspect.isclass(obj) and issubclass(obj, ServingError)
                    and obj.__module__ == info.name):
                found[obj.__name__] = obj
    return found


def test_wire_errors_cover_every_serving_error_of_the_port():
    classes = _serving_error_classes()
    assert {"ServingError", "Overloaded", "InjectedFault", "RpcDisconnected"} <= set(classes)
    missing = set(classes) - set(WIRE_ERRORS)
    assert not missing, f"WIRE_ERRORS lacks {sorted(missing)}: they would cross untyped"


def _cross_stacks():
    """The same weights and corpora served by both packages: (data, port
    frontend, JAX frontend, JAX states)."""
    jcfg = jfwfm.FwFMConfig(layout=juniform(5, 4, 50), embed_dim=8, interaction="dplr",
                            rank=2)
    jp = jfwfm.init(jax.random.PRNGKey(4), jcfg)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    tcfg, _, data = _base()
    names = ["a", "b"]
    tstates = _states(tcfg, tp, data, names)
    jrt = JRuntime(jcfg)
    jstates = {}
    for i, name in enumerate(names):
        q = data.ranking_query(20, 100 + i)
        jstates[name] = JState(jcfg, q["item_ids"][0], q["item_weights"][0], capacity=32,
                               runtime=jrt)
        jstates[name].refresh(jp, step=0)
    kw = dict(max_batch=4, max_k=MAX_K, max_wait=1e-3, auto_pump=False)
    return data, QueryFrontend(tstates, **kw), JFrontend(jstates, **kw), jstates


def test_each_package_client_talks_to_the_other_server():
    data, tfe, jfe, jstates = _cross_stacks()
    tserver = serve_in_thread(tfe)
    jserver = jrpc.serve_in_thread(jfe)
    try:
        rng = np.random.default_rng(3)
        reqs = [(s, int(rng.integers(1, MAX_K + 1)), ["a", "b"][s % 2]) for s in range(16)]
        with jrpc.RpcClient("127.0.0.1", tserver.port, timeout=TIMEOUT) as jcli, \
                RpcClient("127.0.0.1", jserver.port, timeout=TIMEOUT) as tcli:
            from_port = {s: jcli.recv_for(jcli.send_rank(_ctx(data, s), k=k, tenant=t))
                         for s, k, t in reqs}
            from_jax = {s: tcli.recv_for(tcli.send_rank(_ctx(data, s), k=k, tenant=t))
                        for s, k, t in reqs}
            # typed errors cross both ways as their class
            assert isinstance(jcli.recv_for(jcli.send_rank(_ctx(data, 0), k=1, tenant="a",
                                                           deadline_rel=1e-9)).error,
                              jrpc.__dict__["DeadlineExceeded"])
            assert isinstance(tcli.recv_for(tcli.send_rank(_ctx(data, 0), k=1, tenant="zz")
                                            ).error, ValueError)
        for s, k, t in reqs:
            a, b = from_port[s], from_jax[s]
            assert a.ok and b.ok and a.scores.shape == (k,)
            full = np.asarray(jstates[t].score(np.asarray(_ctx(data, s)).reshape(1, -1)))
            assert_topk(a.scores[None], a.slots[None], b.scores[None], b.slots[None], full)
    finally:
        tserver.stop(timeout=TIMEOUT)
        jserver.stop(timeout=TIMEOUT)
