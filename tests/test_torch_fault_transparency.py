"""The faults the port's own lint found in the port when it first ran over
it (``python -m tse1m_tpu_torch lint``), each held here, against the JAX
package's behaviour where both packages have the code:

- the serving plane's handlers (``ServeServer``'s connection handler and
  dispatch, ``RouterServer``'s dispatch), the daemon's ingest loop and the
  flight recorder turned an injected fault into an error answer, a log
  line or a failed batch; the JAX package's re-raise it (``broad-except``);
- ``install_plan``/``clear_plan`` wrote the plan outside the lock the
  first ``active_plan()`` loads the environment's plan under, so an
  explicit install racing that load could be lost
  (``unlocked-shared-state``);
- ``TcpTransport.close`` dropped the socket without the transport's lock,
  under an exchange in flight on it (``unlocked-shared-state``).
"""

from __future__ import annotations

import json
import socket
import sys
import threading

import pytest

from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu.observability import flight as jflight
from tse1m_tpu.resilience import faults as jfaults
from tse1m_tpu.serve import RouterServer as JRouterServer
from tse1m_tpu.serve import ServeDaemon as JDaemon
from tse1m_tpu.serve import ServeServer as JServeServer
from tse1m_tpu_torch.cluster.pipeline import ClusterParams as TParams
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.resilience import faults as tfaults
from tse1m_tpu_torch.serve import RouterServer, ServeDaemon, ServeServer
from tse1m_tpu_torch.serve.router import TcpTransport
from tse1m_tpu_torch.serve.server import read_msg, write_msg

JP = JParams(n_hashes=32, n_bands=4, use_pallas="never")
TP = TParams(n_hashes=32, n_bands=4)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """No plan and the flight directories as found, before and after."""
    monkeypatch.delenv("TSE1M_FAULT_PLAN", raising=False)
    monkeypatch.delenv("TSE1M_LIVE_DELTA_RUNS", raising=False)
    saved = jflight._flight_dir, tflight._flight_dir
    tfaults.clear_plan()
    jfaults.clear_plan()
    yield
    tfaults.clear_plan()
    jfaults.clear_plan()
    jflight._flight_dir, tflight._flight_dir = saved


class _Raising:
    """A stand-in server whose ``_dispatch_op`` raises ``exc``."""

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc

    def _dispatch_op(self, op, msg):
        raise self.exc


PACKAGES = {"torch": (ServeServer, RouterServer, tfaults),
            "jax": (JServeServer, JRouterServer, jfaults)}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("which", ["server", "router"])
def test_dispatch_reraises_an_injected_fault(pkg, which):
    serve_cls, router_cls, faults = PACKAGES[pkg]
    cls = serve_cls if which == "server" else router_cls
    with pytest.raises(faults.InjectedFault, match="boom"):
        cls.dispatch(_Raising(faults.InjectedFault("boom")), {"op": "query"})
    # Any other failure is still a structured error answer.
    resp = cls.dispatch(_Raising(ValueError("bad")), {"op": "query"})
    assert resp == {"ok": False, "error": "ValueError: bad"}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_connection_handler_reraises_an_injected_fault(pkg):
    serve_cls, _, faults = PACKAGES[pkg]
    srv = serve_cls(None, host="127.0.0.1", port=0)
    seen: list = []
    srv.handle_error = lambda request, address: seen.append(
        sys.exc_info()[0])

    def dispatch(msg):
        raise faults.InjectedFault("mid-request")

    srv.dispatch = dispatch
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        with socket.create_connection(("127.0.0.1", srv.server_address[1]),
                                      timeout=10) as sock:
            write_msg(sock, {"op": "ping"})
            with pytest.raises((ConnectionError, OSError)):
                read_msg(sock)  # the handler died: the connection closes
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10)
    assert seen == [faults.InjectedFault]


def _ingest_until_fault(daemon, faults, items) -> list:
    """The first batch meets an injected fault at the commit seat; then a
    second batch is offered.  What each returned or raised."""
    faults.install_plan(faults.FaultPlan([faults.FaultRule(
        site="serve.ingest.commit", kind="raise", times=1)]))
    out = []
    try:
        daemon.ingest(items[:40], timeout=60)
        out.append("acked")
    except faults.InjectedFault:
        out.append("InjectedFault")
    faults.clear_plan()
    try:
        daemon.submit(items[40:80]).wait(60)
        out.append("acked")
    except RuntimeError as e:
        out.append(f"refused: {e}")
    return out


def test_ingest_loop_latches_an_injected_fault(tmp_path):
    """The port's daemon as the JAX package's: the faulted batch fails
    with the fault, the ingest loop latches it and stops (a crash, as a
    real one), so the next batch is refused, and the status says so."""
    items = synth_session_sets(120, set_size=16, seed=4)[0]
    flights = {}
    got = {}
    for pkg, cls, params, faults, flight in (
            ("torch", ServeDaemon, {"params": TP, "device": "cpu"},
             tfaults, tflight),
            ("jax", JDaemon, {"params": JP}, jfaults, jflight)):
        d = cls(str(tmp_path / pkg), **params).start()
        flight.set_flight_dir(str(tmp_path / f"flight_{pkg}"))
        try:
            got[pkg] = _ingest_until_fault(d, faults, items)
            got[pkg].append(d.status()["ok"])
        finally:
            d.stop()
        flights[pkg] = sorted(
            json.loads(p.read_text())["reason"]
            for p in (tmp_path / f"flight_{pkg}").glob("flight_*.json"))
    assert got["torch"] == got["jax"] == [
        "InjectedFault", "refused: serve ingest loop is down", False]
    assert "serve.ingest_crash" in flights["torch"]
    assert "serve.ingest_crash" in flights["jax"]


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_flight_dump_reraises_an_injected_fault(pkg, tmp_path, monkeypatch):
    flight, faults = ((tflight, tfaults) if pkg == "torch"
                      else (jflight, jfaults))
    flight.set_flight_dir(str(tmp_path))

    def snapshot(exc):
        def fn():
            raise exc
        return fn

    monkeypatch.setattr(flight, "metrics_snapshot",
                        snapshot(faults.InjectedFault("in the dump")))
    with pytest.raises(faults.InjectedFault):
        flight.dump_flight("probe")
    # A real failure of the dump still only logs: it must not mask the
    # crash being recorded.
    monkeypatch.setattr(flight, "metrics_snapshot",
                        snapshot(OSError("disk full")))
    assert flight.dump_flight("probe") is None


def test_explicit_install_wins_over_a_racing_env_load(tmp_path,
                                                      monkeypatch):
    """The first ``active_plan()`` loads TSE1M_FAULT_PLAN under the
    module's lock; an ``install_plan`` that lands while it loads must win,
    not be overwritten by the environment's plan."""
    env_plan = tfaults.FaultPlan([tfaults.FaultRule(site="env.only")])
    explicit = tfaults.FaultPlan([tfaults.FaultRule(site="explicit")])
    path = tmp_path / "plan.json"
    env_plan.save(str(path))
    monkeypatch.setenv("TSE1M_FAULT_PLAN", str(path))
    monkeypatch.setattr(tfaults, "_plan", None)
    monkeypatch.setattr(tfaults, "_env_loaded", False)
    loading, release = threading.Event(), threading.Event()
    real = tfaults.FaultPlan.from_json

    def slow_from_json(p):
        loading.set()
        release.wait(10)
        return real(p)

    monkeypatch.setattr(tfaults.FaultPlan, "from_json",
                        staticmethod(slow_from_json))
    loader = threading.Thread(target=tfaults.active_plan, daemon=True)
    loader.start()
    assert loading.wait(10)
    installer = threading.Thread(target=tfaults.install_plan,
                                 args=(explicit,), daemon=True)
    installer.start()
    installer.join(0.3)  # an unlocked install lands here, mid-load
    release.set()
    loader.join(10)
    installer.join(10)
    assert not loader.is_alive() and not installer.is_alive()
    assert tfaults.active_plan() is explicit


class _Sock:
    def __init__(self) -> None:
        self.closed = False

    def close(self) -> None:
        self.closed = True


def test_transport_close_waits_for_the_exchange_in_flight():
    """``close`` takes the transport's lock: the socket an exchange holds
    is closed after it, never under it."""
    t = TcpTransport(port=1)
    sock = _Sock()
    t._sock = sock
    assert t._lock.acquire()  # an exchange in flight holds the lock
    closer = threading.Thread(target=t.close, daemon=True)
    closer.start()
    closer.join(0.3)
    assert closer.is_alive() and not sock.closed and t._sock is sock
    t._lock.release()
    closer.join(10)
    assert not closer.is_alive() and sock.closed and t._sock is None
    t.close()  # closing twice is a no-op
    assert t._sock is None
