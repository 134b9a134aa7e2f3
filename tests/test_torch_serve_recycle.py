"""The port server's bulk backpressure (429), drain (503), boot shedding,
session dump and replay, and the exec-in-place recycle, on the CPU
(``device="cpu"``, Xd=64, the bundled width-0.25 student)."""

import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ideepcolor_tpu_torch.apps import serve
from ideepcolor_tpu_torch.utils.imageio import encode_png

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
KW = dict(size=64, weights=STUDENT, dtype="float32", device="cpu")
HINTS = [{"y": 20, "x": 20, "ab": [25.0, -25.0], "radius": 2}]


def _png64(seed=0) -> bytes:
    return encode_png(np.random.default_rng(seed).integers(
        0, 255, (64, 64, 3), np.uint8))


def _conn(srv, timeout=120):
    host, port = srv.server_address
    return http.client.HTTPConnection(host, port, timeout=timeout)


def _serve_bg(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, "condition not reached"
        time.sleep(0.01)


def test_bulk_cap_sheds_429_with_retry_after():
    srv = _serve_bg(serve.make_server(port=0, max_bulk_backlog=1, **KW))
    svc = srv.RequestHandlerClass.service
    body = _png64()
    try:
        svc.lock.acquire(0)               # hold the device
        results = {}

        def bulk_req(name):
            cc = _conn(srv)
            cc.request("POST", "/colorize", body=body)
            r = cc.getresponse()
            results[name] = (r.status, dict(r.getheaders()), r.read())

        t1 = threading.Thread(target=bulk_req, args=("first",), daemon=True)
        t1.start()
        _wait(lambda: svc.lock.bulk_backlog() == 1)
        t2 = threading.Thread(target=bulk_req, args=("second",),
                              daemon=True)
        t2.start()
        t2.join(10)
        assert results["second"][0] == 429
        assert "Retry-After" in results["second"][1]
        svc.lock.release()
        t1.join(60)
        assert results["first"][0] == 200   # the queued one is served
        c = _conn(srv)
        c.request("GET", "/stats")
        assert json.loads(c.getresponse().read())["shed_429"] == 1
    finally:
        if svc.lock._held:
            svc.lock.release()
        _stop(srv)


def test_draining_sheds_503_and_healthz_reports():
    srv = _serve_bg(serve.make_server(port=0, **KW))
    svc = srv.RequestHandlerClass.service
    try:
        svc.draining = True
        c = _conn(srv)
        c.request("POST", "/colorize?fullres=0", body=_png64())
        r = c.getresponse()
        assert r.status == 503 and r.getheader("Retry-After") is not None
        r.read()
        c2 = _conn(srv)
        c2.request("GET", "/healthz")
        assert json.loads(c2.getresponse().read())["status"] == "draining"
        svc.draining = False
        c3 = _conn(srv)
        c3.request("POST", "/colorize?fullres=0", body=_png64())
        assert c3.getresponse().status == 200
    finally:
        _stop(srv)


def test_sessions_dump_and_replay_same_ids(tmp_path):
    svc = serve.ColorizeService(**KW)
    sid = svc.session_open(_png64())["id"]
    fid = svc.session_open(_png64(1), fast=False)["id"]
    before = svc.session_click(sid, HINTS)
    dump = str(tmp_path / "sessions.npz")
    assert svc.dump_sessions(dump) == 2
    svc2 = serve.ColorizeService(**KW)
    assert svc2.replay_sessions(dump) == 2
    assert set(svc2._sessions) == {sid, fid}
    # identical weights + image + hints: the identical frame
    assert svc2.session_click(sid, HINTS) == before


def test_lazy_replay_restores_on_first_touch(tmp_path):
    svc = serve.ColorizeService(**KW)
    sid = svc.session_open(_png64())["id"]
    frame = svc.session_click(sid, HINTS)
    dump = str(tmp_path / "s.npz")
    n = svc.dump_sessions(dump)
    svc2 = serve.ColorizeService(**KW)
    assert svc2.replay_sessions(dump, lazy=True) == n
    h = svc2.health()
    assert h["sessions"] == 0 and h["pending_sessions"] == n
    dump2 = str(tmp_path / "s2.npz")       # a second recycle before a touch
    assert svc2.dump_sessions(dump2) == n
    assert svc2.session_click(sid, HINTS) == frame
    h = svc2.health()
    assert h["pending_sessions"] == n - 1 and h["sessions"] == 1
    svc3 = serve.ColorizeService(**KW)
    svc3.replay_sessions(dump2, lazy=True)
    assert svc3.session_close(sid) is True
    assert svc3.health()["pending_sessions"] == n - 1


def test_parked_sessions_capped_across_dumps(tmp_path):
    svc = serve.ColorizeService(**KW)
    cap = serve.ColorizeService.MAX_SESSIONS
    img = np.zeros((64, 64, 3), np.uint8)
    for i in range(cap + 4):
        svc._pending_sessions[f"ghost{i:02d}"] = (img, False)
    live = [svc.session_open(_png64(i))["id"] for i in range(3)]
    dump = str(tmp_path / "s.npz")
    assert svc.dump_sessions(dump) == cap
    svc2 = serve.ColorizeService(**KW)
    svc2.replay_sessions(dump, lazy=True)
    parked = set(svc2._pending_sessions)
    assert all(sid in parked for sid in live)
    assert "ghost00" not in parked and f"ghost{cap + 3:02d}" in parked


def test_metrics_prometheus_endpoint():
    srv = _serve_bg(serve.make_server(port=0, **KW))
    try:
        c = _conn(srv)
        c.request("POST", "/colorize?fullres=0", body=_png64())
        assert c.getresponse().read()
        c.request("GET", "/metrics")
        r = c.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type").startswith("text/plain")
        body = r.read().decode()
        assert "ideepcolor_requests_total 1" in body
        for name in ("# TYPE ideepcolor_pending_sessions gauge",
                     "# TYPE ideepcolor_bulk_backlog gauge",
                     "# TYPE ideepcolor_recycle_generation gauge",
                     'ideepcolor_stage_latency_ms{stage="',
                     "ideepcolor_stage_latency_ms_sum{",
                     "ideepcolor_stage_latency_ms_count{",
                     "ideepcolor_rss_mb"):
            assert name in body, name
        assert body.endswith("\n")
    finally:
        _stop(srv)


def test_booting_listener_sheds_503_until_service_attached():
    srv = _serve_bg(serve.make_listening_server(port=0))
    try:
        c = _conn(srv, timeout=10)
        t0 = time.time()
        c.request("POST", "/colorize?fullres=0", body=_png64())
        r = c.getresponse()
        body = r.read()
        assert r.status == 503 and r.getheader("Retry-After")
        assert time.time() - t0 < 5 and b"booting" in body
        c2 = _conn(srv, timeout=10)
        c2.request("GET", "/healthz")
        r2 = c2.getresponse()
        h = json.loads(r2.read())
        assert r2.status == 200 and h["status"] == "booting"
        c3 = _conn(srv, timeout=10)
        c3.request("DELETE", "/session?id=x")
        assert c3.getresponse().status == 503
        serve.attach_service(srv, serve.ColorizeService(**KW))
        c4 = _conn(srv)
        c4.request("POST", "/colorize?fullres=0", body=_png64())
        assert c4.getresponse().status == 200
        c5 = _conn(srv)
        c5.request("GET", "/healthz")
        assert json.loads(c5.getresponse().read())["status"] == "ok"
    finally:
        _stop(srv)


def test_boot_stages_surface_in_health_and_release_is_a_noop_on_cpu():
    svc = serve.ColorizeService(**KW)
    svc.boot_stages = {"accept_open_s": 0.1, "ready_s": 2.5}
    assert svc.health()["boot_stages"]["ready_s"] == 2.5
    sid = svc.session_open(_png64())["id"]
    svc.release_device()                  # nothing cached on the CPU
    assert sid in svc._sessions


def test_mesh_flag_is_refused(monkeypatch):
    """``--mesh`` is no longer refused: main hands it to the service as
    ``use_mesh`` (the service is stopped there; the mesh itself is held in
    tests/test_torch_batch_mesh.py)."""
    seen = {}

    class Stop(Exception):
        pass

    def service(**kw):
        seen.update(kw)
        raise Stop

    class Listener:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

    monkeypatch.setattr(serve, "make_listening_server",
                        lambda port, host: Listener())
    monkeypatch.setattr(serve, "ColorizeService", service)
    with pytest.raises(Stop):
        serve.main(["--mesh", "--device", "cpu", "--port", "0"])
    assert seen["use_mesh"] is True and seen["device"] == "cpu"


def _wait_health(port, timeout=120, want_gen=None):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            c.request("GET", "/healthz")
            h = json.loads(c.getresponse().read())
            last = h
            if h.get("status") != "booting" and (
                    want_gen is None or h.get("recycle_gen", 0) >= want_gen):
                return h
        except OSError:
            pass
        time.sleep(0.3)
    raise TimeoutError(f"healthz gen {want_gen} not reached; last {last}")


def test_exec_recycle_preserves_port_and_sessions():
    """``--device cpu`` server whose 1 MB cap lies below its baseline RSS:
    the guard recycles (exec in place) as soon as two requests are served;
    the port stays bound, recycle_gen grows, and a session opened before
    the recycle serves the same frame after it."""
    env = dict(os.environ, IDEEPCOLOR_RECYCLE_POLL_S="0.3",
               IDEEPCOLOR_RECYCLE_MIN_REQUESTS="2", OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ideepcolor_tpu_torch.apps.serve",
         "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
         "--load_size", "64", "--dtype", "float32", "--weights", STUDENT,
         "--student-weights", STUDENT, "--rss-cap-mb", "1"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        deadline = time.time() + 120
        while time.time() < deadline and port is None:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "server never reported its address"
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c.request("POST", "/session", body=_png64())        # request 1
        sid = json.loads(c.getresponse().read())["id"]
        c.request("POST", f"/session/click?id={sid}",       # request 2
                  body=json.dumps(HINTS).encode())
        r = c.getresponse()
        assert r.status == 200
        before = r.read()
        h = _wait_health(port, timeout=120, want_gen=1)
        assert h["sessions"] + h["pending_sessions"] >= 1
        # the 1 MB cap recycles every generation once it has served two
        # requests, so a click may land in a drain or boot window (503):
        # retry as a client would
        deadline = time.time() + 120
        status, after = -1, b""
        while time.time() < deadline:
            try:
                c2 = http.client.HTTPConnection("127.0.0.1", port,
                                                timeout=120)
                c2.request("POST", f"/session/click?id={sid}",
                           body=json.dumps(HINTS).encode())
                r2 = c2.getresponse()
                status, after = r2.status, r2.read()
                if status == 200:
                    break
                assert status == 503, (status, after[:200])
            except OSError:
                pass
            time.sleep(0.3)
        assert status == 200 and after == before
        assert proc.poll() is None          # same process, new image
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
