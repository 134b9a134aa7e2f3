"""The port's HTTP server against the JAX server, on the CPU.

Both servers run in this process on port 0 at Xd=64, f32, on the bundled
width-0.25 student (the fast tier on the width-0.5 one), the port's with
``device="cpu"``. The same requests go to both. Frames are held to the API's
bound (at most 1 LSB on under 1e-3 of a frame's pixels), the global frames
to the Caffe family's (1 LSB on under 5e-3); status codes must be equal.
"""

import http.client
import io
import json
import os
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from ideepcolor_tpu.apps import serve as jserve
from ideepcolor_tpu_torch.api import ColorizeImageTorchDist
from ideepcolor_tpu_torch.apps import serve as tserve
from ideepcolor_tpu_torch.engine import graphs
from ideepcolor_tpu_torch.models import caffe_net as tcaffe
from ideepcolor_tpu_torch.ops.hints import points_json_to_table
from ideepcolor_tpu_torch.utils.imageio import encode_png

from _torch_caffe import jax_params_from_state_dict, smooth_image

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "weights", "student_w025.npz")
FAST = os.path.join(ROOT, "weights", "student_w05.npz")
S = 64
HINTS = [{"y": 30, "x": 30, "ab": [40.0, -50.0], "radius": 2},
         {"y": 0, "x": 63, "ab": [-20.0, 35.0], "radius": 3}]
FRAME_SHARE = 1e-3           # the API's bound
CAFFE_SHARE = 5e-3           # the Caffe family's (tests/test_torch_caffe_api)


def _serve_bg(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def glob_weights(tmp_path_factory):
    """One seeded Caffe global net, in the JAX package's layout, which
    both packages' loaders read."""
    sd = tcaffe.init_state_dict("global", seed=12, calibrate=True)
    path = tmp_path_factory.mktemp("glob") / "global.npz"
    np.savez(path, **jax_params_from_state_dict(sd, "global"))
    return str(path)


@pytest.fixture(scope="module")
def servers(glob_weights):
    kw = dict(port=0, size=S, weights=STUDENT, dtype="float32",
              glob_weights=glob_weights, student_weights=FAST)
    j = _serve_bg(jserve.make_server(**kw))
    t = _serve_bg(tserve.make_server(device="cpu", **kw))
    yield {"jax": j, "port": t}
    for srv in (j, t):
        srv.shutdown()
        srv.server_close()


def _conn(srv):
    host, port = srv.server_address
    return http.client.HTTPConnection(host, port, timeout=300)


def _request(srv, method, path, body=None, headers=None):
    c = _conn(srv)
    c.request(method, path, body=body, headers=headers or {})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, dict(r.getheaders()), data


def _png(seed, h, w):
    img = smooth_image(seed, h, w)
    return img, encode_png(img)


def _decode(png):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(png, np.uint8),
                                     cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _assert_close(got, want, share=FRAME_SHARE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert d.max() <= 1 and np.mean(d != 0) < share, (d.max(),
                                                      np.mean(d != 0))


def _both(servers, method, path, body=None, headers=None):
    """The same request to both servers: (jax reply, port reply)."""
    return (_request(servers["jax"], method, path, body, headers),
            _request(servers["port"], method, path, body, headers))


def test_healthz_keys(servers):
    (js, _, jb), (ts, _, tb) = _both(servers, "GET", "/healthz")
    assert js == ts == 200
    jh, th = json.loads(jb), json.loads(tb)
    assert set(th) == set(jh)
    assert th["device"] == "cpu" and th["size"] == S and th["has_fast"]
    assert th["mesh"] is None and th["status"] == "ok"


@pytest.mark.parametrize("query,hinted", [("", False), ("", True),
                                          ("?fullres=0", True),
                                          ("?model=fast&fullres=0", True),
                                          ("?model=fast", False)])
def test_colorize_matches_jax(servers, query, hinted):
    img, body = _png(3, 80, 96)
    headers = {"X-Hints": json.dumps(HINTS)} if hinted else {}
    (js, _, jb), (ts, th, tb) = _both(servers, "POST", f"/colorize{query}",
                                      body, headers)
    assert js == ts == 200 and th["Content-Type"] == "image/png"
    got, want = _decode(tb), _decode(jb)
    shape = (S, S, 3) if "fullres=0" in query else img.shape
    assert got.shape == shape
    _assert_close(got, want)


def test_colorize_batch_matches_jax(servers):
    """Dense and table forms; the batch engine runs at the JAX package's
    DEFAULT precision (TF32 on the card, f32 on the CPU)."""
    rng = np.random.default_rng(4)
    imgs = np.stack([smooth_image(10 + i, S, S) for i in range(3)])
    boxes = np.zeros((3, 256, 4), np.int32)
    values = np.zeros((3, 256, 2), np.float32)
    counts = np.asarray([0, 1, 2], np.int32)
    boxes[1, 0], values[1, 0] = [20, 20, 24, 24], [40.0, -30.0]
    boxes[2, :2] = [[0, 0, 9, 9], [5, 5, 30, 12]]
    values[2, :2] = rng.uniform(-60, 60, (2, 2))
    for arrays in (dict(images=imgs),
                   dict(images=imgs, boxes=boxes, values=values,
                        counts=counts)):
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        (js, _, jb), (ts, _, tb) = _both(servers, "POST", "/colorize_batch",
                                         buf.getvalue())
        assert js == ts == 200
        with np.load(io.BytesIO(jb)) as zj, np.load(io.BytesIO(tb)) as zt:
            assert zt["frames"].shape == (3, S, S, 3)
            for g, w in zip(zt["frames"], zj["frames"]):
                _assert_close(g, w)


@pytest.mark.parametrize("fullres", [False, True])
def test_colorize_global_matches_jax(servers, fullres):
    img, body = _png(5, 72, 64)
    ref = encode_png(np.broadcast_to(np.array([200, 40, 40], np.uint8),
                                     (48, 40, 3)).copy())
    buf = io.BytesIO()
    np.savez(buf, image=np.frombuffer(body, np.uint8),
             ref=np.frombuffer(ref, np.uint8))
    q = "" if fullres else "?fullres=0"
    (js, _, jb), (ts, _, tb) = _both(servers, "POST", f"/colorize_global{q}",
                                     buf.getvalue())
    assert js == ts == 200
    got = _decode(tb)
    assert got.shape == (img.shape if fullres else (S, S, 3))
    _assert_close(got, _decode(jb), CAFFE_SHARE)


def _open(srv, body, fast=False):
    st, _, data = _request(srv, "POST",
                           "/session" + ("?model=fast" if fast else ""), body)
    assert st == 200, data[:200]
    return json.loads(data)["id"]


def _click(srv, sid, hints, fullres=False):
    q = f"id={sid}" + ("&fullres=1" if fullres else "")
    return _request(srv, "POST", f"/session/click?{q}",
                    json.dumps(hints).encode())


@pytest.mark.parametrize("fast", [False, True])
def test_session_clicks_match_jax(servers, fast):
    """Open, clicks that add hints (table clicks), a full-res click, a
    dense click past MAX_HINTS, close; then the closed id 404s."""
    img, body = _png(6, 90, 70)
    sids = {k: _open(srv, body, fast) for k, srv in servers.items()}
    many = [{"y": i % S, "x": (7 * i) % S, "ab": [float(i % 40), -10.0],
             "radius": 1} for i in range(300)]
    for hints, fullres in (([], False), (HINTS[:1], False), (HINTS, False),
                           (HINTS, True), (many, False)):
        (js, _, jb) = _click(servers["jax"], sids["jax"], hints, fullres)
        (ts, _, tb) = _click(servers["port"], sids["port"], hints, fullres)
        assert js == ts == 200
        got = _decode(tb)
        assert got.shape == (img.shape if fullres else (S, S, 3))
        _assert_close(got, _decode(jb))
    for k, srv in servers.items():
        st, _, _ = _request(srv, "DELETE", f"/session?id={sids[k]}")
        assert st == 200
        assert _click(srv, sids[k], [])[0] == 404


def test_session_suggest_is_the_api_suggest(servers):
    """/session/suggest gives what the port's own dist class gives for the
    same net-size image, table and generator seed."""
    srv = servers["port"]
    svc = srv.RequestHandlerClass.service
    _img, body = _png(7, 64, 64)
    sid = _open(srv, body)
    svc._ensure_dist()._generator.manual_seed(5)
    st, _, data = _request(srv, "POST",
                           f"/session/suggest?id={sid}&h=20&w=33&k=5",
                           json.dumps(HINTS).encode())
    assert st == 200
    got = json.loads(data)
    d = ColorizeImageTorchDist(Xd=S, device="cpu")
    d.prep_net(path=STUDENT)
    d._generator.manual_seed(5)
    d.load_image_array(svc._sessions[sid].img_rgb)
    colors, conf = d.suggest_table(*points_json_to_table(HINTS, S), h=20,
                                   w=33, K=5)
    assert got == {"colors": colors.tolist(),
                   "conf": [float(c) for c in conf]}
    for path, want in ((f"/session/suggest?id={sid}&h=1&w=1&k=0", 400),
                       ("/session/suggest?id=nope&h=1&w=1", 404),
                       (f"/session/suggest?id={sid}&h=64&w=1", 400)):
        assert _request(srv, "POST", path, b"[]")[0] == want, path


def test_suggest_is_the_api_suggest_and_palette_matches_jax(servers):
    """/suggest through the table program equals the dist class's
    suggest_table on the same image and seed; past MAX_HINTS it takes the
    dense forward, get_ab_reccs and _reccs_to_colors, whose palette is
    JAX's on the same centers within 1 LSB."""
    srv = servers["port"]
    svc = srv.RequestHandlerClass.service
    img, body = _png(8, 70, 90)
    dist = svc._ensure_dist()
    ref = ColorizeImageTorchDist(Xd=S, device="cpu")
    ref.prep_net(path=STUDENT)
    ref.load_image_array(img)
    for hints in (HINTS, [HINTS[0]] * 257):
        dist._generator.manual_seed(3)
        st, _, data = _request(srv, "POST", "/suggest?h=40&w=12&k=6", body,
                               {"X-Hints": json.dumps(hints)})
        assert st == 200
        got = json.loads(data)
        ref._generator.manual_seed(3)
        table = points_json_to_table(hints, S)
        if table is not None:
            colors, conf = ref.suggest_table(*table, h=40, w=12, K=6)
            want = {"colors": colors.tolist(),
                    "conf": [float(c) for c in conf]}
        else:
            ab = np.zeros((2, S, S), np.float32)
            mask = np.zeros((1, S, S), np.float32)
            from ideepcolor_tpu_torch.ops.hints import put_points_json
            put_points_json(ab, mask, hints, S)
            ref.net_forward(ab, mask)
            centers, conf = ref.get_ab_reccs(40, 12, K=6, return_conf=True)
            want = svc._reccs_to_colors(ref, centers, conf, 40, 12, 6)
            jwant = jserve.ColorizeService._reccs_to_colors(
                None, ref, centers, conf, 40, 12, 6)
            _assert_close(np.asarray(got["colors"], np.uint8)[None],
                          np.asarray(jwant["colors"], np.uint8)[None], 1.0)
            assert np.allclose(got["conf"], jwant["conf"])
        assert got == want
    assert _request(srv, "POST", "/suggest?h=999&w=0", body)[0] == 400


def test_interleaved_sessions_match_single_session(servers):
    """Clicks on two sessions from parallel threads give each session's
    own frame (the sessions share the click programs)."""
    srv = servers["port"]
    bodies = [_png(20 + i, 64, 64)[1] for i in range(2)]
    sids = [_open(srv, b) for b in bodies]
    want = [_click(srv, sid, HINTS)[2] for sid in sids]
    assert want[0] != want[1]
    got = {0: [], 1: []}

    def worker(i):
        for _ in range(4):
            got[i].append(_click(srv, sids[i], HINTS)[2])

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    for i in (0, 1):
        assert got[i] == [want[i]] * 4


def test_session_lru_eviction_and_closed_session_is_freed():
    import gc
    import weakref
    svc = tserve.ColorizeService(size=S, weights=STUDENT, dtype="float32",
                                 device="cpu")
    svc.MAX_SESSIONS = 2
    a = svc.session_open(_png(30, 64, 64)[1])["id"]
    b = svc.session_open(_png(31, 64, 64)[1])["id"]
    svc.session_click(a, [])          # touch a -> b becomes LRU
    ref = weakref.ref(svc._sessions[b])
    c = svc.session_open(_png(32, 64, 64)[1])["id"]
    assert set(svc._sessions) == {a, c}
    with pytest.raises(LookupError):
        svc.session_click(b, [])
    gc.collect()
    assert ref() is None              # nothing holds an evicted session
    ref = weakref.ref(svc._sessions[a])
    assert svc.session_close(a) and not svc.session_close(a)
    gc.collect()
    assert ref() is None


def test_auto_batch_coalesces_and_matches_single_requests(servers):
    """Six concurrent net-res requests: fewer batched forwards than
    requests, each reply the frame the unbatched server gives alone."""
    srv = _serve_bg(tserve.make_server(port=0, size=S, weights=STUDENT,
                                       dtype="float32", auto_batch=8,
                                       device="cpu"))
    svc = srv.RequestHandlerClass.service
    svc.batcher.wait_s = 0.4
    assert svc.batcher.bucket_caps() == [1, 2, 4, 8]
    _img, body = _png(40, 75, 66)
    hints = [[{"y": 10 + 6 * i, "x": 16, "ab": [60.0 - 20 * i, 18.0 * i],
               "radius": 2}] for i in range(6)]
    outs = [None] * 6

    def one(i):
        outs[i] = _request(srv, "POST", "/colorize?fullres=0", body,
                           {"X-Hints": json.dumps(hints[i])})

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert 1 <= svc.batcher.dispatches < 6
        for i, (st, _, png) in enumerate(outs):
            assert st == 200
            ws, _, want = _request(servers["port"], "POST",
                                   "/colorize?fullres=0", body,
                                   {"X-Hints": json.dumps(hints[i])})
            _assert_close(_decode(png), _decode(want))
        st, _, data = _request(srv, "GET", "/stats")
        stats = json.loads(data)
        assert stats["auto_batch"]["requests"] == 6
        assert stats["auto_batch"]["avg_batch"] > 1.0
        assert tserve.ColorizeService(
            size=S, weights=STUDENT, auto_batch=12,
            device="cpu").batcher.max_batch == 8
    finally:
        srv.shutdown()
        srv.server_close()


BAD = [
    ("POST", "/colorize", b"not an image", None),
    ("POST", "/colorize?fullres=0", b"", {"X-Hints": "not json"}),
    ("POST", "/colorize?fullres=0", None, {"X-Hints": '{"y": 1}'}),
    ("POST", "/colorize?fullres=0", None,
     {"X-Hints": '[{"y": 0, "x": 0, "ab": [1, 2], "radius": 99}]'}),
    ("POST", "/colorize?fullres=0", None, {"X-Hints": '[{"y": 0, "x": 0}]'}),
    ("POST", "/colorize?model=fast&fullres=0", b"\x89PNG\r\n\x1a\nbroken",
     None),
    ("POST", "/colorize_batch", b"junk", None),
    ("POST", "/colorize_global", b"not-an-npz", None),
    ("POST", "/suggest?h=5", None, None),
    ("POST", "/suggest?h=32&w=32&k=26", None, None),
    ("POST", "/session", b"garbage", None),
    ("POST", "/session/click", b"[]", None),
    ("POST", "/session/click?id=zzz", b"[]", None),
    ("POST", "/session/suggest?id=x&h=1", b"[]", None),
    ("POST", "/session/suggest?h=1&w=1", b"[]", None),
    ("DELETE", "/session?id=nope", None, None),
    ("DELETE", "/nope", None, None),
    ("GET", "/nope", None, None),
    ("POST", "/nope", b"", None),
]


@pytest.mark.parametrize("method,path,body,headers", BAD)
def test_bad_requests_get_the_jax_status(servers, method, path, body,
                                         headers):
    if body is None and method == "POST":
        body = _png(50, 64, 64)[1]
    (js, _, jb), (ts, _, tb) = _both(servers, method, path, body, headers)
    assert ts == js and ts >= 400, (ts, js, tb[:200], jb[:200])


def test_oversized_body_is_413(servers):
    for srv in servers.values():
        c = _conn(srv)
        c.putrequest("POST", "/colorize")
        c.putheader("Content-Length", str(600 << 20))
        c.endheaders()
        assert c.getresponse().status == 413


def test_jpeg_without_opencv_is_415(servers, monkeypatch):
    import builtins
    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **k)

    ok, jpg = cv2.imencode(".jpg", smooth_image(1, 64, 64))
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    st, _, data = _request(servers["port"], "POST", "/colorize",
                           jpg.tobytes())
    assert st == 415 and b"cv2" in data


def _metric_names(text):
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def test_metrics_names_and_page_match_jax(servers):
    _img, body = _png(60, 64, 64)
    _both(servers, "POST", "/colorize?fullres=0", body)
    (js, jh, jb), (ts, th, tb) = _both(servers, "GET", "/metrics")
    assert js == ts == 200
    assert th["Content-Type"] == jh["Content-Type"]
    assert _metric_names(tb.decode()) == _metric_names(jb.decode())
    (js, _, jb), (ts, th, tb) = _both(servers, "GET", "/")
    assert js == ts == 200 and tb == jb and "text/html" in th["Content-Type"]
    (js, _, jb), (ts, _, tb) = _both(servers, "GET", "/stats")
    assert set(json.loads(tb)) == set(json.loads(jb))


def test_warmup_captures_nothing_on_the_cpu_and_runs_every_endpoint(
        glob_weights):
    svc = tserve.ColorizeService(size=S, weights=STUDENT, dtype="float32",
                                 auto_batch=2, glob_weights=glob_weights,
                                 student_weights=FAST, device="cpu")
    svc.warmup(suggest=True)
    assert svc._stage is None and not svc._sessions
    for m in (svc.model, svc.model_fast, svc._dist, svc._glob):
        assert m._stage is None
        assert not any(isinstance(v, graphs.GraphProgram)
                       for v in vars(m).values())
    assert set(svc.timer.summary()) >= {
        "colorize_fullres", "fullres_readback", "colorize_batched",
        "suggest",
        "session_open", "session_click", "session_suggest",
        "colorize_global"}
    assert svc.ready_probe().keys() == {
        "probe_cuda_init_s", "probe_first_dispatch_s",
        "probe_program_load_s"}


def test_bf16_service_matches_jax_bf16():
    """The bf16 bound of tests/test_torch_precision.py (port against JAX):
    at most 4 LSB, PSNR at least 50 dB."""
    _img, body = _png(70, 64, 64)
    frames = []
    for svc in (jserve.ColorizeService(size=S, weights=STUDENT),
                tserve.ColorizeService(size=S, weights=STUDENT,
                                       device="cpu")):
        assert svc._dtype == "bfloat16"
        frames.append(_decode(svc.colorize(body, HINTS, fullres=False)))
    want, got = (f.astype(float) for f in frames)
    assert np.abs(got - want).max() <= 4
    assert 10 * np.log10(255 ** 2 / max(np.mean((got - want) ** 2),
                                        1e-12)) >= 50


def test_default_service_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.ColorizeService(size=S)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.make_server(port=0, size=S)


def _spin_until(pred, timeout=5.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("condition not reached")
        time.sleep(0.001)


def test_priority_lock_interactive_jumps_bulk():
    lock = tserve.PriorityLock()
    order = []

    def worker(level, tag):
        lock.acquire(level)
        order.append(tag)
        lock.release()

    lock.acquire(0)
    tb = threading.Thread(target=worker, args=(1, "bulk"))
    tb.start()
    _spin_until(lambda: len(lock._waiters[1]) == 1)
    ti = threading.Thread(target=worker, args=(0, "interactive"))
    ti.start()
    _spin_until(lambda: len(lock._waiters[0]) == 1)
    lock.release()
    tb.join(5)
    ti.join(5)
    assert order == ["interactive", "bulk"]
    assert lock.bulk_jumped == 1


def test_priority_lock_bulk_antistarvation():
    lock = tserve.PriorityLock()
    order = []

    def worker(level, tag):
        lock.acquire(level)
        order.append(tag)
        lock.release()

    n_inter = tserve.PriorityLock.BULK_BOOST + 3
    lock.acquire(0)
    tb = threading.Thread(target=worker, args=(1, "bulk"))
    tb.start()
    _spin_until(lambda: len(lock._waiters[1]) == 1)
    threads = [tb]
    for i in range(n_inter):
        t = threading.Thread(target=worker, args=(0, f"i{i}"))
        t.start()
        _spin_until(lambda k=i: len(lock._waiters[0]) == k + 1)
        threads.append(t)
    lock.release()
    for t in threads:
        t.join(5)
    assert len(order) == n_inter + 1
    assert order.index("bulk") == tserve.PriorityLock.BULK_BOOST
    assert [o for o in order if o != "bulk"] == [f"i{i}"
                                                 for i in range(n_inter)]


def test_priority_lock_plain_mutex_semantics():
    lock = tserve.PriorityLock()
    with pytest.raises(RuntimeError):
        with lock:
            assert lock._held
            raise RuntimeError("boom")
    assert not lock._held
    with lock.bulk():
        assert lock._held
    assert not lock._held


def test_priority_lock_fuzz_no_deadlock_no_lost_wakeup():
    import random
    import sys
    lock = tserve.PriorityLock()
    in_critical, max_seen, done = [0], [0], []
    lk = threading.Lock()

    def worker(ti):
        r = random.Random(100 + ti)
        for _ in range(60):
            with (lock.bulk() if r.random() < 0.3 else lock):
                with lk:
                    in_critical[0] += 1
                    max_seen[0] = max(max_seen[0], in_critical[0])
                if r.random() < 0.1:
                    time.sleep(0.001)
                with lk:
                    in_critical[0] -= 1
        with lk:
            done.append(ti)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(ti,))
                   for ti in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert sorted(done) == list(range(12))
    assert max_seen[0] == 1
    assert not lock._held and not lock._waiters[0] and not lock._waiters[1]


def test_priority_lock_cap_refuses_atomically():
    lock = tserve.PriorityLock()
    lock.acquire(0)
    t = threading.Thread(target=lock.acquire, args=(1,), daemon=True)
    t.start()
    _spin_until(lambda: lock.bulk_backlog() == 1)
    with pytest.raises(tserve.ServerBusy) as ei:
        lock.acquire(1, cap=1)
    assert ei.value.retry_after_s >= 1
    t2 = threading.Thread(target=lock.acquire, args=(1, 2), daemon=True)
    t2.start()
    _spin_until(lambda: lock.bulk_backlog() == 2)
    lock.release()
    t.join(5)
    lock.release()
    t2.join(5)
    lock.release()
    assert lock.bulk_backlog() == 0 and not lock._held
