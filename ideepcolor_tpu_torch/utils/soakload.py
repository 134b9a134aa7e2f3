"""Mixed-traffic soak-load generator for the HTTP server
(``apps/serve.py``).

The request mix, coordinate hashing, per-client session warm-up and
reconnect handling live here once, so every soak issues exactly the same
traffic; a caller chooses only its client count, duration and mix. Pure
``http.client``: the port's own copy of ``ideepcolor_tpu/utils/soakload.py``.
"""
from __future__ import annotations

import http.client
import json
import threading
import time


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    return -1.0


def _request(cc, kind: str, sid: str, body: bytes, y: int, x: int):
    if kind == "fullres":
        cc.request("POST", "/colorize", body=body)
    elif kind == "netres":
        cc.request("POST", "/colorize?fullres=0", body=body)
    elif kind == "click":
        hints = [{"y": y, "x": x, "ab": [30.0, -40.0], "radius": 3}]
        cc.request("POST", f"/session/click?id={sid}",
                   body=json.dumps(hints).encode())
    elif kind == "suggest":
        cc.request("POST", f"/session/suggest?id={sid}&h={y}&w={x}",
                   body=b"[]")
    else:
        raise ValueError(f"unknown request kind {kind!r}")


def open_warm_session(host, port, body: bytes, warm_kinds=("click",),
                      timeout: float = 600, retries: int = 30):
    """One connection + interactive session, with a warm pass of each
    kind in ``warm_kinds`` — first use compiles programs and lazily
    materializes per-session device state (e.g. the dist planes on the
    first suggest), which must stay out of the RSS/latency window.

    Retries 503-booting/draining (and connection drops) with fresh
    connections so callers can open sessions against a server that is
    still booting or mid-recycle."""
    last = None
    for _ in range(max(retries, 1)):
        try:
            cc = http.client.HTTPConnection(host, port, timeout=timeout)
            cc.request("POST", "/session", body=body)
            r = cc.getresponse()
            payload = r.read()
            if r.status in (429, 503):
                last = r.status
                time.sleep(min(float(r.getheader("Retry-After") or 1), 5))
                continue
            sid = json.loads(payload)["id"]
            for kind in warm_kinds:
                _request(cc, kind, sid, body, 9, 9)
                cc.getresponse().read()
            return cc, sid
        except OSError as e:
            last = e
            time.sleep(1)
    raise RuntimeError(f"could not open a session after {retries} "
                       f"attempts (last: {last})")


def run_clients(host, port, conns, body: bytes, secs: float, mix,
                size: int = 256, timeout: float = 600,
                on_reconnect=None, retry_busy: bool = False,
                counters: dict | None = None):
    """Drive ``len(conns)`` concurrent clients for ``secs`` seconds,
    each cycling the request-kind ``mix``; coordinates hash over the
    valid [3, size-4) range. Returns ``({kind: [latency_s]},
    [error_status])`` — only 2xx responses record a latency; non-2xx
    statuses go to the error list (and, keyed by status, into
    ``counters`` if given).

    retry_busy: treat 429/503 as backpressure (the server sheds or is
    recycling) — honor Retry-After (capped at 5 s) and retry the SAME
    request instead of recording an error. OSError reconnects also retry
    the same request. ``counters`` then carries the shed/drain/reconnect
    evidence: {"429": n, "503": n, "reconnects": n, ...} plus per-kind
    reconnect attribution ("reconnects_click": n, ...) so harness-client
    noise is visibly accounted in the numbers it reports (VERDICT r3
    task 8)."""
    lat = {k: [] for k in dict.fromkeys(mix)}
    errors: list = []
    lock = threading.Lock()
    coord_mod = max(size - 6, 1)
    stop_at = time.time() + secs

    def bump(key):
        if counters is not None:
            with lock:
                counters[key] = counters.get(key, 0) + 1

    def client(ci):
        cc, sid = conns[ci]
        i = 0
        while time.time() < stop_at:
            kind = mix[i % len(mix)]
            y = 3 + (37 * i + 11 * ci) % coord_mod
            x = 3 + (53 * i + 7 * ci) % coord_mod
            try:
                t0 = time.perf_counter()
                _request(cc, kind, sid, body, y, x)
                r = cc.getresponse()
                retry_after = r.getheader("Retry-After")
                r.read()
                dt = time.perf_counter() - t0
                if retry_busy and r.status in (429, 503):
                    bump(str(r.status))
                    time.sleep(min(float(retry_after or 1), 5.0))
                    continue               # same i: retry this request
                with lock:
                    if r.status >= 300:
                        errors.append(r.status)
                    else:
                        lat[kind].append(dt)
                bump(str(r.status))
            except OSError as e:
                bump("reconnects")
                bump(f"reconnects_{kind}")
                if not retry_busy:
                    with lock:
                        errors.append(599)
                if on_reconnect is not None:
                    on_reconnect(ci, e)
                cc = http.client.HTTPConnection(host, port,
                                                timeout=timeout)
                if retry_busy:
                    continue               # retry the same request
            i += 1

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(len(conns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return lat, errors
