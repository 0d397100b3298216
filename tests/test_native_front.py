"""Native search-plane front end (native/aitpu_front.cc +
server/native_front.py): wire parity with the Python server, negotiation,
sanitization, errors, deadlines, and concurrency.

The strongest check is byte parity: the SAME MultiIndex serves both the
Python App and the native front, and response BODIES must match exactly —
the native encoder hand-rolls json.dumps' and msgpack.packb's output for
the search response shape (the reference pins wire bytes for the same
reason, /root/reference/src/RemoteCoordinator.zig:402-450)."""

import json
import socket
import threading
import time

import msgpack
import numpy as np
import pytest
import requests

from acoustid_index.multi.multi_index import MultiIndex, SearchRequestParams
from acoustid_index.server.app import App
from acoustid_index.server.http import HttpServer
from acoustid_index.server.native_front import NativeFront
from acoustid_index.utils.native import front_lib

MSGPACK_CT = "application/vnd.msgpack"

pytestmark = pytest.mark.skipif(front_lib() is None, reason="no C++ toolchain")


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    mi = MultiIndex.open(str(tmp_path_factory.mktemp("nf")), checkpoint_age=None)
    mi.create_index("main")
    rng = np.random.default_rng(5)
    hashes = rng.integers(1, 2**32, (300, 20), dtype=np.uint32)
    from acoustid_index.engine.model import Insert

    mi.update(
        "main",
        [Insert(id=i + 1, hashes=hashes[i].tolist()) for i in range(300)],
    )
    app = App(mi)
    py_srv = HttpServer("127.0.0.1", 0, app.router, app.error_response, app.not_found)
    py_srv.serve_background()
    front = NativeFront(mi, 0, pumps=2)
    front.start()
    # Warm the CPU program so deadline tests aren't compile-bound.
    mi.search("main", SearchRequestParams(query=hashes[0].tolist(), timeout=0))
    yield {
        "mi": mi,
        "hashes": hashes,
        "py": f"http://127.0.0.1:{py_srv.port}",
        "native": f"http://127.0.0.1:{front.port}",
        "front": front,
    }
    front.stop()
    py_srv.shutdown()
    mi.close()


def _search_until_ready(url, retry_s=120.0, **kwargs):
    deadline = time.time() + retry_s
    while True:
        r = requests.post(url, **kwargs)
        if r.status_code == 503 and time.time() < deadline:
            time.sleep(0.05)
            continue
        return r


def test_json_byte_parity(stack):
    q = [int(x) for x in stack["hashes"][3]] + [7, 7]  # dups exercise dedup
    body = {"query": q, "limit": 5}
    a = _search_until_ready(stack["native"] + "/main/_search", json=body)
    b = _search_until_ready(stack["py"] + "/main/_search", json=body)
    assert a.status_code == b.status_code == 200
    assert a.headers["Content-Type"] == b.headers["Content-Type"] == "application/json"
    assert a.content == b.content  # byte-for-byte, incl. separators
    assert a.json()["results"][0] == {"id": 4, "score": 20}


def test_msgpack_byte_parity(stack):
    q = [int(x) for x in stack["hashes"][10]]
    raw = msgpack.packb({"q": q, "l": 3})
    kwargs = dict(data=raw, headers={"Content-Type": MSGPACK_CT})
    a = _search_until_ready(stack["native"] + "/main/_search", **kwargs)
    b = _search_until_ready(stack["py"] + "/main/_search", **kwargs)
    assert a.status_code == b.status_code == 200
    assert a.headers["Content-Type"] == b.headers["Content-Type"] == MSGPACK_CT
    assert a.content == b.content
    assert msgpack.unpackb(a.content)["r"][0] == {"i": 11, "s": 20}


def test_negotiation_matrix(stack):
    q = [int(x) for x in stack["hashes"][1]]
    # JSON body + Accept msgpack -> msgpack response.
    r = _search_until_ready(
        stack["native"] + "/main/_search",
        json={"query": q},
        headers={"Accept": MSGPACK_CT},
    )
    assert r.headers["Content-Type"] == MSGPACK_CT
    assert msgpack.unpackb(r.content)["r"][0]["i"] == 2
    # msgpack body + Accept json -> JSON response.
    r = _search_until_ready(
        stack["native"] + "/main/_search",
        data=msgpack.packb({"q": q}),
        headers={"Content-Type": MSGPACK_CT, "Accept": "application/json"},
    )
    assert r.headers["Content-Type"] == "application/json"
    assert r.json()["results"][0]["id"] == 2
    # Bare msgpack body with no headers defaults to msgpack (body present).
    r = _search_until_ready(stack["native"] + "/main/_search", data=msgpack.packb({"q": q}))
    assert r.headers["Content-Type"] == MSGPACK_CT


def test_error_parity(stack):
    cases = [
        # (path, kwargs) -> compare status + body with the Python server
        ("/nosuch/_search", dict(json={"query": [1, 2, 3]})),
        ("/main/_search", dict(json={"limit": 5})),  # missing query
        ("/main/_search", dict(json={"query": "nope"})),  # wrong type
        ("/main/_search", dict(json={"query": [1, -2]})),  # negative hash
        ("/main/_search", dict(json={"query": [1, 2 ** 40]})),  # > u32
        ("/main/_search", dict(json={"query": [1, True]})),  # bool hash
        ("/main/_search", dict(json={"query": [1], "limit": "x"})),  # bad int
        ("/main/_search", dict(data=b"{", headers={"Content-Type": "application/json"})),
        ("/main/_search", dict(data=b'{"query": [-]}', headers={"Content-Type": "application/json"})),
        ("/main/_search", dict(data=b'{"query": [-, 1]}', headers={"Content-Type": "application/json"})),
        # json.loads strictness: trailing garbage, leading zeros, bare exponents.
        ("/main/_search", dict(data=b'{"query": [1]} junk', headers={"Content-Type": "application/json"})),
        ("/main/_search", dict(data=b'{"query": [1]}]', headers={"Content-Type": "application/json"})),
        ("/main/_search", dict(data=b'{"query": [01]}', headers={"Content-Type": "application/json"})),
        ("/main/_search", dict(data=b'{"query": [1], "limit": 1e}', headers={"Content-Type": "application/json"})),
        ("/main/_search", dict(data=b'{"query": [1.]}', headers={"Content-Type": "application/json"})),
        # msgpack.unpackb raises ExtraData on trailing bytes.
        ("/main/_search", dict(data=msgpack.packb({"q": [1]}) + b"x", headers={"Content-Type": MSGPACK_CT})),
        # Negative timeout: an already-expired deadline on both planes.
        ("/main/_search", dict(json={"query": [1, 2, 3], "timeout": -1})),
        ("/main/_search", dict(data=b"\xc1", headers={"Content-Type": MSGPACK_CT})),
        ("/main/_search", dict(data=b"x", headers={"Content-Type": "text/plain"})),
    ]
    for path, kwargs in cases:
        a = requests.post(stack["native"] + path, **kwargs)
        b = requests.post(stack["py"] + path, **kwargs)
        assert a.status_code == b.status_code, (path, kwargs, a.status_code, b.status_code, a.content)
        assert a.content == b.content, (path, kwargs, a.content, b.content)


def test_empty_query_and_defaults(stack):
    r = requests.post(stack["native"] + "/main/_search", json={"query": []})
    assert r.status_code == 200 and r.json() == {"results": []}
    # min_score derives from the RAW query length: 39 noise hashes + 1 real
    # -> ceil(40/20)=2 > score 1, so the single-hash doc match is filtered.
    noise = [int(x) for x in np.arange(10_000_001, 10_000_040, dtype=np.uint32)]
    q = noise + [int(stack["hashes"][0][0])]
    a = _search_until_ready(stack["native"] + "/main/_search", json={"query": q})
    b = _search_until_ready(stack["py"] + "/main/_search", json={"query": q})
    assert a.content == b.content


def test_health_and_keepalive(stack):
    s = requests.Session()
    assert s.get(stack["native"] + "/_health").text == "OK\n"
    q = [int(x) for x in stack["hashes"][7]]
    for _ in range(3):  # same connection, keep-alive
        r = s.post(stack["native"] + "/main/_search", json={"query": q})
        assert r.status_code == 200 and r.json()["results"][0]["id"] == 8
    s.close()


def test_deadline_expired(stack):
    # A 1ms timeout cannot cover even a warm batch round trip reliably; the
    # front must answer 503 SearchTimeout (and NEVER results) when the
    # deadline passes first.  Use many to make at least one expire.
    q = [int(x) for x in stack["hashes"][2]]
    saw_timeout = False
    for _ in range(20):
        r = requests.post(
            stack["native"] + "/main/_search", json={"query": q, "timeout": 1}
        )
        assert r.status_code in (200, 503)
        if r.status_code == 503:
            assert r.json() == {"error": "SearchTimeout"}
            saw_timeout = True
    assert saw_timeout


def test_concurrent_load(stack):
    hashes = stack["hashes"]
    errors = []
    hits = [0]

    def worker(tid):
        try:
            s = requests.Session()
            for i in range(25):
                t = (tid * 25 + i) % 300
                r = s.post(
                    stack["native"] + "/main/_search",
                    json={"query": [int(x) for x in hashes[t]], "timeout": 10000},
                )
                assert r.status_code == 200, r.content
                res = r.json()["results"]
                assert res[0]["id"] == t + 1 and res[0]["score"] == 20
                hits[0] += 1
            s.close()
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors[:2]
    assert hits[0] == 200
    front = stack["front"]
    assert front.stat(1) >= 200  # responded counter moved


def test_process_level_search_plane_and_kill9(tmp_path):
    """The real deployment shape: `main.py --search-port` serves the native
    plane beside the Python control plane in a subprocess; data written via
    the control plane is searchable via the native plane, survives SIGKILL
    + restart, and shuts down cleanly on SIGTERM (exit 0)."""
    from server_fixture import Server

    # --search-port 0 means OFF (like --legacy-port); -1 auto-picks a free
    # port, announced on stdout as SEARCHPLANE <port> (race-free).
    s = Server(tmp_path, extra_args=["--search-port", "-1", "--checkpoint-age-ms", "0"])
    s.start()
    try:
        assert s.search_port, "native plane port not announced"
        nat = f"http://127.0.0.1:{s.search_port}"
        assert requests.get(nat + "/_health", timeout=10).text == "OK\n"
        r = requests.put(s.url("/fp"))
        assert r.status_code == 200, r.text
        hashes = [9 * k + 2 for k in range(1, 30)]
        assert requests.put(s.url("/fp/7"), json={"hashes": hashes}).status_code == 200

        def search_native(retry_s=120.0):
            deadline = time.time() + retry_s
            while True:
                r = requests.post(nat + "/fp/_search", json={"query": hashes, "timeout": 30000})
                if r.status_code == 503 and time.time() < deadline:
                    time.sleep(0.1)
                    continue
                return r

        r = search_native()
        assert r.status_code == 200, r.content
        assert r.json()["results"][0]["id"] == 7

        s.restart(hard=True)  # SIGKILL: WAL recovery path
        assert s.search_port, "native plane port not announced after restart"
        nat = f"http://127.0.0.1:{s.search_port}"
        r = search_native()
        assert r.status_code == 200, r.content
        assert r.json()["results"][0]["id"] == 7

        proc = s.proc
        s.stop()  # SIGTERM
        assert proc.returncode == 0
    finally:
        s.stop()


def test_raw_socket_pipeline_and_close(stack):
    # HTTP/1.0-style connection close and a request with Connection: close.
    port = int(stack["native"].rsplit(":", 1)[1])
    body = json.dumps({"query": [int(x) for x in stack["hashes"][9]]}).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(
            b"POST /main/_search HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\nConnection: close\r\n"
            b"Content-Length: %d\r\n\r\n%s" % (len(body), body)
        )
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    head, _, payload = data.partition(b"\r\n\r\n")
    assert b"200 OK" in head.split(b"\r\n", 1)[0]
    assert b"Connection: close" in head
    assert json.loads(payload)["results"][0]["id"] == 10
