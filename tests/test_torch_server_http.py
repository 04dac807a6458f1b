"""The port's HTTP server, ported from tests/test_server_http.py, on port 0,
plus its parity with the JAX package's server and client.

HTTP wrapper tests: the v2 request API (per-request options, /metrics)
plus the v1 /predict adaptive-batching compatibility shim."""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.models as M  # noqa: E402
from repro.configs import ensemble as jensemble  # noqa: E402
from repro.core import AllocationMatrix as JAllocationMatrix  # noqa: E402
from repro.core import host_cpus as jhost_cpus  # noqa: E402
from repro.serving.client import EnsembleClient as JEnsembleClient  # noqa: E402
from repro.serving.server import serve as jserve  # noqa: E402
from repro.serving.system import InferenceSystem as JInferenceSystem  # noqa: E402
from repro_torch.configs import ensemble  # noqa: E402
from repro_torch.core import AllocationMatrix, host_cpus  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving.client import EnsembleClient  # noqa: E402
from repro_torch.serving.request_cache import PredictionCache  # noqa: E402
from repro_torch.serving.segments import (DeadlineExceeded,  # noqa: E402
                                          PredictOptions)
from repro_torch.serving.server import serve  # noqa: E402
from repro_torch.serving.system import InferenceSystem  # noqa: E402

SEQ = 16
PORT = None          # bound by the server fixture (port 0: any free port)


def _bridge(p):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


def _start(serve_fn, system, **kw):
    """Serve ``system`` on a free port; returns (httpd, batcher, url)."""
    httpd, batcher = serve_fn(system, port=0, **kw)
    return httpd, batcher, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    global PORT
    cfgs = ensemble("ENS4")[:1]
    jparams = M.init_params(jax.random.PRNGKey(0), jensemble("ENS4")[0])
    devs = host_cpus(1, memory_bytes=8 * 1024 ** 3)
    alloc = AllocationMatrix(devs, [cfgs[0].name], np.array([[8]]))
    system = InferenceSystem(cfgs, [_bridge(jparams)], alloc, segment_size=16,
                             max_seq=SEQ)
    httpd, batcher = serve(system, port=0, max_wait_s=0.02)
    PORT = httpd.server_address[1]
    yield system
    httpd.shutdown()
    batcher.stop()
    system.shutdown()


def _get(path):
    return json.load(urllib.request.urlopen(f"http://127.0.0.1:{PORT}{path}"))


def _post(path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{PORT}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return json.load(urllib.request.urlopen(req))


def test_health(server):
    r = _get("/health")
    assert r["status"] == "ok" and r["workers"] == 1


def test_allocation_endpoint(server):
    r = _get("/allocation")
    assert r["A"] == [[8]]


def test_predict_roundtrip(server):
    x = np.random.default_rng(0).integers(0, 512, (3, SEQ)).tolist()
    r = _post("/predict", {"tokens": x})
    y = np.asarray(r["predictions"])
    assert y.shape == (3, 512)
    assert np.isfinite(y).all()


def test_bad_request(server):
    req = urllib.request.Request(
        f"http://127.0.0.1:{PORT}/predict", data=b'{"tokens": [1,2,3]}',
        headers={"Content-Type": "application/json"})
    try:
        urllib.request.urlopen(req)
        assert False, "should have errored"
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_adaptive_batching_coalesces(server):
    """Concurrent small requests are served within one segment flush."""
    results = {}

    def call(i):
        x = np.random.default_rng(i).integers(0, 512, (2, SEQ)).tolist()
        results[i] = np.asarray(_post("/predict", {"tokens": x})["predictions"])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(results) == 4
    for y in results.values():
        assert y.shape == (2, 512)


# ---- the v2 request API ------------------------------------------------------

def test_v2_predict_roundtrip(server):
    x = np.random.default_rng(20).integers(0, 512, (3, SEQ)).tolist()
    r = _post("/v2/predict", {"tokens": x, "priority": "high",
                              "members": [0], "deadline_ms": 60_000})
    y = np.asarray(r["predictions"])
    assert y.shape == (3, 512) and np.isfinite(y).all()
    # v1 and v2 agree on the same input
    r1 = _post("/predict", {"tokens": x})
    np.testing.assert_allclose(y, np.asarray(r1["predictions"]), atol=1e-5)


def test_v2_deadline_exceeded_is_504(server):
    x = np.zeros((2, SEQ), np.int32).tolist()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post("/v2/predict", {"tokens": x, "deadline_ms": 1e-4})
    assert ei.value.code == 504


def test_v2_bad_options_are_400(server):
    x = np.zeros((1, SEQ), np.int32).tolist()
    for bad in ({"priority": "urgent"}, {"combine": "median"},
                {"members": [7]}, {"cache": "maybe"},
                {"priority": 1.5}, {"members": 7}):   # wrong-typed -> 400 too
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post("/v2/predict", {"tokens": x, **bad})
        assert ei.value.code == 400, bad
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post("/v2/predict", {"tokens": None})
    assert ei.value.code == 400


def test_metrics_endpoint(server):
    x = np.random.default_rng(21).integers(0, 512, (4, SEQ)).tolist()
    _post("/v2/predict", {"tokens": x})
    m = _get("/metrics")
    assert 0 < m["counters"]["padding_efficiency"] <= 1.0
    assert m["counters"]["rows_valid"] > 0
    assert any(k.startswith("queue_depth.") for k in m["gauges"])
    assert "accumulate" in m["stages"]
    # per-class latency percentiles (the hp_p50 SLO view, DESIGN.md §3/§6)
    assert m["latency"]["normal"]["p50_ms"] > 0


def test_http_client_facade(server):
    """EnsembleClient over the HTTP transport: sync, async, options, and a
    client-side cache; metrics() proxies GET /metrics."""
    client = EnsembleClient(url=f"http://127.0.0.1:{PORT}",
                            cache=PredictionCache(capacity=64))
    X = np.random.default_rng(22).integers(0, 512, (3, SEQ)).astype(np.int32)
    y1 = client.predict(X, PredictOptions(priority="high"))
    assert y1.shape == (3, 512)
    h = client.predict_async(X)                 # all rows now cached
    np.testing.assert_allclose(h.result(60.0), y1, atol=1e-6)
    assert client.cache.hits == 3
    with pytest.raises(DeadlineExceeded):
        client.predict(X, PredictOptions(deadline_ms=1e-4, cache="bypass"))
    assert client.metrics()["counters"]["rows_valid"] > 0
    with pytest.raises(ValueError, match="in-process"):
        client.predict_stream(X, lambda *a: None)


# ---- parity with the JAX package's front door --------------------------------

@pytest.fixture(scope="module")
def both_servers():
    """The port's server and the JAX package's, each on ENS4[:2] with the
    same parameters (the JAX package's, bridged), on free ports."""
    jcfgs = jensemble("ENS4")[:2]
    rng = jax.random.PRNGKey(0)
    jparams = [M.init_params(jax.random.fold_in(rng, i), c)
               for i, c in enumerate(jcfgs)]
    A = np.array([[8, 8]])
    tsys = InferenceSystem(
        ensemble("ENS4")[:2], [_bridge(p) for p in jparams],
        AllocationMatrix(host_cpus(1, memory_bytes=8 * 1024 ** 3),
                         [c.name for c in jcfgs], A),
        segment_size=16, max_seq=SEQ)
    jsys = JInferenceSystem(
        jcfgs, jparams,
        JAllocationMatrix(jhost_cpus(1, memory_bytes=8 * 1024 ** 3),
                          [c.name for c in jcfgs], A),
        segment_size=16, max_seq=SEQ)
    up = [_start(serve, tsys), _start(jserve, jsys)]
    yield up[0][2], up[1][2]
    for (httpd, batcher, _), system in zip(up, (tsys, jsys)):
        httpd.shutdown()
        batcher.stop()
        system.shutdown()


def _X(n, seed):
    return np.random.default_rng(seed).integers(0, 512, (n, SEQ)
                                                ).astype(np.int32)


@pytest.mark.parametrize("path", ["/v2/predict", "/predict"])
def test_port_and_jax_servers_answer_alike(both_servers, path):
    """The same X over HTTP to both servers: tests/test_serving.py's atol."""
    torch_url, jax_url = both_servers
    X = _X(5, seed=31).tolist()
    answers = []
    for url in (torch_url, jax_url):
        req = urllib.request.Request(
            url + path, data=json.dumps({"tokens": X}).encode(),
            headers={"Content-Type": "application/json"})
        answers.append(np.asarray(json.load(urllib.request.urlopen(req))
                                  ["predictions"], np.float32))
    assert answers[0].shape == (5, 512)
    np.testing.assert_allclose(answers[0], answers[1], atol=2e-5)


@pytest.mark.parametrize("client_of", ["jax_client_torch_server",
                                       "torch_client_jax_server"])
def test_clients_talk_across_packages(both_servers, client_of):
    """Either package's EnsembleClient speaks the other's wire format:
    options, typed 504s and /metrics included."""
    torch_url, jax_url = both_servers
    if client_of == "jax_client_torch_server":
        from repro.serving.segments import DeadlineExceeded as Deadline
        from repro.serving.segments import PredictOptions as Options
        client, ref = JEnsembleClient(url=torch_url), EnsembleClient(
            url=jax_url)
    else:
        Deadline, Options = DeadlineExceeded, PredictOptions
        client, ref = EnsembleClient(url=jax_url), JEnsembleClient(
            url=torch_url)
    X = _X(3, seed=32)
    y = client.predict(X, Options(members=[0], priority="high"))
    y_ref = ref.predict(X, type(ref.default_options)(members=[0],
                                                      priority="high"))
    assert y.shape == (3, 512) and y.dtype == np.float32
    np.testing.assert_allclose(y, y_ref, atol=2e-5)
    with pytest.raises(Deadline):
        client.predict(X, Options(deadline_ms=1e-4))
    assert client.metrics()["counters"]["rows_valid"] > 0


def test_launcher_serves_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.serve --cpu`` with the controller and
    brownout on: it prints the port it bound, answers a request, shows the
    health gauges and both control sections in /metrics, and exits 0."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--cpu",
         "--ensemble", "ENS4", "--members", "2", "--cells", "2",
         "--bench", "analytic", "--port", "0", "--duration", "15",
         "--reconfig", "--brownout"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=tmp_path, env={**os.environ,
                           "PYTHONPATH": os.path.join(root, "src")})
    try:
        url, lines = None, []
        deadline = time.monotonic() + 240
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving "):
                url = line.split(" on ", 1)[1].split()[0]
        assert url and not url.endswith(":0"), "".join(lines)
        client = EnsembleClient(url=url)
        X = np.random.default_rng(3).integers(0, 512, (4, SEQ))
        Y = client.predict(X)
        assert Y.shape == (4, 512) and np.isfinite(Y).all()
        m = client.metrics()
        assert any(k.startswith("health.") for k in m["gauges"])
        assert m["controller"]["counters"] is not None
        assert m["brownout"] is not None
        assert proc.wait(timeout=120) == 0, proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
