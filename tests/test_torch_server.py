"""The port's QA server (``inference/server.py``) on the CPU: the server
built from its own command line (``--tiny --mock_vision --device cpu`` on
the toy config) and served in-process on a free localhost port, for
``--engine slots``, ``--engine batch`` and ``slots`` with ``--speculative
--draft_k 3``: ``/healthz``, concurrent requests and their statistics, 400
on missing fields and on a missing image, 404 on an unknown path. One run
of ``python -m vggt_qwen3_tpu_torch.inference.server`` as a process checks
the command line itself; without a card and without ``--device cpu`` the
server raises; ``--quantize w8a8|w4`` and ``--quantize_vision w8a8`` serve.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from vggt_qwen3_tpu_torch.inference import server as pserver
from vggt_qwen3_tpu_torch.ops import kernel_build

REPO = Path(__file__).resolve().parents[1]
FLAGS = ["--config", "configs/toy.yaml", "--tiny", "--mock_vision", "--max_batch", "4", "--max_new_tokens", "8",
         "--prompt_bucket", "32", "--max_wait_ms", "200", "--decode_chunk", "2"]


def _get(port: int, path: str, timeout: float = 10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def _post(port: int, path: str, payload: dict, timeout: float = 120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _toy_image() -> str:
    imgs = sorted((REPO / "data" / "toy" / "images").glob("*.jpg"))
    assert imgs, "toy dataset missing (conftest generates it)"
    return str(imgs[0])


@pytest.fixture(scope="module", params=["slots", "batch", "slots-spec"])
def server(request):
    engine = "slots" if request.param.startswith("slots") else "batch"
    extra = ["--speculative", "--draft_k", "3"] if request.param == "slots-spec" else []
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        args = pserver.parser().parse_args(FLAGS + ["--engine", engine, "--device", "cpu"] + extra)
        service = pserver.build_service(args)
    finally:
        os.chdir(cwd)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), pserver.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield request.param, httpd.server_address[1], service
    httpd.shutdown()
    httpd.server_close()
    service.stop()


def test_healthz(server):
    engine, port, _ = server
    h = _get(port, "/healthz")
    assert h["status"] == "ok" and "requests" in h
    assert ("batches" in h) == (engine == "batch")


def test_concurrent_requests_and_their_stats(server):
    engine, port, service = server
    img = _toy_image()
    before = _get(port, "/healthz")

    def ask(i):
        return _post(port, "/v1/qa", {"question": f"What color is room {i}?", "images": [img],
                                      "max_new_tokens": 4 + i})

    with ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(ask, range(4)))
    assert all(isinstance(r.get("prediction"), str) for r in results), results
    after = _get(port, "/healthz")
    assert after["requests"] - before["requests"] == 4
    if engine == "batch":  # 4 concurrent requests coalesce into fewer batches
        assert after["batches"] - before["batches"] < 4
    else:
        assert after["chunks"] > before["chunks"] and after["tokens"] > before["tokens"]
        # per-request budgets: 4 + 5 + 6 + 7 tokens unless EOS came first
        assert after["tokens"] - before["tokens"] <= 22
        if engine == "slots-spec":
            assert service.engine.speculative or service.engine.stats.spec_disabled_at is not None


def test_missing_fields_is_400(server):
    _, port, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/v1/qa", {"question": "no images"})
    assert e.value.code == 400


def test_bad_image_path_is_400(server):
    _, port, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/v1/qa", {"question": "q", "images": ["/nonexistent/x.jpg"]})
    assert e.value.code == 400


def test_unknown_path_is_404(server):
    _, port, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nope")
    assert e.value.code == 404


def test_server_cli_serves_as_a_process():
    """``python -m vggt_qwen3_tpu_torch.inference.server`` on a free port:
    healthy, answers a request, stops on SIGTERM."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "vggt_qwen3_tpu_torch.inference.server", *FLAGS,
                             "--port", str(port), "--device", "cpu"],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"server died rc={proc.returncode}:\n{proc.stdout.read()[-3000:]}")
            try:
                if _get(port, "/healthz", timeout=2)["status"] == "ok":
                    break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.3)
        r = _post(port, "/v1/qa", {"question": "What is on the table?", "images": [_toy_image()]})
        assert isinstance(r["prediction"], str)
        assert _get(port, "/healthz")["requests"] == 1
    finally:
        proc.terminate()
        proc.wait(timeout=20)


def test_server_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = pserver.parser().parse_args(FLAGS)
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserver.build_service(args)


@pytest.mark.parametrize("flags", [["--quantize", "w8a8"], ["--quantize", "w4"], ["--quantize_vision", "w8a8"]])
def test_quantization_modes_serve(flags):
    """Each of ``--quantize w8a8``, ``--quantize w4`` and ``--quantize_vision
    w8a8`` (with the tiny VGGT tower, not the mock) builds a service whose
    weights are in that mode and answers a request over HTTP."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        base = [f for f in FLAGS if f != "--mock_vision"] if flags[0] == "--quantize_vision" else FLAGS
        service = pserver.build_service(pserver.parser().parse_args(base + ["--device", "cpu"] + flags))
    finally:
        os.chdir(cwd)
    layer = service.params["text"]["layers"]["wq"]
    if flags[0] == "--quantize_vision":
        block = service.params["vision"]["frame_blocks"]["qkv_w"]
        assert "a8" in block and "w8" in layer and "a8" not in layer  # the text weights keep the default w8
    else:
        assert ("a8" in layer) if flags[1] == "w8a8" else ("w4p" in layer)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), pserver.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        r = _post(httpd.server_address[1], "/v1/qa", {"question": "What is on the table?",
                                                      "images": [_toy_image()], "max_new_tokens": 4})
        assert isinstance(r["prediction"], str)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()


def test_kernel_build_builds_a_source_once_across_threads(monkeypatch):
    """HTTP handler threads splice while the engine thread decodes, so two
    threads can reach a first build at once: sixteen threads asking for one
    source (the compile-and-load step replaced by a slow stand-in, the
    interpreter switching threads every microsecond) get one build and the
    same library."""
    calls = []

    def slow_build(todo, defines):
        calls.append(list(todo))
        time.sleep(0.02)
        for n in todo:
            kernel_build._LIBS[n] = object()  # stands for the loaded library

    monkeypatch.setattr(kernel_build, "_build", slow_build)
    monkeypatch.setattr(kernel_build, "_LIBS", {})
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(kernel_build.build(["fake"])[0])) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert calls == [["fake"]] and len(got) == 16 and all(g is got[0] for g in got)
