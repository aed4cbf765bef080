"""Port parity: the /scd HTTP endpoint (ccv_tpu_torch/serve/server.py, the
twin of serve/server.py's /scd route), on the CPU.

The models directory holds face.sqlite3: tests/data/face_low.sqlite3 with
its last stage's threshold raised to LAST_THRESHOLD, so that 54 of
crop180's 3,581 windows pass before the merge (the threshold sits in a gap
0.025 wide between two windows' sums). The merge is an O(n^2) Python loop
in both packages, so the open thresholds would make each request take
minutes. The served rects must equal ccv_tpu's ``scd.detect`` of the same
image and cascade, conf within 2e-4 + 1e-5 |conf|.
"""

import json
import os
import shutil
import sqlite3
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

from ccv_tpu.core import io as jio
from ccv_tpu.detectors import scd as jscd
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.detectors import icf, sift, swt
from ccv_tpu_torch.serve import server
from test_torch_icf import synth_cascade

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(DATA, "crop180.png")
LAST_THRESHOLD = -4.6630
ENDPOINTS = ["/icf/detect.objects", "/scd/detect.objects", "/sift",
             "/swt/detect.words"]


def pedestrian_cascade(path):
    """test_torch_icf's seeded synthetic cascade (100 trees, colour) written
    to ``path``: every threshold open but the last, which keeps about 3% of
    crop180's windows at default IcfParams."""
    import numpy as np

    casc = icf.cascade_from_jax(synth_cascade(np.random.default_rng(11),
                                              100, False))
    img = tio.read(IMAGE, tio.IO_RGB_COLOR, device="cpu")
    conf = np.sort([c.confidence for c in icf.detect_objects(
        img, casc, icf.IcfParams(min_neighbors=0))])
    i = int(0.97 * len(conf))
    casc.thresholds[-1] = (conf[i] + conf[i + 1]) / 2
    icf.write_cascade(casc, path)


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    pedestrian_cascade(str(d / "pedestrian.icf"))
    path = str(d / "face.sqlite3")
    shutil.copy(os.path.join(DATA, "face_low.sqlite3"), path)
    con = sqlite3.connect(path)
    try:
        n = con.execute("SELECT MAX(classifier) FROM classifier_params"
                        ).fetchone()[0]
        con.execute("UPDATE classifier_params SET threshold = ? WHERE "
                    "classifier = ?", (LAST_THRESHOLD, n))
        con.commit()
    finally:
        con.close()
    return str(d)


@pytest.fixture(scope="module")
def url(models_dir):
    """A server on the CPU in a thread, torch pinned to one intra-op thread
    while it runs (several test workers share the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    srv = server.Server(("127.0.0.1", 0), models_dir, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
        torch.set_num_threads(threads)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def want(models_dir):
    img = jio.read(IMAGE, jio.IO_RGB_COLOR)
    cascade = jscd.load_cascade(os.path.join(models_dir, "face.sqlite3"))
    before = jscd.detect(img.array, cascade, jscd.ScdParams(min_neighbors=0))
    assert 10 <= len(before) <= 200
    return jscd.detect(img.array, cascade)


def request(url, path, data=None, headers=None):
    req = urllib.request.Request(url + path, data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def multipart(fields):
    """A dict of name -> bytes (a file) or str as multipart/form-data."""
    boundary = "portboundary7"
    out = []
    for name, val in fields.items():
        out.append(f"--{boundary}\r\n".encode())
        if isinstance(val, bytes):
            out.append(f'Content-Disposition: form-data; name="{name}"; '
                       f'filename="{name}.png"\r\n\r\n'.encode() + val
                       + b"\r\n")
        else:
            out.append(f'Content-Disposition: form-data; name="{name}"'
                       f"\r\n\r\n{val}\r\n".encode())
    out.append(f"--{boundary}--\r\n".encode())
    return (b"".join(out),
            {"Content-Type": f"multipart/form-data; boundary={boundary}"})


def _png():
    with open(IMAGE, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def served(url):
    code, out = request(url, "/scd/detect.objects", _png())
    assert code == 200, out
    return out


def test_get_lists_the_ported_endpoints(url):
    assert request(url, "/") == (200, ENDPOINTS)


def test_scd_endpoint_matches_jax_detect(served, want):
    assert [(r["x"], r["y"], r["width"], r["height"]) for r in served] == \
        [(c.x, c.y, c.width, c.height) for c in want]
    assert len(served) > 0
    for r, c in zip(served, want):
        assert abs(r["confidence"] - c.confidence) <= \
            2e-4 + 1e-5 * abs(c.confidence)


@pytest.mark.parametrize("form", [
    {"source": None}, {"note": "a string field", "image": None}],
    ids=["source", "first-file-field"])
def test_multipart_equals_raw_body(url, served, form):
    body, headers = multipart({k: (_png() if v is None else v)
                               for k, v in form.items()})
    assert request(url, "/scd/detect.objects", body, headers) == (200, served)


@pytest.mark.parametrize("path,body,headers,code,word", [
    ("/nope", None, None, 404, "unknown"),
    ("/mser", b"\x89PNG", None, 404, "unknown"),
    ("/scd/detect.objects", b"this is not an image", None, 400, "image"),
    ("/scd/detect.objects", b"", None, 400, "empty"),
    ("/scd/detect.objects", b"\xff\xd8\xff\xe0" + b"\x00" * 64, None, 400,
     "JPEG"),
    ("/scd/detect.objects", b"\x89PNG\r\n\x1a\n" + b"\x00" * 9, None, 400,
     "image"),
    ("/scd/detect.objects", b"x",
     {"Content-Length": str(server.MAX_BODY_BYTES + 1)}, 413, "exceeds"),
], ids=["get-404", "post-404", "junk", "empty", "jpeg", "truncated-png",
        "too-large"])
def test_error_paths(url, path, body, headers, code, word):
    got, out = request(url, path, body, headers)
    assert got == code and word in out["error"], (got, out)
    if code == 404:
        assert out["endpoints"] == ENDPOINTS


def test_missing_cascade_is_a_server_error(tmp_path):
    srv = server.Server(("127.0.0.1", 0), str(tmp_path), device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        code, out = request(f"http://127.0.0.1:{srv.server_address[1]}",
                            "/scd/detect.objects", _png())
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert code == 500 and "face.sqlite3" in out["error"], (code, out)


def test_missing_pedestrian_cascade_is_a_server_error(tmp_path):
    """/icf without pedestrian.icf answers as /scd without face.sqlite3."""
    srv = server.Server(("127.0.0.1", 0), str(tmp_path), device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        icf_code, icf_out = request(url, "/icf/detect.objects", _png())
        scd_code, scd_out = request(url, "/scd/detect.objects", _png())
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
    assert icf_code == scd_code == 500
    assert icf_out["error"] == scd_out["error"].replace("face.sqlite3",
                                                        "pedestrian.icf")


def test_icf_endpoint_matches_detect(url, models_dir):
    code, out = request(url, "/icf/detect.objects", _png())
    assert code == 200, out
    img = tio.read(IMAGE, tio.IO_RGB_COLOR, device="cpu")
    want = server._rects(icf.detect_objects(img, icf.load_cascade(
        os.path.join(models_dir, "pedestrian.icf"))))
    assert out == want and len(out) > 0


def test_swt_endpoint_reads_gray_and_matches_detect(url):
    path = os.path.join(DATA, "text_test.png")
    with open(path, "rb") as f:
        code, out = request(url, "/swt/detect.words", f.read())
    assert code == 200, out
    want = server._rects(swt.detect_words(tio.read(path, tio.IO_GRAY,
                                                   device="cpu")))
    assert out == want and len(out) == 2


def test_sift_endpoint_reads_gray_and_matches_sift(url):
    code, out = request(url, "/sift", _png())
    assert code == 200, out
    kps, _ = sift.sift(tio.read(IMAGE, tio.IO_GRAY, device="cpu"),
                       want_desc=False)
    assert out == [{k: float(kp[k]) for k in ("x", "y", "scale", "angle")}
                   for kp in kps]
    assert len(out) > 20


def test_concurrent_clients_are_answered(url, served):
    """16 clients at once: each lists the endpoints and sends junk, and 4
    of them the image too; detection is serialised, every answer comes."""
    errors, answers = [], []

    def client(i):
        try:
            assert request(url, "/")[0] == 200
            assert request(url, "/scd/detect.objects", b"junk")[0] == 400
            if i % 4 == 0:
                answers.append(request(url, "/scd/detect.objects", _png()))
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert answers == [(200, served)] * 4


def test_server_needs_a_card_unless_asked(models_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        server.Server(("127.0.0.1", 0), models_dir)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        server.main(["--port", "0", "--models-dir", models_dir])


def test_module_runs_as_a_program(models_dir):
    """python -m ccv_tpu_torch.serve.server --port 0 --device cpu starts,
    names its port and answers GET /."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ccv_tpu_torch.serve.server", "--port", "0",
         "--models-dir", models_dir, "--device", "cpu"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on :"), (line, proc.stderr.read())
        port = int(line.split(":")[1].split()[0])
        assert request(f"http://127.0.0.1:{port}", "/") == (
            200, ENDPOINTS)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
