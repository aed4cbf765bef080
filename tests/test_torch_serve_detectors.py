"""The port's BBF, DPM, MSER, convnet and TLD endpoints
(ccv_tpu_torch/serve/server.py) and CLI twins (ccv_tpu_torch/bin/bbfdetect,
dpmdetect, msermatch, tld) on the CPU: each answers, or prints, what the
port's direct call gives on the same input, and the error paths answer as
serve/server.py's do (a missing TLD field and a convnet model outside the
models directory are client errors, 400).

The models directory holds seeded models: ``face/``, test_torch_bbf's BBF
cascade with its graded thresholds, ``pedestrian.m``, a 1-root, 2-part DPM
model whose beta lets about 20 windows of crop180.png pass at the default
threshold, and tests/data/tiny_convnet_f32.sqlite3. (tiny_convnet_classify.txt
is the C golden of street.png, which is not in the repository: the convnet
endpoint is held to the port's own ``Convnet.classify``, which
test_torch_convnet holds to ccv_tpu.)
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from ccv_tpu_torch.bin import bbfdetect, dpmdetect, msermatch
from ccv_tpu_torch.bin import tld as tldcli
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.detectors import bbf, dpm, mser, tld
from ccv_tpu_torch.models.convnet import Convnet
from ccv_tpu_torch.serve import server
from test_torch_bbf import graded_thresholds, synth_cascade
from test_torch_detect_cli import gray_png
from test_torch_serve import multipart, request
from test_torch_tld import BOX0, make_frames

DATA = os.path.join(os.path.dirname(__file__), "data")
CROP = os.path.join(DATA, "crop180.png")
TEXT = os.path.join(DATA, "text_test.png")
ALL_ENDPOINTS = sorted(["/bbf/detect.objects", "/convnet/classify",
                        "/dpm/detect.objects", "/icf/detect.objects",
                        "/mser", "/scd/detect.objects", "/sift",
                        "/swt/detect.words", "/tld/track.object"])


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def seeded_dpm(rng):
    def part(x, y):
        return dpm.DpmPartClassifier(
            x, y, 0, 0.01, 0.02, 0.05, 0.06,
            rng.normal(0, 0.05, 6).astype(np.float32),
            rng.normal(0, 0.05, (6, 6, 31)).astype(np.float32), 0)

    return dpm.DpmMixtureModel([dpm.DpmRootClassifier(
        0.0, np.array([0.01, -0.02, 0.03], np.float32),
        rng.normal(0, 0.05, (8, 4, 31)).astype(np.float32),
        [part(1, 2), part(3, 6)])])


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    casc = bbf.BbfCascade(**vars(synth_cascade(np.random.default_rng(5))))
    crop120 = tio.read(os.path.join(DATA, "crop120.png"), tio.IO_GRAY,
                       device="cpu")
    _, sums = bbf.window_sums(crop120, casc, bbf.BbfParams(interval=1))
    casc.thresholds[:] = graded_thresholds(sums, 0.02)
    bbf.write_cascade(casc, str(d / "face"))
    model = seeded_dpm(np.random.default_rng(3))
    img = tio.read(CROP, tio.IO_RGB_COLOR, device="cpu")
    conf = np.sort([r.confidence for r in dpm.detect(
        img, model, dpm.DpmParams(min_neighbors=0, threshold=-100.0))])[::-1]
    model.roots[0].beta = 0.6 - float(conf[20] + conf[21]) / 2
    dpm.write_mixture_model(model, str(d / "pedestrian.m"))
    shutil.copy(os.path.join(DATA, "tiny_convnet_f32.sqlite3"),
                d / "tiny.sqlite3")
    return str(d)


@pytest.fixture(scope="module")
def url(models_dir):
    import threading

    srv = server.Server(("127.0.0.1", 0), models_dir, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def frame_pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    paths = []
    for i, f in enumerate(make_frames()[:2]):
        paths.append(str(d / f"{i}.png"))
        with open(paths[-1], "wb") as fh:
            fh.write(gray_png(f))
    return paths


def _png(path=CROP):
    with open(path, "rb") as f:
        return f.read()


def test_get_lists_all_nine_endpoints(url):
    assert request(url, "/") == (200, ALL_ENDPOINTS)


def test_bbf_endpoint_reads_gray_and_matches_detect(url, models_dir):
    code, out = request(url, "/bbf/detect.objects", _png())
    assert code == 200, out
    want = server._rects(bbf.detect_objects(
        tio.read(CROP, tio.IO_GRAY, device="cpu"),
        bbf.load_cascade(os.path.join(models_dir, "face"))))
    assert out == want and len(out) > 0


def test_dpm_endpoint_matches_detect(url, models_dir):
    code, out = request(url, "/dpm/detect.objects", _png())
    assert code == 200, out
    want = server._rects(dpm.detect(
        tio.read(CROP, tio.IO_RGB_COLOR, device="cpu"),
        dpm.read_mixture_model(os.path.join(models_dir, "pedestrian.m"))))
    assert out == want and len(out) > 0


def test_mser_endpoint_reads_gray_and_matches_mser(url):
    code, out = request(url, "/mser", _png(TEXT))
    assert code == 200, out
    kps, _ = mser.mser(tio.read(TEXT, tio.IO_GRAY, device="cpu"))
    assert out == [{"x": k.x, "y": k.y, "width": k.width,
                    "height": k.height, "size": k.size} for k in kps]
    assert len(out) > 10


def test_convnet_endpoint_matches_classify(url, models_dir):
    body, headers = multipart({"source": _png(), "model": "tiny.sqlite3"})
    code, out = request(url, "/convnet/classify", body, headers)
    assert code == 200, out
    net = Convnet.read(os.path.join(models_dir, "tiny.sqlite3"), "cpu")
    want = net.classify(tio.read(CROP, tio.IO_RGB_COLOR, device="cpu").tensor,
                        tops=5)
    assert [(r["id"], r["confidence"]) for r in out] == \
        [(i + 1, c) for i, c in want]


@pytest.mark.parametrize("model,code,word", [
    ("../tiny.sqlite3", 400, "models directory"),
    ("/etc/passwd", 400, "models directory"),
    ("absent.sqlite3", 500, "absent.sqlite3")],
    ids=["escapes", "absolute", "missing"])
def test_convnet_model_errors(url, model, code, word):
    body, headers = multipart({"source": _png(), "model": model})
    got, out = request(url, "/convnet/classify", body, headers)
    assert got == code and word in out["error"], (got, out)


def tld_fields(frame_pngs):
    return {"previous": _png(frame_pngs[0]), "source": _png(frame_pngs[1]),
            "x": str(BOX0[0]), "y": str(BOX0[1]), "width": str(BOX0[2]),
            "height": str(BOX0[3])}


def test_tld_endpoint_matches_a_track_step(url, frame_pngs):
    body, headers = multipart(tld_fields(frame_pngs))
    code, out = request(url, "/tld/track.object", body, headers)
    assert code == 200, out
    prev, cur = (tio.read(p, tio.IO_GRAY, device="cpu").tensor
                 for p in frame_pngs[:2])
    t = tld.Tld(prev, BOX0)
    box, conf = t.track_object(prev, cur)
    assert out == {"found": bool(t.found), "x": box[0], "y": box[1],
                   "width": box[2], "height": box[3], "confidence": conf}


@pytest.mark.parametrize("drop", ["previous", "height"])
def test_tld_missing_field_is_a_client_error(url, frame_pngs, drop):
    fields = tld_fields(frame_pngs)
    del fields[drop]
    body, headers = multipart(fields)
    code, out = request(url, "/tld/track.object", body, headers)
    assert code == 400 and drop in out["error"], (code, out)


@pytest.mark.parametrize("path,name", [("/bbf/detect.objects", "face"),
                                       ("/dpm/detect.objects",
                                        "pedestrian.m")])
def test_missing_model_is_a_server_error(tmp_path, path, name):
    import threading

    srv = server.Server(("127.0.0.1", 0), str(tmp_path), device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        code, out = request(f"http://127.0.0.1:{srv.server_address[1]}",
                            path, _png())
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert code == 500 and name in out["error"], (code, out)


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_bbfdetect(models_dir, capsys):
    face = os.path.join(models_dir, "face")
    assert bbfdetect.main([CROP, face, "--device", "cpu"]) == 0
    want = bbf.detect_objects(tio.read(CROP, tio.IO_GRAY, device="cpu"),
                              bbf.load_cascade(face))
    lines = _lines(capsys)
    assert len(want) > 0 and lines[:-1] == [
        f"{int(c.x)} {int(c.y)} {int(c.width)} {int(c.height)} "
        f"{c.confidence:f}" for c in want]
    assert re.fullmatch(rf"total : {len(want)} in time \d+ms", lines[-1])


def test_dpmdetect(models_dir, capsys):
    path = os.path.join(models_dir, "pedestrian.m")
    assert dpmdetect.main([CROP, path, "--device", "cpu"]) == 0
    want = dpm.detect(tio.read(CROP, tio.IO_RGB_COLOR, device="cpu"),
                      dpm.read_mixture_model(path))
    expect = []
    for c in want:
        expect.append(f"{c.x} {c.y} {c.width} {c.height} {c.confidence:f}")
        expect += [f"| {p.x} {p.y} {p.width} {p.height} {p.confidence:f}"
                   for p in c.parts]
    lines = _lines(capsys)
    assert len(want) > 0 and lines[:-1] == expect
    assert re.fullmatch(rf"total : {len(want)} in time \d+ms", lines[-1])


def test_msermatch(capsys):
    assert msermatch.main([TEXT, "--device", "cpu"]) == 0
    kps, _ = msermatch.msermatch(tio.read(TEXT, tio.IO_GRAY,
                                          device="cpu").tensor)
    lines = _lines(capsys)
    assert len(kps) > 0
    assert re.fullmatch(rf"total : {len(kps)} in time \d+ms", lines[-1])


def test_msermatch_refuses_out_png(tmp_path, capsys):
    """out.png was refused while the port had no image writer; it is now
    written: the regions painted over the image, read back through the
    port's PNG decoder."""
    out = tmp_path / "out.png"
    assert msermatch.main([TEXT, str(out), "--device", "cpu"]) == 0
    gray = tio.read(TEXT, tio.IO_GRAY, device="cpu").tensor
    _, labels = msermatch.msermatch(gray)
    want = msermatch.paint(gray.numpy(), labels)
    assert (labels > 0).any()
    np.testing.assert_array_equal(
        tio.read(str(out), tio.IO_RGB_COLOR, device="cpu").numpy(), want)
    assert re.fullmatch(r"total : \d+ in time \d+ms", _lines(capsys)[-1])


def test_tld_cli(frame_pngs, capsys):
    args = frame_pngs + [str(v) for v in BOX0] + ["--device", "cpu"]
    assert tldcli.main(args) == 0
    frames = [tio.read(p, tio.IO_GRAY, device="cpu").tensor
              for p in frame_pngs]
    t = tld.Tld(frames[0], BOX0)
    want = [f"00000: {BOX0[0]} {BOX0[1]} {BOX0[2]} {BOX0[3]} 1.000000"]
    for i in range(1, len(frames)):
        nb, conf = t.track_object(frames[i - 1], frames[i])
        want.append(f"{i:05d}: {nb[0]} {nb[1]} {nb[2]} {nb[3]} {conf:f}")
    assert _lines(capsys) == want


@pytest.mark.parametrize("tool,args", [
    (bbfdetect, [CROP, "face"]), (dpmdetect, [CROP, "pedestrian.m"]),
    (msermatch, [TEXT]), (tldcli, [CROP, CROP, "1", "2", "30", "40"])],
    ids=["bbfdetect", "dpmdetect", "msermatch", "tld"])
def test_needs_a_card_by_default(tool, args, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        tool.main(args)
