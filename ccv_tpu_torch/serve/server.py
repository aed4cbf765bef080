"""HTTP endpoint of the port (counterpart of serve/server.py; reference:
serve/, the libev + libebb server of doc/http.rst).

POST an image (the raw body, or the multipart field "source") to an
endpoint and get its detections as JSON; GET / lists the endpoints:

- ``/scd/detect.objects``: SCD faces, ``face.sqlite3`` of the models
  directory;
- ``/icf/detect.objects``: ICF pedestrians, ``pedestrian.icf`` of the
  models directory;
- ``/swt/detect.words``: SWT words of the image read as gray;
- ``/sift``: SIFT keypoints (x, y, scale, angle) of the image read as gray;
- ``/bbf/detect.objects``: BBF faces of the image read as gray, the cascade
  directory ``face/`` of the models directory;
- ``/dpm/detect.objects``: DPM pedestrians, ``pedestrian.m`` of the models
  directory;
- ``/mser``: MSER regions of the image read as gray.

Two endpoints take every field of a multipart form (the reference's
serve/convnet.c and serve/tld.c):

- ``/convnet/classify``: the top 5 classes of "source" by the convnet
  SQLite model named by "model" (default ``image-net-2012.sqlite3``), a
  path inside the models directory (one that escapes it answers 400), with
  the words of ``image-net-2012.words`` where that file is there;
- ``/tld/track.object``: one stateless tracking step, a TLD tracker made on
  the "previous" frame with the box "x", "y", "width", "height" and run to
  the "source" frame (both read as gray); a missing field answers 400.

A model loads at the first request that needs it and is kept; a missing one
answers 500 naming it.

    python -m ccv_tpu_torch.serve.server --port 3350 --models-dir DIR
    curl -F source=@photo.png localhost:3350/scd/detect.objects

Detection runs on the card unless ``--device cpu`` is given: the device is
resolved when the server starts, so a machine without a card fails then,
not on each request. Images are decoded in memory by the port's
``core.io`` (PNG, JPEG and CCVBINDM natively, other formats and JPEG
without libjpeg by PIL, as ``ccv_tpu``'s server reads them; a damaged one
answers 400). One lock
serialises detection; the first request builds the cascade kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import struct
import sys
import threading
import traceback
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core import io
from ccv_tpu_torch.detectors import bbf, dpm, icf, mser, scd, sift, swt, tld
from ccv_tpu_torch.models.convnet import Convnet

# request bodies are image uploads; the reference's libev server caps the
# request buffer similarly (serve/serve.c): 64 MB covers any sane image
MAX_BODY_BYTES = 64 * 1024 * 1024


class RequestError(Exception):
    """Client error with an HTTP status (maps to 4xx, not 500)."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def _decode_image(data: bytes, gray: bool = False) -> torch.Tensor:
    """The body as an RGB uint8 (H, W, 3) host tensor, or gray (H, W)."""
    if not data:
        raise RequestError(400, "empty image body")
    try:
        arr = io.decode(data, io.IO_GRAY if gray else io.IO_RGB_COLOR)
    except (ValueError, NotImplementedError, KeyError, IndexError,
            struct.error, zlib.error) as e:
        raise RequestError(400, f"undecodable image: {e}") from None
    return torch.from_numpy(arr)


def _parse_multipart(handler) -> dict:
    """All multipart fields by name: file parts -> bytes, strings -> str.
    Non-multipart bodies come back as {"source": body} (the reference's
    uri.c accepts both raw-body and form posts)."""
    try:
        length = int(handler.headers.get("Content-Length", 0))
    except (TypeError, ValueError):
        raise RequestError(400, "bad Content-Length")
    if length < 0 or length > MAX_BODY_BYTES:
        raise RequestError(413, f"body exceeds {MAX_BODY_BYTES} bytes")
    body = handler.rfile.read(length)
    ctype = handler.headers.get("Content-Type", "")
    m = re.search(r'boundary=("?)([^";]+)\1', ctype)
    if not m:
        return {"source": body}
    boundary = m.group(2).encode()
    fields: dict = {}
    for part in body.split(b"--" + boundary):
        idx = part.find(b"\r\n\r\n")
        if idx < 0:
            continue
        head = part[:idx].decode("latin-1")
        nm = re.search(r'name=("?)([^";\r\n]+)\1', head)
        if not nm:
            continue
        payload = part[idx + 4:]
        # the boundary split leaves one CRLF (and, on the final part, the
        # closing "--"): strip exactly that, never payload bytes
        if payload.endswith(b"--"):
            payload = payload[:-2]
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        if "filename=" in head:
            fields[nm.group(2)] = payload
        else:
            fields[nm.group(2)] = payload.decode("utf-8", "replace")
    return fields


def _extract_body(handler) -> bytes:
    fields = _parse_multipart(handler)
    src = fields.get("source")
    if src is None:  # first file-ish field
        for v in fields.values():
            if isinstance(v, bytes):
                return v
        return b""
    return src if isinstance(src, bytes) else src.encode()


def _rects(comps) -> List[dict]:
    return [{"x": int(c.x), "y": int(c.y), "width": int(c.width),
             "height": int(c.height),
             "confidence": float(getattr(c, "confidence", 0.0))}
            for c in comps]


def _scd(server: "Server", img: torch.Tensor) -> List[dict]:
    return _rects(scd.detect(img.to(server.device), server.face_cascade(),
                             device=server.device))


def _icf(server: "Server", img: torch.Tensor) -> List[dict]:
    return _rects(icf.detect_objects(img.to(server.device),
                                     server.pedestrian_cascade(),
                                     device=server.device))


def _swt(server: "Server", img: torch.Tensor) -> List[dict]:
    return _rects(swt.detect_words(img.to(server.device),
                                   device=server.device))


def _sift(server: "Server", img: torch.Tensor) -> List[dict]:
    kps, _ = sift.sift(img.to(server.device), want_desc=False,
                       device=server.device)
    return [{"x": float(k["x"]), "y": float(k["y"]),
             "scale": float(k["scale"]), "angle": float(k["angle"])}
            for k in kps]


def _bbf(server: "Server", img: torch.Tensor) -> List[dict]:
    return _rects(bbf.detect_objects(img.to(server.device),
                                     server.face_bbf_cascade()))


def _dpm(server: "Server", img: torch.Tensor) -> List[dict]:
    return _rects(dpm.detect(img.to(server.device),
                             server.pedestrian_model()))


def _mser(server: "Server", img: torch.Tensor) -> List[dict]:
    kps, _ = mser.mser(img)
    return [{"x": k.x, "y": k.y, "width": k.width, "height": k.height,
             "size": k.size} for k in kps]


def _convnet(server: "Server", fields: dict):
    """serve/convnet.c twin: the top 5 of "source" by the model "model", a
    path inside the models directory."""
    model = fields.get("model", "image-net-2012.sqlite3")
    root = os.path.realpath(server.models_dir)
    path = os.path.realpath(os.path.join(root, model))
    if not path.startswith(root + os.sep):
        raise RequestError(400, f"the model must lie in the models "
                                f"directory: {model}")
    net = server._model(os.path.relpath(path, root),
                        lambda p: Convnet.read(p, server.device))
    img = _decode_image(_image_field(fields, "source"))
    ranks = net.classify(img.to(server.device), tops=5)
    words_path = os.path.join(root, "image-net-2012.words")
    words = None
    if os.path.exists(words_path):
        with open(words_path) as f:
            words = [ln.strip() for ln in f]
    return [{"id": int(i) + 1, "confidence": float(c),
             **({"word": words[int(i)]} if words and int(i) < len(words)
                else {})}
            for i, c in ranks]


def _tld(server: "Server", fields: dict):
    """serve/tld.c twin: one stateless track step from "previous" to
    "source" of the box (x, y, width, height)."""
    for req in ("previous", "source", "x", "y", "width", "height"):
        if req not in fields:
            raise RequestError(400, f"missing field '{req}'")
    prev = _decode_image(_image_field(fields, "previous"), gray=True)
    cur = _decode_image(_image_field(fields, "source"), gray=True)
    try:
        box = tuple(int(float(fields[k]))
                    for k in ("x", "y", "width", "height"))
    except ValueError:
        raise RequestError(400, "x, y, width and height must be numbers")
    t = tld.Tld(prev.to(server.device), box)
    out, conf = t.track_object(prev, cur)
    if out is None:
        return {"found": False}
    return {"found": bool(t.found), "x": int(out[0]), "y": int(out[1]),
            "width": int(out[2]), "height": int(out[3]),
            "confidence": float(conf)}


def _image_field(fields: dict, name: str) -> bytes:
    v = fields.get(name, b"")
    return v if isinstance(v, bytes) else v.encode()


# path -> (handler, whether the image is read as gray)
ENDPOINTS = {
    "/scd/detect.objects": (_scd, False),
    "/icf/detect.objects": (_icf, False),
    "/swt/detect.words": (_swt, True),
    "/sift": (_sift, True),
    "/bbf/detect.objects": (_bbf, True),
    "/dpm/detect.objects": (_dpm, False),
    "/mser": (_mser, True),
}

# path -> handler of every field of the form
FIELD_ENDPOINTS = {
    "/convnet/classify": _convnet,
    "/tld/track.object": _tld,
}


def endpoints() -> List[str]:
    return sorted(list(ENDPOINTS) + list(FIELD_ENDPOINTS))


class Handler(BaseHTTPRequestHandler):
    def _json(self, code: int, obj) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _unknown(self) -> None:
        self._json(404, {"error": "unknown endpoint",
                         "endpoints": endpoints()})

    def do_GET(self):  # noqa: N802 (stdlib convention)
        if self.path in ("/", ""):
            self._json(200, endpoints())
        else:
            self._unknown()

    def do_POST(self):  # noqa: N802
        if self.path not in ENDPOINTS and self.path not in FIELD_ENDPOINTS:
            self._unknown()
            return
        try:
            if self.path in FIELD_ENDPOINTS:
                fields = _parse_multipart(self)
                with self.server.lock:
                    out = FIELD_ENDPOINTS[self.path](self.server, fields)
            else:
                handler, gray = ENDPOINTS[self.path]
                img = _decode_image(_extract_body(self), gray)
                with self.server.lock:
                    out = handler(self.server, img)
            self._json(200, out)
        except RequestError as e:
            self._json(e.code, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - report it to the client
            traceback.print_exc(file=sys.stderr)
            self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args):
        pass


class Server(ThreadingHTTPServer):
    """Threaded server with a deep accept backlog (the default 5 drops
    connections under concurrent load) and bounded per-request lifetime.
    Holds what the requests share: the models directory, the device, the
    lock that serialises detection and the cascades, each loaded once."""

    request_queue_size = 128
    daemon_threads = True
    timeout = 60

    def __init__(self, address, models_dir: str,
                 device: _device.DeviceLike = None):
        self.models_dir = models_dir
        self.device = _device.resolve(device)  # raises without a card
        self.lock = threading.Lock()
        self._models: dict = {}
        super().__init__(address, Handler)

    def _model(self, name: str, load, directory: bool = False):
        """``load(path)`` of the models directory's ``name`` (a file, or a
        directory), run by the first request that needs it (under the lock)
        and kept."""
        if name not in self._models:
            path = os.path.join(self.models_dir, name)
            if not (os.path.isdir(path) if directory
                    else os.path.isfile(path)):
                raise FileNotFoundError(f"model not found: {path}")
            self._models[name] = load(path)
        return self._models[name]

    def face_cascade(self) -> scd.ScdClassifierCascade:
        return self._model("face.sqlite3", scd.load_cascade)

    def pedestrian_cascade(self) -> icf.IcfCascade:
        return self._model("pedestrian.icf", icf.load_cascade)

    def face_bbf_cascade(self) -> bbf.BbfCascade:
        return self._model("face", bbf.load_cascade, directory=True)

    def pedestrian_model(self) -> dpm.DpmMixtureModel:
        return self._model("pedestrian.m", dpm.read_mixture_model)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=3350)
    ap.add_argument("--models-dir", required=True,
                    help="directory holding the models: face.sqlite3, "
                         "pedestrian.icf, face/ (BBF), pedestrian.m and "
                         "*.sqlite3 convnets")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    srv = Server(("0.0.0.0", args.port), args.models_dir, args.device)
    print(f"serving on :{srv.server_address[1]} ({srv.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
