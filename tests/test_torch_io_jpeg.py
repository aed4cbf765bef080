"""Port parity: JPEG decoding (ccv_tpu_torch/core/native.py over
csrc/image_decode.cpp, libjpeg from memory) against ccv_tpu.core.io.read of
the same file, and JPEG bodies at the port's /scd endpoint, on the CPU.

The JPEGs are written at test time with PIL from the repository's PNGs and
a seeded image. Decoded bytes must be equal (both packages run libjpeg with
its default settings); the gray path must use libjpeg's reader's
coefficients. The served rects must equal a direct ``detect`` of the
decoded image on the same device, confidences equal.
"""

import io as _pyio
import os
import stat

import numpy as np
import pytest
import torch
from PIL import Image

from ccv_tpu.core import io as jio
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.core import native
from ccv_tpu_torch.detectors import scd
from ccv_tpu_torch import _native_build
from test_torch_serve import models_dir, multipart, request, url  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
FLAGS = {"any": 0, "rgb": tio.IO_RGB_COLOR, "gray": tio.IO_GRAY}


def _jpeg(arr: np.ndarray, quality: int = 90) -> bytes:
    buf = _pyio.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _crop180_rgb() -> np.ndarray:
    """crop180.png with seeded noise, so the channels differ."""
    rgb = tio.read(os.path.join(DATA, "crop180.png"), tio.IO_RGB_COLOR,
                   device="cpu").numpy()
    noise = np.random.default_rng(0).integers(-8, 9, rgb.shape)
    return np.clip(rgb.astype(np.int32) + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """name -> path of a JPEG written here: an RGB photo-like crop, a
    1-channel one, and a small RGB one at another quality."""
    d = tmp_path_factory.mktemp("jpeg")
    rgb = _crop180_rgb()
    small = np.random.default_rng(1).integers(0, 256, (37, 53, 3), np.uint8)
    files = {"rgb": _jpeg(rgb), "gray": _jpeg(rgb[..., 0]),
             "small": _jpeg(small, 75)}
    out = {}
    for name, data in files.items():
        out[name] = str(d / f"{name}.jpg")
        with open(out[name], "wb") as f:
            f.write(data)
    return out


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("name", ["rgb", "gray", "small"])
def test_decode_equals_ccv_tpu_read(jpegs, name, flags):
    want = jio.read(jpegs[name], FLAGS[flags]).numpy()
    with open(jpegs[name], "rb") as f:
        got = tio.decode(f.read(), FLAGS[flags])
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.shape[:2] == ((37, 53) if name == "small" else (180, 180))
    assert got.ndim == {"any": 2 if name == "gray" else 3, "rgb": 3,
                        "gray": 2}[flags]
    read = tio.read(jpegs[name], FLAGS[flags], device="cpu")
    assert torch.equal(read.tensor, torch.from_numpy(got))


def test_gray_uses_libjpeg_coefficients(jpegs):
    """IO_GRAY of an RGB JPEG is (r*6969 + g*23434 + b*2365) >> 15 of its
    RGB decode, not libpng's rounded Rec.709 (which differs on this
    image)."""
    with open(jpegs["rgb"], "rb") as f:
        data = f.read()
    rgb = tio.decode(data, tio.IO_RGB_COLOR)
    gray = tio.decode(data, tio.IO_GRAY)
    np.testing.assert_array_equal(gray, tio.rgb_to_gray_u8(rgb, libpng=False))
    assert not np.array_equal(gray, tio.rgb_to_gray_u8(rgb, libpng=True))


@pytest.mark.parametrize("cut", [0.5, 0.1, 300, 3])
def test_truncated_or_damaged_jpeg_raises(jpegs, cut):
    with open(jpegs["rgb"], "rb") as f:
        data = f.read()
    n = int(len(data) * cut) if isinstance(cut, float) else cut
    with pytest.raises(ValueError, match="JPEG"):
        tio.decode(data[:n])


def test_missing_header_is_named_and_nothing_falls_back(monkeypatch,
                                                        tmp_path, jpegs):
    """A compiler that cannot find jpeglib.h (here a stand-in that fails as
    g++ does) makes a JPEG decode raise an error naming the header, and so
    does a second decode without running the compiler again; PNG still
    decodes, and no other JPEG decoder is tried."""
    fake = tmp_path / "cxx"
    runs = tmp_path / "runs"
    fake.write_text(f"#!/bin/sh\necho run >> {runs}\n"
                    "echo 'image_decode.cpp:20:10: fatal error: "
                    "jpeglib.h: No such file or directory' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native_build, "_loaded", {})
    monkeypatch.setattr(_native_build, "_failed", {})
    with open(jpegs["small"], "rb") as f:
        data = f.read()
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        tio.decode(data)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        native.decode_jpeg(data)
    assert runs.read_text().splitlines() == ["run"]
    png = tio.read(os.path.join(DATA, "crop180.png"), device="cpu")
    assert png.tensor.shape == (180, 180, 3)


def test_decoder_is_built_from_the_port_s_source():
    lib = native._lib()
    path = getattr(lib, "_name")
    assert os.path.dirname(path) == str(_native_build.BUILD_DIR)
    assert os.path.basename(path).startswith("libimage_decode-")
    assert (_native_build.CSRC / "image_decode.cpp").is_file()


def test_only_cuda_builds_hash_the_shared_headers(monkeypatch, tmp_path):
    """The decoder's build key covers its own source, not csrc/*.cuh, so
    an edited CUDA header does not rebuild it; the nvcc libraries' keys
    cover the headers. (Compilers here are stand-ins that fail.)"""
    from ccv_tpu_torch.ops.kernels import _build
    fake = tmp_path / "fail"
    fake.write_text("#!/bin/sh\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native_build, "_loaded", {})
    monkeypatch.setattr(_native_build, "_failed", {})
    hashed = []
    key = _native_build._key

    def recording_key(files, flags):
        hashed.append([f.name for f in files])
        return key(files, flags)

    monkeypatch.setattr(_native_build, "_key", recording_key)
    with pytest.raises(RuntimeError):
        _native_build.load_host_library("image_decode", ["image_decode.cpp"])
    with pytest.raises(RuntimeError):
        _build.load_library("scd_phase", ["scd_phase.cu"])
    cuh = sorted(p.name for p in _native_build.CSRC.glob("*.cuh"))
    assert cuh and hashed[0] == ["image_decode.cpp"]
    assert hashed[1] == ["scd_phase.cu", *cuh]


def test_a_loaded_library_is_found_without_the_file_system(monkeypatch):
    """Kernel wrappers look their library up on every launch: once it is
    loaded, neither loader lists csrc, hashes a file or looks at the build
    directory."""
    import ctypes

    from ccv_tpu_torch.ops.kernels import _build

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"the file system was touched ({name})")

        def __truediv__(self, other):
            raise AssertionError(f"the file system was touched ({other})")

    lib = ctypes.CDLL(None)
    monkeypatch.setattr(_native_build, "_loaded", {"k": lib, "h": lib})
    for mod in (_native_build, _build):
        monkeypatch.setattr(mod, "CSRC", Untouchable())
    monkeypatch.setattr(_native_build, "BUILD_DIR", Untouchable())
    assert _build.load_library("k", ["scd_cascade.cu"], ["-DX"]) is lib
    assert _native_build.load_host_library("h", ["image_decode.cpp"]) is lib


@pytest.fixture(scope="module")
def detected(models_dir, jpegs):  # noqa: F811
    """The JPEG crop's rects from a direct detect of its decode."""
    with open(jpegs["rgb"], "rb") as f:
        data = f.read()
    img = torch.from_numpy(tio.decode(data, tio.IO_RGB_COLOR))
    cascade = scd.load_cascade(os.path.join(models_dir, "face.sqlite3"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        comps = scd.detect(img, cascade, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return data, [{"x": int(c.x), "y": int(c.y), "width": int(c.width),
                   "height": int(c.height),
                   "confidence": float(c.confidence)} for c in comps]


@pytest.mark.parametrize("form", ["raw", "multipart"])
def test_scd_endpoint_answers_a_jpeg(url, detected, form):  # noqa: F811
    data, want = detected
    if form == "raw":
        got = request(url, "/scd/detect.objects", data)
    else:
        body, headers = multipart({"source": data})
        got = request(url, "/scd/detect.objects", body, headers)
    assert got == (200, want)
    assert len(want) > 0


def test_scd_endpoint_refuses_a_truncated_jpeg(url, detected):  # noqa: F811
    data, _ = detected
    code, out = request(url, "/scd/detect.objects", data[:len(data) // 2])
    assert code == 400 and "JPEG" in out["error"], (code, out)
