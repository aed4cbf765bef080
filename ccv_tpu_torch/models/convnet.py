"""ccv_convnet, the legacy CNN API (counterpart of ccv_tpu/models/convnet.py;
reference: lib/ccv_convnet.c).

Two halves:
- CNNP-style: ``LocalResponseNorm`` (the layer the modern stack dropped),
  ``matt_net`` (the AlexNet-12 shape the reference benchmarks,
  doc/convnet.rst:79-81), ``ten_patches`` and ``classify`` (center and
  corners, and their mirrors);
- the reference's SQLite wire format: ``Convnet`` with ``ConvnetLayer``,
  ``read`` (float32 and half-precision blobs), ``write``, ``encode`` and
  ``classify``, the 10-patch protocol of ccv_convnet_classify
  (ccv_convnet.c:723).

The wire-format forward runs float32 NHWC on the net's device, TF32 off
(``ccv_tpu`` pins ``Precision.HIGHEST``). A partitioned convolution is one
grouped convolution (``groups=partition``): the same channel split as
``ccv_tpu``'s convolution per partition. Pools let windows overhang the
bottom and right edges (the reference's ceiled output size), padded as
``ccv_tpu`` pads them: -inf for max, and an average over the cells inside.
``supervised_train`` (with bin/cifar-10, image-net and cnnvldtr) is not
ported yet: it is the next slice; the classic detectors' trainers are in
``ccv_tpu_torch.train`` (scd, icf, bbf, swt, dpm).
"""

from __future__ import annotations

import dataclasses
import sqlite3
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.nn import layers as L
from ccv_tpu_torch.nn import ops
from ccv_tpu_torch.nn.layers import Layer
from ccv_tpu_torch.nn.model import Sequential
from ccv_tpu_torch.models.vgg import MEAN_RGB
from ccv_tpu_torch.ops import resample as _resample


def _lrn_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """The sum of x^2 over a ``size``-wide window of channels (last axis),
    zeros past the ends, summed in ``ccv_tpu``'s order."""
    half = size // 2
    sq = F.pad(x * x, (half, half))
    return sum(sq[..., k:k + x.shape[-1]] for k in range(size))


class LocalResponseNorm(Layer):
    """CCV_CONVNET_LOCAL_RESPONSE_NORM: x / (kappa + alpha*sum x^2)^beta
    over a ``size``-wide channel window."""

    def __init__(self, size: int = 5, kappa: float = 2.0, alpha: float = 1e-4,
                 beta: float = 0.75, name: str = "lrn"):
        self.size = size
        self.kappa = kappa
        self.alpha = alpha
        self.beta = beta
        self.name = name

    def apply(self, params, state, x, training=False, generator=None):
        xf = x.float()
        y = xf / torch.pow(self.kappa + self.alpha * _lrn_sum(xf, self.size),
                           self.beta)
        return y.to(x.dtype), state


def matt_net(num_classes: int = 1000) -> Sequential:
    """AlexNet-12/"MattNet" shape (ccv_convnet benchmark config)."""
    return Sequential([
        L.Convolution(96, (11, 11), stride=(4, 4), padding="VALID",
                      name="conv1"),
        L.ReLU(),
        LocalResponseNorm(),
        L.MaxPool((3, 3), (2, 2)),
        L.Convolution(256, (5, 5), padding="SAME", name="conv2"),
        L.ReLU(),
        LocalResponseNorm(),
        L.MaxPool((3, 3), (2, 2)),
        L.Convolution(384, (3, 3), padding="SAME", name="conv3"),
        L.ReLU(),
        L.Convolution(384, (3, 3), padding="SAME", name="conv4"),
        L.ReLU(),
        L.Convolution(256, (3, 3), padding="SAME", name="conv5"),
        L.ReLU(),
        L.MaxPool((3, 3), (2, 2)),
        L.Flatten(),
        L.Dense(4096, name="fc6"), L.ReLU(), L.Dropout(0.5),
        L.Dense(4096, name="fc7"), L.ReLU(), L.Dropout(0.5),
        L.Dense(num_classes, name="fc8"),
    ], name="matt-net")


def ten_patches(img: torch.Tensor, patch: int = 224) -> torch.Tensor:
    """Center and the 4 corners, and their horizontal mirrors
    (ccv_convnet.c:723), stacked on a new first axis."""
    h, w = img.shape[-3], img.shape[-2]
    ys = [0, 0, (h - patch) // 2, h - patch, h - patch]
    xs = [0, w - patch, (w - patch) // 2, 0, w - patch]
    crops = [img[..., y:y + patch, x:x + patch, :] for y, x in zip(ys, xs)]
    crops += [torch.flip(c, dims=(-2,)) for c in crops]
    return torch.stack(crops)


def classify(model: Sequential, img_u8: torch.Tensor, top: int = 5,
             patch: int = 224, mean_rgb=MEAN_RGB):
    """(top indices, their scores) of the softmax averaged over the ten
    patches."""
    x = img_u8.float() - torch.tensor(mean_rgb, device=img_u8.device)
    logits = model.evaluate(ten_patches(x, patch))
    probs = torch.softmax(logits, dim=-1).mean(dim=0)
    idx = torch.argsort(-probs, stable=True)[:top]
    return idx, probs[idx]


# ---------------------------------------------------------------------------
# The reference's wire-format convnet (ccv_convnet.c SQLite schema)
# ---------------------------------------------------------------------------

CONVOLUTIONAL = 0x01
FULL_CONNECT = 0x02
MAX_POOL = 0x03
AVERAGE_POOL = 0x04
LOCAL_RESPONSE_NORM = 0x05


@dataclasses.dataclass
class ConvnetLayer:
    """ccv_convnet_layer_t twin: the tagged-union params and weights."""

    type: int
    in_rows: int
    in_cols: int
    in_channels: int
    in_partition: int
    node_count: int
    # convolutional
    rows: int = 0
    cols: int = 0
    channels: int = 0
    partition: int = 1
    count: int = 0
    strides: int = 1
    border: int = 0
    # pool / rnorm
    size: int = 0
    kappa: float = 0.0
    alpha: float = 0.0
    beta: float = 0.0
    relu: int = 0
    # conv: (count, kr, kc, ch / partition), OHWI; fc: (count, in)
    w: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None   # (count,)

    def out_shape(self, in_rows: int, in_cols: int) -> Tuple[int, int]:
        """ccv_convnet_make_output twin (inc/ccv_convnet_internal.h:4)."""
        if self.type == FULL_CONNECT:
            return self.count, 1
        if self.type == CONVOLUTIONAL:
            k_r, k_c = self.rows, self.cols
        elif self.type in (MAX_POOL, AVERAGE_POOL):
            k_r = k_c = self.size
        else:
            return in_rows, in_cols
        r = (in_rows + self.border * 2 - k_r + self.strides - 1) \
            // self.strides + 1
        c = (in_cols + self.border * 2 - k_c + self.strides - 1) \
            // self.strides + 1
        return r, c


def _layer_forward(layer: ConvnetLayer, x: torch.Tensor) -> torch.Tensor:
    """One layer on an NHWC float32 batch, as
    _ccv_convnet_layer_forward_propagate (ccv_convnet.c:578)."""
    if layer.type == CONVOLUTIONAL:
        y = ops.conv2d(x, layer.w, layer.bias, stride=(layer.strides,) * 2,
                       padding=layer.border, groups=layer.partition)
        return torch.relu(y)  # a convolution always applies ReLU
    if layer.type == FULL_CONNECT:
        flat = x.reshape(x.shape[0], -1)  # H, W, C row-major, as the reference
        y = torch.matmul(flat, layer.w.T) + layer.bias
        return torch.relu(y) if layer.relu else y
    if layer.type in (MAX_POOL, AVERAGE_POOL):
        # the output size ceils, so windows may overhang the bottom/right
        # edge: overhanging cells read nothing (max) or are left out of the
        # average (ccv_convnet.c:556-562)
        H, W = x.shape[1], x.shape[2]
        s, k, b = layer.strides, layer.size, layer.border
        out_r = (H + 2 * b - k + s - 1) // s + 1
        out_c = (W + 2 * b - k + s - 1) // s + 1
        eh = max(0, (out_r - 1) * s + k - 2 * b - H)
        ew = max(0, (out_c - 1) * s + k - 2 * b - W)
        pad = ((0, 0), (b, b + eh), (b, b + ew), (0, 0))
        if layer.type == MAX_POOL:
            return ops.max_pool(x, (k, k), (s, s), pad)
        return ops.avg_pool(x, (k, k), (s, s), pad)
    if layer.type == LOCAL_RESPONSE_NORM:
        ch = layer.in_channels // layer.in_partition
        parts = [x[..., p * ch:(p + 1) * ch]
                 for p in range(layer.in_partition)]
        return torch.cat([
            xp * torch.pow(layer.kappa + layer.alpha
                           * _lrn_sum(xp, layer.size), -layer.beta)
            for xp in parts], dim=-1)
    raise ValueError(f"unknown layer type {layer.type}")


_SCHEMA = (
    "CREATE TABLE IF NOT EXISTS layer_params (layer INTEGER PRIMARY"
    " KEY ASC, type INTEGER, input_matrix_rows INTEGER,"
    " input_matrix_cols INTEGER, input_matrix_channels INTEGER,"
    " input_matrix_partition INTEGER, input_node_count INTEGER,"
    " output_rows INTEGER, output_cols INTEGER, output_channels"
    " INTEGER, output_partition INTEGER, output_count INTEGER,"
    " output_strides INTEGER, output_border INTEGER, output_size"
    " INTEGER, output_kappa REAL, output_alpha REAL, output_beta"
    " REAL, output_relu INTEGER);"
    "CREATE TABLE IF NOT EXISTS convnet_params (convnet INTEGER"
    " PRIMARY KEY ASC, input_height INTEGER, input_width INTEGER,"
    " mean_activity BLOB);"
    "CREATE TABLE IF NOT EXISTS layer_data (layer INTEGER PRIMARY"
    " KEY ASC, weight BLOB, bias BLOB, half_precision INTEGER);")


def is_convnet_file(path: str) -> bool:
    """Whether the SQLite file at ``path`` has the wire format's tables."""
    con = sqlite3.connect(path)
    try:
        names = {r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")}
    finally:
        con.close()
    return "layer_params" in names and "layer_data" in names


class Convnet:
    """ccv_convnet_t twin with the reference's SQLite wire format
    (ccv_convnet_read/write, ccv_convnet.c:1412/:1534). Weights and the
    mean image live on ``device`` (default: the card; raises without
    one)."""

    def __init__(self, layers: Sequence[ConvnetLayer], input_size,
                 mean_activity: Optional[torch.Tensor] = None,
                 device: _device.DeviceLike = None):
        self.device = _device.resolve(device)
        self.layers = list(layers)
        for lay in self.layers:
            if lay.w is not None:
                lay.w = torch.as_tensor(lay.w, device=self.device)
                lay.bias = torch.as_tensor(lay.bias, device=self.device)
        self.input_size = tuple(input_size)  # (height, width)
        self.mean_activity = (None if mean_activity is None else
                              torch.as_tensor(mean_activity,
                                              device=self.device))

    @property
    def rows(self):
        return self.layers[0].in_rows

    @property
    def cols(self):
        return self.layers[0].in_cols

    @property
    def channels(self):
        return self.layers[0].in_channels

    @classmethod
    def read(cls, path: str, device: _device.DeviceLike = None) -> "Convnet":
        """ccv_convnet_read twin: the reference's SQLite schema, float32 or
        half-precision weight blobs (widened to float32)."""
        con = sqlite3.connect(path)
        try:
            rows = con.execute(
                "SELECT layer, type, input_matrix_rows, input_matrix_cols,"
                " input_matrix_channels, input_matrix_partition,"
                " input_node_count, output_rows, output_cols,"
                " output_channels, output_partition, output_count,"
                " output_strides, output_border, output_size, output_kappa,"
                " output_alpha, output_beta, output_relu"
                " FROM layer_params ORDER BY layer ASC").fetchall()
            layers = []
            for r in rows:
                (_, t, imr, imc, imch, imp, inc_, orows, ocols, och, opart,
                 ocount, ostrides, oborder, osize, okappa, oalpha, obeta,
                 orelu) = r
                lay = ConvnetLayer(type=t, in_rows=imr, in_cols=imc,
                                   in_channels=imch, in_partition=imp,
                                   node_count=inc_)
                if t == CONVOLUTIONAL:
                    lay.rows, lay.cols, lay.channels = orows, ocols, och
                    lay.partition, lay.count = opart, ocount
                    lay.strides, lay.border = ostrides, oborder
                elif t == FULL_CONNECT:
                    lay.count = ocount
                    lay.relu = orelu
                elif t in (MAX_POOL, AVERAGE_POOL):
                    lay.strides, lay.border, lay.size = (ostrides, oborder,
                                                         osize)
                elif t == LOCAL_RESPONSE_NORM:
                    lay.size = osize
                    lay.kappa, lay.alpha, lay.beta = okappa, oalpha, obeta
                layers.append(lay)
            ih, iw, mean_blob = con.execute(
                "SELECT input_height, input_width, mean_activity FROM"
                " convnet_params WHERE convnet = 0").fetchone()
            mean = None
            if mean_blob is not None:
                mean = np.frombuffer(mean_blob, np.float32).reshape(
                    ih, iw, layers[0].in_channels).copy()
            for layer_i, wblob, bblob, half in con.execute(
                    "SELECT layer, weight, bias, half_precision FROM"
                    " layer_data"):
                lay = layers[layer_i]
                if wblob is None:
                    continue
                dt = np.float16 if half else np.float32
                w = np.frombuffer(wblob, dt).astype(np.float32)
                b = np.frombuffer(bblob, dt).astype(np.float32)
                if lay.type == CONVOLUTIONAL:
                    lay.w = w.reshape(lay.count, lay.rows, lay.cols,
                                      lay.channels // lay.partition)
                    lay.bias = b
                elif lay.type == FULL_CONNECT:
                    lay.w = w.reshape(lay.count, lay.node_count)
                    lay.bias = b
        finally:
            con.close()
        return cls(layers, (ih, iw), mean, device)

    def write(self, path: str, half_precision: bool = False):
        """ccv_convnet_write twin."""
        con = sqlite3.connect(path)
        try:
            con.executescript(_SCHEMA)
            for i, lay in enumerate(self.layers):
                if lay.type == CONVOLUTIONAL:
                    out = (lay.rows, lay.cols, lay.channels, lay.partition,
                           lay.count, lay.strides, lay.border, 0, 0.0, 0.0,
                           0.0, 0)
                elif lay.type == FULL_CONNECT:
                    out = (0, 0, 0, 1, lay.count, 0, 0, 0, 0.0, 0.0, 0.0,
                           lay.relu)
                elif lay.type in (MAX_POOL, AVERAGE_POOL):
                    out = (0, 0, 0, 1, 0, lay.strides, lay.border, lay.size,
                           0.0, 0.0, 0.0, 0)
                else:
                    out = (0, 0, 0, 1, 0, 0, 0, lay.size, lay.kappa,
                           lay.alpha, lay.beta, 0)
                con.execute(
                    "REPLACE INTO layer_params VALUES"
                    " (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                    (i, lay.type, lay.in_rows, lay.in_cols, lay.in_channels,
                     lay.in_partition, lay.node_count) + out)
                if lay.w is not None:
                    dt = np.float16 if half_precision else np.float32
                    con.execute(
                        "REPLACE INTO layer_data VALUES (?,?,?,?)",
                        (i, lay.w.cpu().numpy().astype(dt).tobytes(),
                         lay.bias.cpu().numpy().astype(dt).tobytes(),
                         int(half_precision)))
            mean = (None if self.mean_activity is None else
                    self.mean_activity.cpu().numpy().astype(np.float32)
                    .tobytes())
            con.execute("REPLACE INTO convnet_params VALUES (0,?,?,?)",
                        (self.rows, self.cols, mean))
            con.commit()
        finally:
            con.close()

    # -- forward -----------------------------------------------------------

    def encode(self, x) -> torch.Tensor:
        """ccv_convnet_encode twin on an NHWC float32 batch (a tensor, or a
        host array, which goes to the net's device)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            for lay in self.layers:
                if lay.type == FULL_CONNECT and x.ndim > 2:
                    x = x.reshape(x.shape[0], -1)
                x = _layer_forward(lay, x)
        return x

    def input_formation(self, img) -> torch.Tensor:
        """ccv_convnet_input_formation twin: float32 on the net's device,
        resampled keeping the aspect so the short side matches the input
        size (INTER_AREA when both sides shrink, else INTER_CUBIC)."""
        a = torch.as_tensor(img, device=self.device).float()
        ih, iw = self.input_size
        h, w = a.shape[0], a.shape[1]
        nh = max(ih, int(h * ih / w + 0.5))
        nw = max(iw, int(w * iw / h + 0.5))
        if (h, w) == (nh, nw):
            return a
        interp = _resample.INTER_AREA if (h > ih and w > iw) \
            else _resample.INTER_CUBIC
        return _resample.resample(a, rows=nh, cols=nw, rows_scale=nh / h,
                                  cols_scale=nw / w, interp=interp)

    def classify(self, img, tops: int = 5,
                 symmetric: bool = True) -> List[Tuple[int, float]]:
        """ccv_convnet_classify twin (ccv_convnet.c:723): the convolution
        stack once on the center-sliced image (and its mirror), 5
        positions sliced at the last convolution's output, the rest of the
        net batched over the 10 patches, the softmax summed over them.

        Returns [(class_id, confidence)], the ``tops`` best in a stable
        order."""
        a = self.input_formation(img)
        scan = max(i for i, l in enumerate(self.layers)
                   if l.type == CONVOLUTIONAL)
        scale = 1
        for l in self.layers[:scan + 1]:
            if l.type in (CONVOLUTIONAL, MAX_POOL, AVERAGE_POOL):
                scale *= l.strides
        fc = min(i for i, l in enumerate(self.layers)
                 if l.type == FULL_CONNECT)
        rows = self.rows + ((a.shape[0] - self.rows) // scale) * scale
        cols = self.cols + ((a.shape[1] - self.cols) // scale) * scale
        y0 = (a.shape[0] - rows) // 2
        x0 = (a.shape[1] - cols) // 2
        sl = a[y0:y0 + rows, x0:x0 + cols]
        mean = 0.0
        if self.mean_activity is not None:
            m = self.mean_activity
            mean = _resample.resample(
                m, rows=rows, cols=cols, rows_scale=rows / m.shape[0],
                cols_scale=cols / m.shape[1], interp=_resample.INTER_CUBIC)
        x = (sl - mean)[None]  # (1, rows, cols, ch)
        feats = []
        with torch.no_grad():
            for t in range(2 if symmetric else 1):
                h = torch.flip(x, dims=(2,)) if t else x
                for l in self.layers[:scan + 1]:
                    h = _layer_forward(l, h)
                fr = self.layers[scan + 1].in_rows
                fcc = self.layers[scan + 1].in_cols
                R, C = h.shape[1], h.shape[2]
                offsets = [(0, 0), (C - fcc, 0),
                           ((C - fcc) // 2, (R - fr) // 2),
                           (0, R - fr), (C - fcc, R - fr)]
                for ox, oy in offsets:
                    feats.append(h[0, oy:oy + fr, ox:ox + fcc])
            z = torch.stack(feats)
            for l in self.layers[scan + 1:fc]:
                z = _layer_forward(l, z)
            z = z.reshape(z.shape[0], -1)
            for l in self.layers[fc:]:
                z = _layer_forward(l, z)
        probs = torch.softmax(z, dim=-1).sum(dim=0).cpu().numpy()
        order = np.argsort(-probs, kind="stable")[:tops]
        denom = z.shape[0]
        return [(int(i), float(probs[i] / denom)) for i in order]
