"""VGG-D (VGG-16), the reference's headline ImageNet model (counterpart of
ccv_tpu/models/vgg.py; doc/convnet.rst, samples/image-net-2012-vgg-d).

Built from the port's CNNP layers: 13 3x3 "SAME" convolutions with ReLU in
five blocks, each closed by a 2x2 max-pool, then fc6, fc7 (4096, ReLU,
dropout) and fc8. Parameters stay float32 and are cast to the input's type
in each op, so a bfloat16 input runs cuDNN's and cuBLAS's bf16 kernels.
``classify`` is bin/cnnclassify's center-patch protocol.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ccv_tpu_torch.nn import layers as L
from ccv_tpu_torch.nn.model import Sequential

VGG_D_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
MEAN_RGB = (123.68, 116.779, 103.939)


def vgg_d(num_classes: int = 1000, include_top: bool = True,
          name: str = "vgg-d") -> Sequential:
    stack = []
    i = 0
    for c in VGG_D_CFG:
        if c == "M":
            stack.append(L.MaxPool((2, 2)))
        else:
            stack.append(L.Convolution(c, (3, 3), padding="SAME",
                                       name=f"conv{i}"))
            stack.append(L.ReLU())
            i += 1
    if include_top:
        stack += [
            L.Flatten(),
            L.Dense(4096, name="fc6"), L.ReLU(), L.Dropout(0.5),
            L.Dense(4096, name="fc7"), L.ReLU(), L.Dropout(0.5),
            L.Dense(num_classes, name="fc8"),
        ]
    return Sequential(stack, name=name)


def forward_flops(res: int = 224, num_classes: int = 1000) -> float:
    """Forward FLOPs of one image, by bench.py's formula: each convolution
    2 * res^2 * c * cin * 9, then the three dense layers."""
    flops, cin = 0.0, 3
    for c in VGG_D_CFG:
        if c == "M":
            res //= 2
        else:
            flops += 2.0 * res * res * c * cin * 9
            cin = c
    return flops + 2.0 * (res * res * cin * 4096 + 4096 * 4096
                          + 4096 * num_classes)


def preprocess(img_u8: torch.Tensor, mean_rgb=MEAN_RGB) -> torch.Tensor:
    """Center 224 crop of an (..., H, W, 3) image, as float32 less the mean
    (cnnclassify's center patch)."""
    x = img_u8.float()
    h, w = x.shape[-3], x.shape[-2]
    y0, x0 = (h - 224) // 2, (w - 224) // 2
    x = x[..., y0:y0 + 224, x0:x0 + 224, :]
    return x - torch.tensor(mean_rgb, device=x.device)


def classify(model: Sequential, img_u8: torch.Tensor,
             top: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """bin/cnnclassify twin: (top indices, their softmax scores), each
    (B, top)."""
    x = preprocess(img_u8)
    if x.ndim == 3:
        x = x[None]
    probs = torch.softmax(model.evaluate(x), dim=-1)
    idx = torch.argsort(-probs, dim=-1, stable=True)[..., :top]
    return idx, torch.take_along_dim(probs, idx, dim=-1)
