"""ResNet50-v1d + FPN backbone and the RPN head (counterpart of
ccv_tpu/models/resnet.py; the reference's COCO topology,
bin/nnc/coco.c:18-177: `_resnet_block_new`, `_resnet_block_layer_new`,
`_imagenet_resnet50_v1d_fpn`, `_coco_resnet50_v1d_rpn`).

Built on the graph model (``nn/functional.Model``): the v1d stem (three
3x3 convolutions), bottleneck blocks with the average-pool projection
shortcut, FPN lateral 1x1 + bilinear 2x up-sampling + 3x3 smoothing to
P2..P5, P6 = 2x2 average pool of P5. The RPN head is one 1x1 convolution
to 3 anchors x (objectness + 4 box) = 15 channels, one weight set shared by
all five levels (a plain dict applied per level; the graph keys parameters
per node).

In bf16 the convolutions take bf16 weights and sum in float32 (cuDNN),
batch norm computes in float32 and casts back, and the FPN's up-sampling
and adds run in bf16, as ``ccv_tpu``'s do. ``conv_flops`` counts the
built graph's multiply-adds for MFU.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.nn import layers as L
from ccv_tpu_torch.nn import ops
from ccv_tpu_torch.nn.functional import Add, Input, Model, Node

FPN_DIM = 256
RPN_CHANNELS = 15  # 3 aspect ratios x (1 objectness + 4 box)


def _bn():
    # coco.c: ccv_cnnp_batch_norm(0.9, 1e-4, 1, 0)
    return L.BatchNorm(momentum=0.9, epsilon=1e-4)


def _block(x: Node, filters: int, expansion: int, strides: int,
           projection_shortcut: bool) -> Node:
    """coco.c:18 `_resnet_block_new` (v1d bottleneck)."""
    shortcut = x
    if projection_shortcut:
        if strides > 1:
            shortcut = L.AvgPool((strides, strides))(shortcut)
        shortcut = L.Convolution(filters * expansion, (1, 1),
                                 padding="VALID")(shortcut)
    y = L.Convolution(filters, (1, 1), padding="VALID", no_bias=True)(x)
    y = _bn()(y)
    y = L.ReLU()(y)
    y = L.Convolution(filters, (3, 3), stride=(strides, strides),
                      padding="SAME", no_bias=True)(y)
    y = _bn()(y)
    y = L.ReLU()(y)
    y = L.Convolution(filters * expansion, (1, 1), padding="VALID",
                      no_bias=True)(y)
    y = _bn()(y)
    out = Add()(y, shortcut)
    return L.ReLU()(out)


def _block_layer(x: Node, filters: int, expansion: int, strides: int,
                 blocks: int) -> Node:
    """coco.c:57 `_resnet_block_layer_new`."""
    x = _block(x, filters, expansion, strides, True)
    for _ in range(blocks - 1):
        x = _block(x, filters, expansion, 1, False)
    return x


def _fpn(c: List[Node], d: int = FPN_DIM) -> List[Node]:
    """coco.c:110 `_fpn`: the top-down lateral merge."""
    p: List[Optional[Node]] = [None] * len(c)
    out = L.Convolution(d, (1, 1), padding="VALID")(c[-1])
    p[-1] = out
    for i in range(len(c) - 2, -1, -1):
        lateral = L.Convolution(d, (1, 1), padding="VALID")(c[i])
        up = L.Upsample(2.0, 2.0, mode="bilinear")(out)
        s = Add()(lateral, up)
        out = L.Convolution(d, (3, 3), padding="SAME")(s)
        p[i] = out
    return p


def resnet50_v1d_fpn() -> Model:
    """coco.c:125 `_imagenet_resnet50_v1d_fpn`: input -> [P2..P6]; P2..P5
    at strides 4 / 8 / 16 / 32, P6 the 2x2 average pool of P5."""
    inp = Input()
    x = L.Convolution(32, (3, 3), stride=(2, 2), padding="SAME",
                      no_bias=True)(inp)
    x = _bn()(x)
    x = L.ReLU()(x)
    x = L.Convolution(32, (3, 3), padding="SAME", no_bias=True)(x)
    x = _bn()(x)
    x = L.ReLU()(x)
    x = L.Convolution(64, (3, 3), padding="SAME", no_bias=True)(x)
    x = _bn()(x)
    x = L.ReLU()(x)
    x = L.MaxPool((3, 3), stride=(2, 2), padding="SAME")(x)
    c2 = _block_layer(x, 64, 4, 1, 3)
    c3 = _block_layer(c2, 128, 4, 2, 4)
    c4 = _block_layer(c3, 256, 4, 2, 6)
    c5 = _block_layer(c4, 512, 4, 2, 3)
    p = _fpn([c2, c3, c4, c5])
    p6 = L.AvgPool((2, 2))(p[3])
    return Model([inp], p + [p6], name="resnet50-v1d-fpn")


def rpn_init(generator: torch.Generator, d: int = FPN_DIM,
             device: _device.DeviceLike = None) -> Dict[str, torch.Tensor]:
    """coco.c:168 `_coco_resnet50_v1d_rpn`: one 1x1 convolution shared by
    the five levels, weight N(0, 0.01^2) (OHWI), bias 0; drawn on the CPU
    from ``generator``, on ``device`` (default: the card)."""
    device = _device.resolve(device)
    w = torch.randn((RPN_CHANNELS, 1, 1, d), generator=generator) * 0.01
    return {"w": w.to(device), "b": torch.zeros(RPN_CHANNELS, device=device)}


def rpn_apply(params: Dict[str, torch.Tensor],
              p_levels: List[torch.Tensor]) -> List[torch.Tensor]:
    """The shared RPN convolution on each level: (B, H, W, 15) maps."""
    return [ops.conv2d(p, params["w"].to(p.dtype), params["b"].to(p.dtype),
                       stride=(1, 1), padding="VALID") for p in p_levels]


def conv_flops(model: Model, rpn: bool = True) -> int:
    """Floating-point operations of one forward of the built ``model`` at
    its built batch: 2 Ho Wo Cout (Cin / groups) kh kw for every
    convolution (and, with ``rpn``, the RPN head on each output level)."""
    total = 0
    for node in model.order:
        layer = node.layer
        if isinstance(layer, L.Convolution):
            b, ho, wo, cout = model.shapes[node.uid]
            cin = model.shapes[node.inputs[0].uid][-1]
            kh, kw = layer.kernel
            total += 2 * b * ho * wo * cout * (cin // layer.groups) * kh * kw
    if rpn:
        for shape in model.output_shape:
            b, ho, wo, d = shape
            total += 2 * b * ho * wo * RPN_CHANNELS * d
    return total
