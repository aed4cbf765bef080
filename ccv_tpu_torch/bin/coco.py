"""bin/coco.py twin: RPN training of ResNet50-v1d-FPN on COCO-style
annotations, on the card (reference: bin/nnc/coco.c).

Topology: ResNet50-v1d + FPN with the shared 1x1 RPN head
(``ccv_tpu_torch.models.resnet``, coco.c:18-177). Data: a list file of
``class filename x y width height`` lines (coco.c:644), grouped by file.
A step (coco.c:540-610, ``bin/coco.py``'s ``train_step``):

* anchors at strides 4 / 8 / 16 / 32 / 64, 3 aspect ratios, base 8 x
  stride; ground truth per anchor by IoU (>= 0.7 positive with (dx, dy,
  log dw, log dh) targets, <= 0.3 negative, else ignored; each box claims
  its best anchor); ``select_count`` anchors, up to half positives. This
  is host numpy (``rpn_gt``, ``select_anchors``: copies of
  ``bin/coco.py``'s, the same arrays);
* the FPN forward in training mode (batch norm on the batch's
  statistics), the RPN maps, sigmoid BCE on the selected anchors'
  objectness plus smooth-L1 on the positives' boxes (``rpn_loss``), the
  gradients by autograd, ``clip_grad_norm(..., 5.0)`` and ``sgd(rate,
  momentum=0.9)`` in place.

    python -m ccv_tpu_torch.bin.coco --train-list list.txt --train-dir images/
    python -m ccv_tpu_torch.bin.coco --demo   # synthetic boxes [--device cpu]

Runs on the first CUDA device unless ``--device`` says otherwise; the
weights are seeded (no ImageNet initialisation, as ``bin/coco.py``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.models import resnet
from ccv_tpu_torch.nn import ops, optimizers
from ccv_tpu_torch.nn.model import loss_and_grads

STRIDES = (4, 8, 16, 32, 64)
BOX_SIZE = 8  # anchor base = BOX_SIZE * stride (coco.c:382)


def anchor_shapes(stride: int):
    """coco.c:385-396: (width, height) of the 3 aspect-ratio anchors."""
    a = BOX_SIZE * stride
    a1 = int(np.sqrt(a * a / 2.0) + 0.5)
    return ((a, a), (a1, a1 * 2), (a1 * 2, a1))


def level_grids(rows: int, cols: int):
    """FPN level output grids for an input of (rows, cols): SAME-padded
    stride-2 stages for P2..P5, then P6 = VALID 2x2 avg-pool of P5
    (coco.c builds gt from the model's own tensor_auto shapes — we
    mirror the exact shape arithmetic; bin tools assert against the
    built model)."""
    grids = []
    r, c = rows, cols
    for _ in range(2):  # stem conv s2 + maxpool s2 -> stride 4
        r, c = (r + 1) // 2, (c + 1) // 2
    grids.append((r, c))
    for _ in range(3):  # c3, c4, c5
        r, c = (r + 1) // 2, (c + 1) // 2
        grids.append((r, c))
    grids.append((r // 2, c // 2))  # P6: VALID 2x2 pool
    return grids


def rpn_gt(grids, boxes):
    """Anchor ground truth for one image — numpy twin of coco.c
    _rpn_gt/_rpn_rect_missing_gt. boxes: (n, 4) [x, y, w, h] float.
    Returns gt (total*3, 5): [obj(-1/0/1), dx, dy, log dw, log dh]."""
    chunks = []
    # best anchor per gt box across ALL levels (missing-gt pass)
    best_iou = np.zeros(len(boxes))
    best_ref = [None] * len(boxes)  # (chunk_idx, flat_idx, ax, ay, aw, ah)
    for li, (s, (gh, gw)) in enumerate(zip(STRIDES, grids)):
        for (aw, ah) in anchor_shapes(s):
            ox, oy = (aw - 1) // 2, (ah - 1) // 2
            if aw != ah:
                # coco.c:392-396: the 1:2/2:1 offsets come from the
                # 1:1-equivalent size
                a1 = int(np.sqrt((BOX_SIZE * s) ** 2 / 2.0) + 0.5)
                o1, o2 = (a1 - 1) // 2, a1 - 1
                ox, oy = (o1, o2) if aw < ah else (o2, o1)
            ys, xs = np.mgrid[0:gh, 0:gw]
            rx = (xs * s - ox).ravel().astype(np.float32)
            ry = (ys * s - oy).ravel().astype(np.float32)
            cell = np.zeros((gh * gw, 5), np.float32)
            if len(boxes):
                bx, by, bw, bh = (boxes[:, 0], boxes[:, 1], boxes[:, 2],
                                  boxes[:, 3])
                ix = (np.minimum(rx[:, None] + aw, bx + bw)
                      - np.maximum(rx[:, None], bx)).clip(min=0)
                iy = (np.minimum(ry[:, None] + ah, by + bh)
                      - np.maximum(ry[:, None], by)).clip(min=0)
                inter = ix * iy
                iou = inter / (bw * bh + aw * ah - inter)
                bi = np.argmax(iou, axis=1)
                bv = iou[np.arange(len(rx)), bi]
                pos = bv >= 0.7
                ign = (bv > 0.3) & ~pos
                cell[:, 0] = np.where(pos, 1.0, np.where(ign, -1.0, 0.0))
                gx = bx[bi] + bw[bi] * 0.5
                gy = by[bi] + bh[bi] * 0.5
                x_anchor = (xs * s).ravel()
                y_anchor = (ys * s).ravel()
                cell[pos, 1] = ((gx - x_anchor) / aw)[pos]
                cell[pos, 2] = ((gy - y_anchor) / ah)[pos]
                cell[pos, 3] = np.log(bw[bi] / aw)[pos]
                cell[pos, 4] = np.log(bh[bi] / ah)[pos]
                # track the best anchor for each gt box
                kb = np.argmax(iou, axis=0)
                kv = iou[kb, np.arange(len(boxes))]
                for k in range(len(boxes)):
                    if kv[k] > best_iou[k]:
                        best_iou[k] = kv[k]
                        best_ref[k] = (len(chunks), int(kb[k]),
                                       float(x_anchor[kb[k]]),
                                       float(y_anchor[kb[k]]), aw, ah)
            chunks.append(cell)
    # _rpn_rect_missing_gt: force-assign each gt's best anchor
    for k, ref in enumerate(best_ref):
        if ref is None:
            continue
        ci, fi, ax, ay, aw, ah = ref
        if chunks[ci][fi, 0] != 1.0:
            bx, by, bw, bh = boxes[k]
            chunks[ci][fi] = (1.0, (bx + bw * 0.5 - ax) / aw,
                              (by + bh * 0.5 - ay) / ah,
                              np.log(bw / aw), np.log(bh / ah))
    # interleave the 3 aspect chunks per level to match the RPN output
    # layout (B, H, W, 3*5) flattened
    out = []
    i = 0
    for (gh, gw) in grids:
        trio = np.stack(chunks[i:i + 3], axis=1)  # (gh*gw, 3, 5)
        out.append(trio.reshape(-1, 5))
        i += 3
    return np.concatenate(out, axis=0)


def select_anchors(gt, select_count, rng):
    """coco.c:402-414: up to half positives, rest negatives."""
    order = rng.permutation(len(gt))
    pos = order[gt[order, 0] == 1.0][:select_count // 2]
    neg = order[gt[order, 0] == 0.0][:select_count - len(pos)]
    return np.concatenate([pos, neg]).astype(np.int32)


def load_list(list_file, image_dir):
    """coco.c:636-676 `_array_from_disk_new`: group box lines per file."""
    anns = {}
    with open(list_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 6:
                continue
            _, fname, x, y, w, h = parts
            path = os.path.join(image_dir or "", fname)
            anns.setdefault(path, []).append(
                [float(x), float(y), float(w), float(h)])
    return [(p, np.asarray(b, np.float32)) for p, b in anns.items()]


def synthetic_scene(rng, rows, cols, n_boxes=3):
    """Demo data: bright rectangles on dark noise, boxes as GT."""
    img = rng.standard_normal((rows, cols, 3)).astype(np.float32) * 0.1
    boxes = []
    for _ in range(n_boxes):
        w = int(rng.integers(24, min(72, cols // 2 + 1)))
        h = int(rng.integers(24, min(72, rows // 2 + 1)))
        x = int(rng.integers(0, cols - w))
        y = int(rng.integers(0, rows - h))
        img[y:y + h, x:x + w] += rng.uniform(0.8, 1.2)
        boxes.append([x, y, w, h])
    return img, np.asarray(boxes, np.float32)


def rpn_loss(maps: List[torch.Tensor], gt: torch.Tensor,
             sel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy) of the RPN maps (B, H, W, 15) per level against
    ``gt`` (B, total, 5) at the flat anchor indices ``sel``: the mean
    sigmoid BCE of the selected objectness logits, plus smooth-L1 of the
    box regressions summed over the positives and divided by their count
    (at least 1); accuracy: the logit's sign against the label
    (coco.c:586-596)."""
    flat = torch.cat([m.reshape(m.shape[0], -1, 5) for m in maps], 1)
    out_sel = flat.reshape(-1, 5)[sel]
    gt_sel = gt.reshape(-1, 5)[sel]
    bce, _ = ops.sigmoid_binary_crossentropy(out_sel[:, :1], gt_sel[:, :1])
    pos = gt_sel[:, 0] == 1.0
    l1 = ops.smooth_l1_loss(out_sel[:, 1:], gt_sel[:, 1:])
    l1_loss = (torch.where(pos, l1, torch.zeros_like(l1)).sum()
               / torch.clamp(pos.sum(), min=1))
    acc = ((out_sel[:, 0] > 0) == (gt_sel[:, 0] > 0.5)).float().mean()
    return bce.mean() + l1_loss, acc


class Trainer:
    """The FPN, the RPN head and SGD's state on ``device``; ``batch``
    assembles a step's arrays on the host, ``grads`` and ``step`` run it."""

    def __init__(self, batch: int, rows: int, cols: int, lr: float = 0.001,
                 select_count: int = 64, device: _device.DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        self.device = _device.resolve(device)
        self.rows, self.cols, self.select_count = rows, cols, select_count
        self.grids = level_grids(rows, cols)
        self.total = sum(gh * gw for gh, gw in self.grids) * 3
        self.fpn = resnet.resnet50_v1d_fpn()
        self.fpn.build((batch, rows, cols, 3), torch.Generator().manual_seed(0),
                       device=self.device)
        built = [(s[1], s[2]) for s in self.fpn.output_shape]
        if built != self.grids:  # the gt layout must match the model
            raise ValueError(f"levels {built} against {self.grids}")
        self.params = {"fpn": self.fpn.params, "rpn": resnet.rpn_init(
            torch.Generator().manual_seed(1), device=self.device)}
        self.dtype = dtype
        if dtype != torch.float32:  # drawn in float32 from the seeds, cast
            for tree in (self.params["rpn"], *self.fpn.params.values(),
                         *self.fpn.state.values()):
                for k in tree:
                    tree[k] = tree[k].to(dtype)
        self.state = self.fpn.state
        self.opt = optimizers.sgd(rate=lr, momentum=0.9)
        self.opt_state = self.opt.init(self.params)

    def batch(self, data, rng: np.random.Generator):
        """(images (B, rows, cols, 3), gt (B, total, 5), sel) as numpy for
        ``len(data)`` scenes [(image, boxes)], ``rng`` drawing the
        selection, as ``bin/coco.py`` builds them."""
        imgs = np.stack([img for img, _ in data])
        gts, sels = [], []
        for bi, (_, boxes) in enumerate(data):
            g = rpn_gt(self.grids, boxes)
            gts.append(g)
            sels.append(select_anchors(g, self.select_count, rng)
                        + bi * self.total)
        return imgs, np.stack(gts), np.concatenate(sels).astype(np.int64)

    def to_device(self, imgs, gt, sel):
        return (_device.to_device(imgs, self.device).to(self.dtype),
                _device.to_device(gt, self.device),
                _device.to_device(sel, self.device))

    def grads(self, imgs: torch.Tensor, gt: torch.Tensor,
              sel: torch.Tensor):
        """(loss, accuracy, gradients in ``leaves()`` order of the
        parameters, new batch-norm states) of one training forward and
        backward, nothing applied (``model.loss_and_grads``, as ``fit``)."""
        def loss_of(tp):
            feats, state = self.fpn._forward(tp["fpn"], self.state, [imgs],
                                             True, None)
            loss, acc = rpn_loss(resnet.rpn_apply(tp["rpn"], feats), gt, sel)
            return loss, (acc, state)
        loss, grads, (acc, state) = loss_and_grads(self.params, loss_of)
        return loss, acc, grads, state

    def step(self, imgs: torch.Tensor, gt: torch.Tensor, sel: torch.Tensor):
        """One SGD step, the global gradient norm clipped to 5 (the
        from-scratch backbone's early smooth-L1 spikes); returns (loss,
        accuracy) as tensors on the device (not synchronised)."""
        loss, acc, grads, self.state = self.grads(imgs, gt, sel)
        grads, _ = optimizers.clip_grad_norm(grads, 5.0)
        self.opt.update(grads, self.opt_state, self.params)
        return loss, acc


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-list")
    ap.add_argument("--train-dir", default="")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--size", type=int, default=128,
                    help="square training crop (demo)")
    ap.add_argument("--select-count", type=int, default=64)
    # _resnet_learn_rate (coco.c:445): 0.001 for the first epochs
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    """Trains as ``bin/coco.py``; returns (final loss, final accuracy) and
    keeps every step's loss in ``main.losses``."""
    args = parser().parse_args(argv)
    rng = np.random.default_rng(0)
    rows = cols = args.size
    demo = args.demo or not args.train_list
    if demo:
        data = [synthetic_scene(rng, rows, cols) for _ in range(16)]
    else:
        from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
        data = []
        for path, boxes in load_list(args.train_list, args.train_dir):
            img = read(path, IO_RGB_COLOR, device="cpu").tensor.float() / 255
            sy, sx = rows / img.shape[0], cols / img.shape[1]
            img = torch.nn.functional.interpolate(  # resize at the host edge
                img.permute(2, 0, 1)[None], size=(rows, cols),
                mode="bilinear", antialias=True)[0].permute(1, 2, 0)
            data.append((img.numpy(), boxes * [sx, sy, sx, sy]))
        if not data:
            raise SystemExit(f"no annotations read from {args.train_list}")
    trainer = Trainer(args.batch, rows, cols, args.lr, args.select_count,
                      args.device)
    t0 = time.time()
    losses = []
    loss = acc = None
    for step in range(args.steps):
        idx = rng.integers(0, len(data), args.batch)
        host = trainer.batch([data[i] for i in idx], rng)
        loss, acc = trainer.step(*trainer.to_device(*host))
        losses.append(float(loss))
        if step % 10 == 9:
            sps = (step + 1) * args.batch / (time.time() - t0)
            print(f"step {step + 1}: loss {losses[-1]:.4f} "
                  f"accuracy {float(acc) * 100:.1f}% "
                  f"({sps:.2f} samples/sec)")
    main.losses = losses
    print(f"final loss {float(loss):.4f} accuracy {float(acc) * 100:.1f}%")
    return float(loss), float(acc)


if __name__ == "__main__":
    main()
