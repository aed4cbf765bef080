"""The detect tools' drawing twin on the PyTorch port (bbfdraw.rb,
swtdraw.rb, dpmdraw.rb, icfdraw.rb; bin/draw.py): detector rectangles
drawn on an image.

    python -m ccv_tpu_torch.bin.<detector> <image> ... |
        python -m ccv_tpu_torch.bin.draw <image> <out.png>

Reads "x y width height ..." lines from standard input (the detect tools'
output; every line, the "total : N ..." one too, is passed through),
draws a 3-pixel white rectangle for each rect and writes the image. Plain
host arrays: no device.
"""

import sys

import numpy as np


def draw_rects(img: np.ndarray, lines) -> np.ndarray:
    """``img`` (H, W, 3) uint8 with the rect of each line drawn in place,
    each line echoed to standard output."""
    H, W = img.shape[0], img.shape[1]
    for line in lines:
        print(line, end="")
        args = line.split()
        if not args or args[0] in ("total", "elapsed", "elpased"):
            continue
        try:
            x, y, w, h = (int(float(v)) for v in args[:4])
        except ValueError:
            continue
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, W - 1), min(y + h, H - 1)
        for t in range(3):
            if y0 + t < H:
                img[y0 + t, x0:x1 + 1] = 255
            if y1 - t >= 0:
                img[y1 - t, x0:x1 + 1] = 255
            if x0 + t < W:
                img[y0:y1 + 1, x0 + t] = 255
            if x1 - t >= 0:
                img[y0:y1 + 1, x1 - t] = 255
    return img


def main(argv=None) -> int:
    from ccv_tpu_torch.core.io import IO_RGB_COLOR, read, write

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    img = np.array(read(argv[0], IO_RGB_COLOR, device="cpu").numpy())
    write(draw_rects(img, sys.stdin), argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
