"""bin/dpmext twin on the PyTorch port: PASCAL VOC annotation directories
to the "name x y width height" list that dpmcreate reads (reference:
bin/dpmext.rb).

    python -m ccv_tpu_torch.bin.dpmext VOCdevkit/VOC2007/Annotations_txt/ \\
        > train.list

Plain text: no device.
"""

import glob
import os
import re
import sys

_NAME = re.compile(r'Image filename', re.IGNORECASE)
_BOX = re.compile(r'Bounding box for', re.IGNORECASE)
_COORD = re.compile(r"\((\d+),\s*(\d+)\)\s*-\s*\((\d+),\s*(\d+)\)")
_OBJ = re.compile(r"object\s*(\d+)")


def extract(path: str):
    """One annotation file -> its (image_name, x, y, w, h) in object
    order."""
    name = None
    boxes = {}
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("#"):
                continue
            if _NAME.match(line[:14]):
                # image filename : "VOC2007/JPEGImages/000012.jpg"
                name = line[line.rindex("/") + 1:line.rindex('"')]
            elif _BOX.match(line[:16]):
                i = int(_OBJ.search(line).group(1))
                x0, y0, x1, y1 = (int(v) for v in
                                  _COORD.search(line).groups())
                boxes[i] = (x0, y0, x1 - x0, y1 - y0)
    return [(name, *boxes[i]) for i in sorted(boxes)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    for path in sorted(glob.glob(os.path.join(argv[0], "*.txt"))):
        for name, x, y, w, h in extract(path):
            print(f"{name} {x} {y} {w} {h}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
