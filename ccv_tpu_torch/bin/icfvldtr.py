"""bin/icfvldtr.rb twin on the PyTorch port (dpmvldtr's protocol):

    python -m ccv_tpu_torch.bin.icfvldtr <voc-annotation-dir> <estimate-file>

<voc-annotation-dir> holds Pascal-VOC .txt annotations ("Image filename"
and "Bounding box for object N" lines). <estimate-file> lines are
"<image> <x> <y> <width> <height> [conf]" (`|`-prefixed lines skipped).
A detection matches when the intersection exceeds half the larger area,
duplicates ignored (dpmvldtr.rb:54-66; ``utils.deteval.overlap_score``).
Prints "RATE% (FA)". Plain text: no device.
"""

import glob
import os
import re
import sys

from ccv_tpu_torch.utils.deteval import overlap_score


def parse_voc_dir(d):
    """Image name -> its annotated boxes (dicts of x, y, width, height)."""
    truth = {}
    for path in glob.glob(os.path.join(d, "*.txt")):
        name = None
        boxes = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                if line[:14].lower() == "image filename":
                    name = line[line.rindex("/") + 1:line.rindex('"')]
                if line[:16].lower() == "bounding box for":
                    i = int(re.search(r"object\s*(\d+)", line).group(1))
                    c = re.search(
                        r"\((\d+),\s*(\d+)\)\s*-\s*\((\d+),\s*(\d+)\)", line)
                    x0, y0, x1, y1 = (int(c.group(k)) for k in range(1, 5))
                    while len(boxes) < i:
                        boxes.append(None)
                    boxes[i - 1] = dict(x=x0, y=y0, width=x1 - x0,
                                        height=y1 - y0)
        truth[name] = [b for b in boxes if b]
    return truth


def parse_estimates(path):
    """Image name -> its detections (dicts of x, y, width, height)."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("|") or not line.strip():
                continue
            args = line.split()
            name = args[0].rsplit("/", 1)[-1]
            out.setdefault(name, []).append(dict(
                x=int(float(args[1])), y=int(float(args[2])),
                width=int(float(args[3])), height=int(float(args[4]))))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    tp, fa, total = overlap_score(parse_voc_dir(argv[0]),
                                  parse_estimates(argv[1]))
    print(f"{round(tp / max(total, 1) * 10000) / 100.0}% ({fa})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
