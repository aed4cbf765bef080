"""bin/bbfvldtr.rb twin on the PyTorch port: the CMU-annotation face
detection rate.

    python -m ccv_tpu_torch.bin.bbfvldtr <cmu-truth-file> <estimate-file>

Truth lines: "<image> lx ly rx ry nx ny lmx lmy cmx cmy rmx rmy" (the six
face landmarks). Estimate lines: "<image> <x> <y> <width> <height>". A
detection is a true positive when all six landmarks fall inside the
1.5x-relaxed box (bbfvldtr.rb:31-58; ``utils.deteval.cmu_face_score``).
Prints "RATE% (FA)". Plain text: no device.
"""

import sys

from ccv_tpu_torch.utils.deteval import cmu_face_score

KEYS = ("left_eye", "right_eye", "nose", "left_mouth", "center_mouth",
        "right_mouth")


def parse_truth(path):
    """Image name (lower case, no extension) -> its faces' landmarks."""
    truth = {}
    with open(path) as f:
        for line in f:
            args = line.split()
            if len(args) < 13:
                continue
            name = args[0].split(".")[0].lower()
            vals = [float(v) for v in args[1:13]]
            truth.setdefault(name, []).append(
                {k: dict(x=vals[2 * i], y=vals[2 * i + 1])
                 for i, k in enumerate(KEYS)})
    return truth


def parse_estimates(path):
    """Image name (lower case, no extension) -> its detections."""
    est = {}
    with open(path) as f:
        for line in f:
            args = line.split()
            if len(args) < 5:
                continue
            name = args[0].split(".")[0].lower()
            est.setdefault(name, []).append(dict(
                x=float(args[1]), y=float(args[2]),
                width=float(args[3]), height=float(args[4])))
    return est


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    tp, fa, total = cmu_face_score(parse_truth(argv[0]),
                                   parse_estimates(argv[1]))
    print(f"{round(tp / max(total, 1) * 10000) / 100.0}% ({fa})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
