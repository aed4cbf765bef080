"""bin/swtvldtr.rb twin on the PyTorch port: DetEval precision and recall
of text detection.

    python -m ccv_tpu_torch.bin.swtvldtr <truth-file> <estimate-file>

Both files use the rb format: a filename line, then one "x y w h" line a
rect (``utils.deteval.parse_rect_file``, ``deteval``). Prints the three
lines of the reference tool. Plain text: no device.
"""

import sys

from ccv_tpu_torch.utils.deteval import deteval, parse_rect_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    precision, recall = deteval(parse_rect_file(argv[0]),
                                parse_rect_file(argv[1]))
    hmean = (2.0 * precision * recall / (precision + recall)
             if precision + recall else 0.0)
    print(f"precision: {round(precision * 10000) / 100}%")
    print(f"recall: {round(recall * 10000) / 100}%")
    print(f"harmonic mean: {round(hmean * 10000) / 100}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
