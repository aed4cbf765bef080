"""bin/scdfmt twin on the PyTorch port: scddetect output lines to the FDDB
ellipse submission format (reference: bin/scdfmt.rb).

    python -m ccv_tpu_torch.bin.scdfmt < detections.txt

stdin lines of two forms:
  "<path> <count>"            -> "<dir>/<basename-sans-ext>\\n<count>"
  "<x> <y> <w> <h> <conf>"    -> "<major> <minor> 0 <cx> <cy> <conf>"
     where major = w/2, minor = h/2*1.6 (rounded), center = (x + w/2,
     y + h*0.3): the face-box to head-ellipse mapping of scdfmt.rb:15.
Other lines are dropped. Plain text: no device.
"""

import os
import sys


def convert(line: str):
    args = line.split()
    if len(args) == 2:
        d = os.path.dirname(args[0])
        b = os.path.splitext(os.path.basename(args[0]))[0]
        return f"{d}/{b}\n{args[1]}"
    if len(args) == 5:
        x, y, w, h = (int(v) for v in args[:4])
        conf = float(args[4])
        return (f"{round(w / 2)} {round(h / 2 * 1.6)} 0 "
                f"{round(x + w / 2)} {round(y + h * 0.3)} {conf}")
    return None


def main() -> int:
    for line in sys.stdin:
        out = convert(line)
        if out is not None:
            print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
