"""bin/dpmvldtr.rb twin on the PyTorch port: the Pascal-VOC-annotation
detection rate.

    python -m ccv_tpu_torch.bin.dpmvldtr <voc-annotation-dir> <estimate-file>

<voc-annotation-dir> holds Pascal-VOC .txt annotations ("Image filename"
and "Bounding box for object N" lines). <estimate-file> lines are
"<image> <x> <y> <width> <height> [conf]" (`|`-prefixed lines skipped).
A detection matches when the intersection exceeds half the larger area,
duplicates ignored (dpmvldtr.rb:54-66; ``utils.deteval.overlap_score``).
Prints "RATE% (FA)". Plain text: no device. ``icfvldtr`` is the same tool.
"""

import sys

from ccv_tpu_torch.bin.icfvldtr import main, parse_estimates, parse_voc_dir

__all__ = ["main", "parse_estimates", "parse_voc_dir"]

if __name__ == "__main__":
    sys.exit(main())
