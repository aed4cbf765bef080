"""bin/cnnvldtr twin: top-1 and top-5 missing rates of cnnclassify output.

    python -m ccv_tpu_torch.bin.cnnvldtr <truth-file> <result-file>

<truth-file>: one class id per line. <result-file>: cnnclassify's output,
"id conf id conf ..." per line (lines starting "elapsed" are skipped).
Prints "M1% (1), M5% (5)".
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

from ccv_tpu_torch.utils.deteval import topk_miss


def rates(truth_path: str, result_path: str) -> Tuple[float, float]:
    """(top-1, top-5) missing rates of the result file against the truth."""
    with open(truth_path) as f:
        truth = [int(line.split()[0]) for line in f if line.strip()]
    ranks: List[List[int]] = []
    with open(result_path) as f:
        for line in f:
            toks = line.split()
            if not toks or toks[0] == "elapsed":
                continue
            ranks.append([int(t) for t in toks[0::2][:5]])
    return topk_miss(truth, ranks)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    m1, m5 = rates(*argv)
    print(f"{round(m1 * 10000) / 100.0}% (1), "
          f"{round(m5 * 10000) / 100.0}% (5)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
