"""bin/csvtool.py twin (reference: bin/nnc/csv.c): parse a CSV into the
port's dataframe, iterate every row, and print the timings.

    python -m ccv_tpu_torch.bin.csvtool <file.csv>

Host only: the rows stay numpy (the reference's csv tool copies nothing
to a device).
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

from ccv_tpu_torch.nn.dataframe import Dataframe


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 1:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.time()
    df = Dataframe.from_csv(argv[0], header=False)
    cols = df.columns
    print(f"Dataframe.from_csv {int((time.time() - t0) * 1000)} ms "
          f"({df.n} rows x {len(cols)} columns)")
    t0 = time.time()
    n = 0
    for _row in df.iter(cols, batch_size=1, device_put=False):
        n += 1
    print(f"iter_next {int((time.time() - t0) * 1000)} ms ({n} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
