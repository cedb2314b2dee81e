"""CSV output without pandas (twin of the JAX package's
``DataFrame.to_csv(path, index=False)`` calls).  Imports neither torch nor
numpy, so the host-only fish_distance tool starts without them."""

from __future__ import annotations

import csv
from typing import Sequence


def write_csv(path: str, header: Sequence[str], rows) -> None:
    """Byte-equal to pandas' ``DataFrame(rows, columns=header).to_csv(path,
    index=False)`` for str, int and float cells and tuples of ints and
    floats (written as ``str`` writes them, e.g. ``"(1, 100)"``):
    comma-separated, minimal quoting, ``\\n`` line ends."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)
