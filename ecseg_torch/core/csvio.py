"""CSV input and output without pandas (twins of the JAX package's
``DataFrame.to_csv(path, index=False)`` calls and of interseg's
``pd.read_csv(path, keep_default_na=False, na_values=["_"])``).  Imports
neither torch nor numpy, so the host-only fish_distance tool starts without
them."""

from __future__ import annotations

import csv
import dataclasses
import math
import re
from typing import Dict, List, Sequence


def write_csv(path: str, header: Sequence[str], rows) -> None:
    """Byte-equal to pandas' ``DataFrame(rows, columns=header).to_csv(path,
    index=False)`` for str, int and float cells and tuples of ints and
    floats (written as ``str`` writes them, e.g. ``"(1, 100)"``):
    comma-separated, minimal quoting, ``\\n`` line ends."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


# what pandas' C parser converts, cell by cell, tried in this order; a
# column takes the first kind that every one of its cells parses as
_INT = re.compile(r"\s*[-+]?[0-9]+\s*\Z")
_FLOAT = re.compile(r"\s*[-+]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][-+]?[0-9]+)?|inf|infinity)\s*\Z", re.IGNORECASE)
_BOOL = {**dict.fromkeys(("True", "TRUE", "true"), True), **dict.fromkeys(("False", "FALSE", "false"), False)}
NA = "_"  # the one NA marker: ``na_values=["_"]`` with ``keep_default_na=False``
_INT64 = (-(2**63), 2**63 - 1)


@dataclasses.dataclass
class Column:
    """One column as pandas infers it: ``dtype`` is ``"int64"``,
    ``"float64"``, ``"bool"`` or ``"str"``; ``values`` are Python ints,
    floats (NaN for ``_``), bools or strings (NaN for ``_``)."""

    dtype: str
    values: list

    def __len__(self) -> int:
        return len(self.values)


def _column(cells: List[str]) -> Column:
    """pandas' dtype inference for one column.  Floats are parsed with
    ``float()``, which rounds correctly; pandas' own converter does not
    always (a last-bit difference, documented in ROADMAP §C)."""
    if not cells:
        return Column("str", [])
    present = [c for c in cells if c != NA]
    if present and len(present) == len(cells) and all(_INT.match(c) for c in cells):
        ints = [int(c) for c in cells]
        if not all(_INT64[0] <= v <= _INT64[1] for v in ints):
            raise ValueError("an integer column outside int64, which this reader does not take")
        return Column("int64", ints)
    if all(_FLOAT.match(c) for c in present):
        return Column("float64", [math.nan if c == NA else float(c) for c in cells])
    if present and len(present) == len(cells) and all(c in _BOOL for c in cells):
        return Column("bool", [_BOOL[c] for c in cells])
    return Column("str", [math.nan if c == NA else c for c in cells])


def read_csv(path: str) -> Dict[str, Column]:
    """``pd.read_csv(path, keep_default_na=False, na_values=["_"])`` for a
    file with a header row and unique column names: blank lines are
    skipped, ``_`` is NaN, an empty cell stays the empty string (so it makes
    its column ``str``), and each column is int64 when every cell is an
    integer, else float64 when every cell is a number or ``_``, else bool
    when every cell is ``True``/``False``, else str.  A header-only file
    gives empty ``str`` columns.  Column name -> :class:`Column`, in file
    order."""
    with open(path, newline="", encoding="utf-8") as f:
        records = [r for r in csv.reader(f) if r]
    if not records:
        raise ValueError(f"{path}: no columns to parse from file")
    header, body = records[0], records[1:]
    if len(set(header)) != len(header):
        raise ValueError(f"{path}: duplicate column names {header}")
    for n, r in enumerate(body, 2):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {n} has {len(r)} fields, the header {len(header)}")
    # a short row is padded with empty cells, as pandas pads it here
    cols = [[r[k] if k < len(r) else "" for r in body] for k in range(len(header))]
    return {name: _column(cells) for name, cells in zip(header, cols)}
