"""The rows of an on-chip study (``python -m ecseg_torch.profile_*`` and
``quantify_watershed_divergence``): each row runs one block of the port on
fixed seeded inputs and, on the card, reports :func:`devtime.split`'s host
wall, device time, device operations and host syncs (device rows) or the
host wall alone (host rows).  On the CPU (``main(device="cpu")``, for the
tests) each row runs once and reports its outputs with every time ``None``:
nothing measured on the CPU is printed as a device's number.

A study prints a human-readable line a row, then one JSON line
``{"study": ..., "card": "<name>, <power limit>", "rows": [...],
"launches": {...}}``; ``launches`` are the kernel wrappers' counts over the
whole study (``ops/cc_kernels.LAUNCHES``, set to 0 when the study starts).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops import cc_kernels
from . import devtime

TIMES = ("wall_ms", "device_ms", "ops", "syncs")


def no_card(study: str) -> bool:
    """True (after the message ``bench_stat_fish`` prints) when a study
    given no device finds no card."""
    if torch.cuda.is_available():
        return False
    print(f"{study}: no CUDA device is available; aborting without a result", file=sys.stderr, flush=True)
    return True


def opt(argv: Sequence[str], flag: str, default, cast=int, many: bool = False):
    """The value after ``flag`` in ``argv`` (``many``: every value up to the
    next flag, as a list), cast; ``default`` when the flag is absent."""
    argv = list(argv)
    if flag not in argv:
        return default
    vals = []
    for a in argv[argv.index(flag) + 1:]:
        if a.startswith("--"):
            break
        vals.append(cast(a))
        if not many:
            break
    return vals if many else vals[0]


def positional(argv: Sequence[str]) -> List[str]:
    """The arguments that are neither a flag nor a flag's values."""
    out, in_flag = [], False
    for a in argv:
        if a.startswith("--"):
            in_flag = True
        elif not in_flag:
            out.append(a)
    return out


def _fmt(v, spec: str, unit: str = "") -> str:
    return "not measured" if v is None else format(v, spec) + unit


class Study:
    """The rows of one study run on ``device``."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device
        self.timed = device.type == "cuda"
        self.card: Optional[str] = devtime.card() if self.timed else None
        self.rows: List[Dict] = []
        cc_kernels.reset_launches()
        if self.card:
            print(self.card, flush=True)

    def row(self, name: str, times: Optional[Dict] = None, quiet: bool = False, **fields) -> Dict:
        """Append and print a row: ``times`` (``TIMES`` keys; missing ones
        ``None``: not measured) and ``fields``."""
        row = {"name": name, **dict.fromkeys(TIMES), **(times or {}), **fields}
        self.rows.append(row)
        if not quiet:
            outs = " ".join(f"{k}={v}" for k, v in row.items() if k not in TIMES and k != "name")
            print(
                f"{name:34s} wall {_fmt(row['wall_ms'], '9.3f', ' ms')}  device {_fmt(row['device_ms'], '9.3f', ' ms')}"
                f"  ops {_fmt(row['ops'], 'g')}  syncs {_fmt(row['syncs'], 'g')}  {outs}".rstrip(),
                flush=True,
            )
        return row

    def _add(self, name: str, times: Dict, per: float, out, report: Optional[Callable], fields: Dict):
        times = {k: v if v is None else v / per for k, v in times.items()}
        self.row(name, times, **fields, **(report(out) if report else {}))
        return out

    def device_row(self, name: str, fn: Callable, reps: int = 3, per: float = 1, report: Optional[Callable] = None,
                   **fields) -> object:
        """Time ``fn`` with :func:`devtime.split` over ``reps`` calls (on
        the CPU: one call, no times; when every profiler pass lost records,
        the host wall alone and the reason); ``per`` divides every number (the
        units, canvases or cases, that one call runs).  ``report``: a dict
        of outputs from ``fn``'s result, printed beside the times with
        ``fields``.  Returns the last call's result."""
        last = []

        def call():
            last[:] = [fn()]

        if not self.timed:
            call()
            times = dict.fromkeys(TIMES)
        else:
            try:
                times = devtime.split(call, reps)
            except devtime.IncompleteProfile as e:  # the host wall alone: no device time from a partial pass
                times = {"wall_ms": devtime.wall_ms(call, reps)}
                fields = {**fields, "device_not_measured": str(e)}
        return self._add(name, times, per, last[0], report, fields)

    def host_row(self, name: str, fn: Callable, reps: int = 3, per: float = 1, report: Optional[Callable] = None,
                 **fields) -> object:
        """The host wall of ``fn`` (a host block), mean of ``reps`` calls
        after a warm-up; on the CPU one call and no time."""
        out = fn()
        times = dict.fromkeys(TIMES)
        if self.timed:
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            times["wall_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        return self._add(name, times, per, out, report, fields)

    def emit(self, **extra) -> Dict:
        """Print the study's JSON line and return it."""
        line = {"study": self.name, "card": self.card, "rows": self.rows,
                "launches": {k: v for k, v in cc_kernels.LAUNCHES.items() if v}, **extra}
        print(json.dumps(line), flush=True)
        return line
