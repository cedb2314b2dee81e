"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration, traffic mix and
metrics; everything else is found by those names under a search path of
roots (the ``portbench`` folder itself, and in tests a temporary folder
first):

- ``configs/<config>.json`` (or the configuration's ``file``): the model;
- ``weights/<config>.py``: ``make(cfg, seed, device)``, the weights;
- ``reference/<config>.py``: the plain reference;
- ``traffic/<mix>.json``: the mix's parameters, read by ``images.py``;
  its ``driver`` key names ``drivers/<driver>.py``, the window's driver;
- ``metrics/<metric>.py``: ``read(ctx)``, one metric.

A later cell adds files and entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

PKG = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(PKG)


def load_benchmark(path: Optional[str] = None) -> Dict:
    path = path or os.path.join(CHECKOUT, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["_dir"] = os.path.dirname(os.path.abspath(path))
    return bench


def _find(roots: Sequence[str], rel: str) -> str:
    for root in roots:
        path = os.path.join(root, rel)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"portbench: no {rel} under {list(roots)}")


def load_json(roots: Sequence[str], kind: str, name: str) -> Dict:
    with open(_find(roots, os.path.join(kind, name + ".json"))) as f:
        return json.load(f)


def load_module(roots: Sequence[str], kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots, so it is
    loaded from its file, not imported by name)."""
    path = _find(roots, os.path.join(kind, name + ".py"))
    mod_name = f"portbench._loaded.{kind}.{name}".replace("-", "_")
    if mod_name in sys.modules and sys.modules[mod_name].__file__ == path:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def workload(bench: Dict, name: str) -> Dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"portbench: no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, roots: Sequence[str]) -> Dict:
    """The configuration's file, as ``BENCHMARK.json``'s entry names it
    (relative to the benchmark's folder), else ``configs/<name>.json``."""
    for entry in bench["configs"]:
        if entry["name"] == name:
            path = entry["file"]
            if not os.path.isabs(path):
                path = os.path.join(bench["_dir"], path)
            with open(path) as f:
                return json.load(f)
    return load_json(roots, "configs", name)


def metrics(bench: Dict, wl: Dict, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    those that list the cell under ``workloads``; one without the key is
    the cell's if it is end-to-end, or if the end-to-end metric it moves is
    the cell's."""
    e2e = [m for m in bench["end_to_end"] if wl["name"] in m.get("workloads", [wl["name"]])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (wl["name"] in m["workloads"] if "workloads" in m else m["moves"] in mine)]
