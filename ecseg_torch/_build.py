"""Build the port's CUDA kernels (``csrc/*.cu``) with ``nvcc`` at first use.

Each source becomes its own shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  All sources
are compiled at once, one ``nvcc`` process each, into a directory named by a
hash of the sources and flags under ``build/kernels/`` beside the package
(listed in ``.gitignore``), so a rebuilt checkout never loads a stale
library.  A failed build raises with ``nvcc``'s stderr.  No source is
compiled with ``--use_fast_math``: B10 (``fused_tail.cu``) needs IEEE
``expf`` and division.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "kernels")
SOURCES = ("stitch.cu", "cc_label.cu", "cc_flood.cu", "cc_count.cu", "fused_tail.cu", "convt.cu")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, str]:
    """Compile every source not yet built; returns source -> library path."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    os.makedirs(out_dir, exist_ok=True)
    libs = {src: os.path.join(out_dir, f"lib{src[:-3]}.so") for src in SOURCES}
    todo = [(src, so) for src, so in libs.items() if not os.path.exists(so)]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = []
    for src, so in todo:
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    errors = []
    for src, so, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {src} (exit {proc.returncode}) ---\n{out}{err}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent build sees all or none
    if errors:
        raise RuntimeError("nvcc failed to build the CUDA kernels:\n" + "\n".join(errors))
    return libs


def library(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>`` (builds on first use)."""
    with _lock:
        if not _libs:
            for src, path in build_all().items():
                _libs[src] = ctypes.CDLL(path)
        return _libs[source]
