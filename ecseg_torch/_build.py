"""Build the port's native code at first use: the CUDA kernels
(``csrc/*.cu``) with ``nvcc``, the host libraries (the TIFF LZW decoder
``csrc/tiff_lzw.cpp``; stat_fish's min-cut and priority-flood watershed
``csrc/cc_maxflow.cpp``; NuSeT's greedy NMS walk ``csrc/nms_walk.cpp``)
with the system C++ compiler.

Each source becomes its own shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  All CUDA
sources are compiled at once, one ``nvcc`` process each, into a directory
named by a hash of the sources and flags under ``build/kernels/`` beside
the package (listed in ``.gitignore``), so a rebuilt checkout never loads a
stale library; the host libraries likewise under ``build/host/``.  A failed
build raises with the compiler's output.  No source is compiled with
``--use_fast_math``: B10 (``fused_tail.cu``) needs IEEE ``expf`` and
division.
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
HOST_BUILD_ROOT = os.path.join(os.path.dirname(BUILD_ROOT), "host")
SOURCES = ("stitch.cu", "cc_label.cu", "cc_flood.cu", "cc_count.cu", "fused_tail.cu", "convt.cu", "conv3x3_f32.cu")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)
HOST_SOURCES = ("tiff_lzw.cpp", "cc_maxflow.cpp", "nms_walk.cpp")
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_host_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _digest(flags, suffixes) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith(suffixes):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _compile(find_compiler, flags, out_dir: str, sources, what: str) -> Dict[str, str]:
    """Compile each source not yet built in ``out_dir``, all at once, with
    the compiler ``find_compiler()`` names; returns source -> library path."""
    libs = {src: os.path.join(out_dir, f"lib{os.path.splitext(src)[0]}.so") for src in sources}
    todo = [(src, so) for src, so in libs.items() if not os.path.exists(so)]
    if not todo:
        return libs
    os.makedirs(out_dir, exist_ok=True)
    compiler = find_compiler()
    procs = []
    for src, so in todo:
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [compiler, *flags, "-I", CSRC, "-o", tmp, os.path.join(CSRC, src)]
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
        raise RuntimeError(f"{os.path.basename(compiler)} failed to build {what}:\n" + "\n".join(errors))
    return libs


def build_all() -> Dict[str, str]:
    """Compile every CUDA source not yet built; returns source -> library path."""
    out_dir = os.path.join(BUILD_ROOT, _digest(NVCC_FLAGS, (".cu", ".cuh")))
    return _compile(_nvcc, NVCC_FLAGS, out_dir, SOURCES, "the CUDA kernels")


def library(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>`` (builds on first use)."""
    with _lock:
        if not _libs:
            for src, path in build_all().items():
                _libs[src] = ctypes.CDLL(path)
        return _libs[source]


def _cxx() -> str:
    for name in ("c++", "g++", "clang++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (c++, g++ or clang++) found: it is needed to build the host libraries (csrc/*.cpp)")


def host_library(source: str) -> ctypes.CDLL:
    """The loaded host library built from ``csrc/<source>`` (builds on
    first use)."""
    with _lock:
        if source not in _host_libs:
            out_dir = os.path.join(HOST_BUILD_ROOT, _digest(HOST_FLAGS, (".cpp",)))
            path = _compile(_cxx, HOST_FLAGS, out_dir, HOST_SOURCES, "the host library")[source]
            _host_libs[source] = ctypes.CDLL(path)
        return _host_libs[source]
