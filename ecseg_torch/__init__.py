"""ecseg_torch: the PyTorch/CUDA port of ecseg_tpu for NVIDIA Hopper (H100).

The package sits beside ``ecseg_tpu`` (the JAX reference it is held against)
and keeps the same task interface, folder layout and output bytes.  Rules:

- it imports ``torch``, never ``jax``, and nothing of ``ecseg_tpu`` -- not
  even that package's JAX-free host modules, since importing any of them runs
  ``ecseg_tpu/ops/__init__.py`` and so JAX.  The host code it needs is kept
  here as its own copy (``core/``, ``ops/cc.py``, ``ops/morphology.py``,
  ``ops/meta_post.py``, ``ops/region_stats.py``, ``ops/conv_host.py``,
  ``csrc/cc_maxflow.cpp``, ``runtime/``);
- entry points take an explicit ``device``; the tasks with a
  multi-device path also take ``devices`` (a device list).  ``None`` means
  the CUDA card (for those tasks: every CUDA card) and raises when no CUDA
  device is present (see :mod:`ecseg_torch.device`).  There is no silent
  CPU path: tests pass ``device="cpu"`` or ``devices=["cpu"] * n``;
- every TPU (Pallas) kernel on a ported path is a hand-written CUDA kernel
  under ``csrc/`` with a plain PyTorch twin beside its wrapper
  (``ops/cc_kernels.py``).  A CPU tensor goes to the twin, a CUDA tensor to
  the kernel.

Ported so far: the metaseg task (``pipelines/metaseg.py``), with its
post-processing in each form the JAX package's ``ECSEG_MC_LABEL`` and
``ECSEG_MC_MERGE`` select (the multiclass form by default); meta_overlay
(``pipelines/meta_overlay.py``) and fish_distance_calculation
(``pipelines/fish_distance.py``, host only); stat_fish
(``pipelines/stat_fish.py``: NuSeT, the certified watershed on B3, the
cleanup on B2, min-cut and the matched filter); interseg
(``pipelines/interseg.py``); training (``pipelines/train_metaseg.py``);
bench.py's per-tile count (``pipelines/tile_count.py``); the multi-device
paths: the (data, model) mesh (``parallel/mesh.py``) and its train step,
metaseg's sharded folder paths and the fan-outs of meta_overlay, stat_fish
and interseg; and the benchmarks: ``python -m ecseg_torch.bench`` (bench.py's
tile and full-pipeline programs and JSON lines) and ``python -m
ecseg_torch.bench_stat_fish`` (scripts/bench_stat_fish.py).
"""
