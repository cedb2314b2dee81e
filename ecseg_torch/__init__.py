"""ecseg_torch: the PyTorch/CUDA port of ecseg_tpu for NVIDIA Hopper (H100).

The package sits beside ``ecseg_tpu`` (the JAX reference it is held against)
and keeps the same task interface, folder layout and output bytes.  Rules:

- it imports ``torch``, never ``jax``, and nothing of ``ecseg_tpu`` -- not
  even that package's JAX-free host modules, since importing any of them runs
  ``ecseg_tpu/ops/__init__.py`` and so JAX.  The host code it needs is kept
  here as its own copy (``core/``, ``ops/cc.py``, ``ops/morphology.py``,
  ``ops/meta_post.py``, ``runtime/``);
- entry points take an explicit ``device``; ``None`` means ``"cuda"`` and
  raises when no CUDA device is present (see :mod:`ecseg_torch.device`).
  There is no silent CPU path: tests pass ``device="cpu"``;
- every TPU (Pallas) kernel on a ported path is a hand-written CUDA kernel
  under ``csrc/`` with a plain PyTorch twin beside its wrapper
  (``ops/cc_kernels.py``).  A CPU tensor goes to the twin, a CUDA tensor to
  the kernel.

Ported so far: the metaseg task (``pipelines/metaseg.py``) in the per-class
post-processing form.
"""
