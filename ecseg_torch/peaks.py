"""The cards' peak rates, keyed by ``torch.cuda.get_device_name``: the
figures that ``bench``'s ``forward_mfu``, ``profile_layers``' peak shares,
``roofline_forward``'s floors and ``chip_smoke.py``'s kernel bounds are
held against.  NVIDIA's data sheet for the H100 SXM: dense tensor-core
bf16 (no sparsity), float32 outside the tensor cores (the float32 paths
run with TF32 off), and HBM3's bandwidth."""

from __future__ import annotations

H100 = "NVIDIA H100 80GB HBM3"

PEAKS = {
    H100: {
        "part": "H100 SXM",
        "bfloat16": 989e12,  # FLOP/s
        "float32": 67e12,  # FLOP/s
        "hbm_bytes_per_s": 3.35e12,
    },
}
