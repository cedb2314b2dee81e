"""Convert the NuSeT TF1 checkpoints (``whole_norm.ckpt`` and
``foreground.ckpt``, restored by the reference at src/utils.py:94-101) into
``models/nuset.npz``, which ``models/weights.load_nuset_model`` reads, with
no TensorFlow: the checkpoints are read by ``core/tfbundle.py``.  The
counterpart of ``scripts/convert_tf1_ckpt.py``, with its arguments,
defaults, name mapping and output::

    python -m ecseg_torch.convert_tf1_ckpt [CKPT_DIR] [OUT]   # models/nuset models/nuset.npz

Variable names (the TF1 graph of reference src/utils.py:48,74):

- ``model_U-Net/conv{L}-{i}/{kernel,bias}`` -> ``unet["conv{L}-{i}"]``;
- ``model_U-Net/conv2d_transpose{,_1,_2,_3}/...`` ->
  ``unet["deconv{4,3,2,1}"]``, the kernel from TF's (H, W, out, in) to
  HWIO;
- ``model_U-Net/final/kernel`` -> ``unet["final"]`` (no bias);
- ``model_RPN/rpn_conv/3x3/...``, ``rpn_cls_score/...``,
  ``rpn_bbox_pred/...`` -> ``rpn["rpn_conv"]``, ... (another RPN scope
  raises ``ValueError``).

Only ``kernel`` and ``bias`` leaves are kept: Adam's slots,
``beta1_power``, ``beta2_power`` and ``global_step`` are dropped unread.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List

import numpy as np

from .core.tfbundle import CheckpointReader
from .models.weights import save_npz

DECONV_NAMES = {"conv2d_transpose": "deconv4", "conv2d_transpose_1": "deconv3", "conv2d_transpose_2": "deconv2",
                "conv2d_transpose_3": "deconv1"}
RPN_NAMES = ("rpn_conv", "rpn_cls_score", "rpn_bbox_pred")


def _leaves(names: List[str], scope: str):
    """(name, layer, leaf) of the kernel and bias variables under ``scope``."""
    for name in names:
        parts = name.split("/")
        if name.startswith(scope + "/") and parts[-1] in ("kernel", "bias"):
            yield name, parts[1], parts[-1]


def map_unet(names: List[str], get: Callable[[str], np.ndarray]) -> Dict:
    unet: Dict = {}
    for name, layer, leaf in _leaves(names, "model_U-Net"):
        value = get(name)
        if layer in DECONV_NAMES:
            layer = DECONV_NAMES[layer]
            if leaf == "kernel":
                value = np.transpose(value, (0, 1, 3, 2))  # (H, W, out, in) -> HWIO
        unet.setdefault(layer, {})[leaf] = value
    return unet


def map_rpn(names: List[str], get: Callable[[str], np.ndarray]) -> Dict:
    rpn: Dict = {}
    for name, layer, leaf in _leaves(names, "model_RPN"):
        key = next((k for k in RPN_NAMES if layer.startswith(k)), None)
        if key is None:
            raise ValueError(f"unrecognized RPN variable scope {name!r}: an npz silently missing RPN weights "
                             "would only fail at forward time")
        rpn.setdefault(key, {})[leaf] = get(name)
    return rpn


def read_nuset(ckpt_dir: str) -> Dict:
    """The ``{"whole", "fg": {"unet", "rpn"}}`` tree of the two checkpoints
    under ``ckpt_dir``."""
    whole = CheckpointReader(f"{ckpt_dir}/whole_norm.ckpt")
    fg = CheckpointReader(f"{ckpt_dir}/foreground.ckpt")
    whole_names, fg_names = sorted(whole.get_variable_to_shape_map()), sorted(fg.get_variable_to_shape_map())
    return {"whole": map_unet(whole_names, whole.get_tensor),
            "fg": {"unet": map_unet(fg_names, fg.get_tensor), "rpn": map_rpn(fg_names, fg.get_tensor)}}


def convert(ckpt_dir: str, out_path: str) -> None:
    save_npz(out_path, read_nuset(ckpt_dir))
    print(f"wrote {out_path}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    convert(argv[0] if len(argv) > 0 else "models/nuset", argv[1] if len(argv) > 1 else "models/nuset.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
