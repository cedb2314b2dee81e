"""Write deterministic demo weights for every model the port's pipelines load,
and the example inputs of README's end-to-end demo (the port's
counterpart of ``scripts/make_demo_weights.py``, without cv2 or JAX).

    python -m ecseg_torch.make_demo_weights [--model-dir models]
                                            [--interseg-dir interseg_models]
                                            [--no-inputs] [--force]

Paths are relative to the working directory.  Produces:

  models/metaseg.npz            -> read by ``python -m ecseg_torch.pipelines.metaseg``
  models/nuset.npz              -> read by ``...pipelines.stat_fish``
  interseg_models/interseg.npz, interseg_models/ecseg_c.npz
                                -> read by ``...pipelines.interseg``

in the JAX package's flat ``"layer/kernel"`` npz layout, so either package
reads them.  The trees are ``models/demo.py``'s: the crafted entries
(metaseg's level-1 convs and head, NuSeT's level-1 convs and final conv)
and both classifier trees equal the JAX script's bit for bit; the deep
layers of the metaseg and NuSeT U-Nets and the RPN keep the port's own
seeded init (torch generators seeded 0), which differs from the JAX
package's ``PRNGKey`` draws.  An existing weight file (a real converted
checkpoint, say) is kept unless ``--force`` is given.

Unless ``--no-inputs`` is given, the missing example inputs are written
too, with the JAX script's generators and pixel arithmetic, as LZW TIFFs
whose bytes equal ``cv2.imwrite``'s: ``example_interSeg/cells.tif``
(uint16, three nuclei, red FISH foci and a green centromere spot in each;
BGR in memory, RGB in the file) and ``example_ecSeg/input.tif`` (uint8
RGB metaphase with a DAPI blob and a red and a green FISH patch).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .core import imgio


def write_demo_inputs() -> None:
    """The example inputs of ``scripts/make_demo_weights.py:27-60``, each
    only when missing."""
    os.makedirs("example_interSeg", exist_ok=True)
    path = os.path.join("example_interSeg", "cells.tif")
    if not os.path.exists(path):
        rng = np.random.default_rng(5)
        img = (rng.random((512, 640, 3)) * 2000).astype(np.uint16)
        yy, xx = np.mgrid[0:512, 0:640]
        for (y, x) in [(100, 120), (260, 300), (380, 480)]:
            inside = (yy - y) ** 2 + (xx - x) ** 2 < 45**2
            img[..., 0][inside] = 40000  # DAPI (BGR: blue)
            img[..., 2][inside] = 15000  # diffuse red (passes interseg's gate)
            for dy, dx in [(-12, -8), (6, 14), (15, -15)]:
                img[y + dy - 2 : y + dy + 2, x + dx - 2 : x + dx + 2, 2] = 60000
            img[y - 4 : y, x - 18 : x - 14, 1] = 60000  # green centromere
        imgio.write_tiff_lzw(path, img[..., ::-1])
        print("wrote", path)

    os.makedirs("example_ecSeg", exist_ok=True)
    path = os.path.join("example_ecSeg", "input.tif")
    if not os.path.exists(path):
        rng = np.random.default_rng(11)
        rgb = (rng.random((700, 900, 3)) * 12).astype(np.uint8)
        rgb[100:260, 120:300, 2] = 203  # DAPI blob (blue in the RGB read)
        rgb[150:170, 400:430, 0] = 235  # red FISH
        rgb[300:330, 500:540, 1] = 235  # green FISH
        imgio.write_tiff_lzw(path, rgb)
        print("wrote", path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-dir", default="models")
    ap.add_argument("--interseg-dir", default="interseg_models")
    ap.add_argument("--no-inputs", action="store_true", help="skip generating missing example_* input images")
    ap.add_argument(
        "--force",
        action="store_true",
        help="overwrite existing .npz weight files (by default existing weights -- "
        "e.g. real converted checkpoints -- are left untouched)",
    )
    args = ap.parse_args(argv)

    from .models import demo
    from .models.weights import params_to_numpy, save_npz

    if not args.no_inputs:
        write_demo_inputs()
    os.makedirs(args.model_dir, exist_ok=True)
    os.makedirs(args.interseg_dir, exist_ok=True)

    def write(out, tree_fn):
        if os.path.exists(out) and not args.force:
            print("kept existing", out, "(use --force to overwrite)")
            return
        save_npz(out, tree_fn())
        print("wrote", out)

    write(os.path.join(args.model_dir, "metaseg.npz"), lambda: params_to_numpy(demo.demo_metaseg_params()))
    write(os.path.join(args.model_dir, "nuset.npz"), demo.demo_nuset_tree)
    write(os.path.join(args.interseg_dir, "interseg.npz"), demo.demo_ecseg_i_tree)
    write(os.path.join(args.interseg_dir, "ecseg_c.npz"), demo.demo_ecseg_c_tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
