"""Train or fine-tune the metaseg U-Net on a metaseg-format folder, on the
card (the port's counterpart of ``scripts/train_metaseg.py``):

    python -m ecseg_torch.pipelines.train_metaseg --inpath example_ecSeg \\
        --steps 200 --batch 16 --lr 1e-4 [--remat] [--bf16] \\
        --out models/metaseg.npz

Data: ``<inpath>/*.tif`` + ``<inpath>/labels/*.npy`` (what metaseg writes),
random 256^2 crops with flip and rotation augmentation
(``runtime/data.py``).  Each step is ``runtime/train.train_step`` with
Adam; checkpoints are ``<ckpt-dir>/step_%08d.pt`` every ``--ckpt-every``
steps (``runtime/checkpoint.py``); the final weights are exported as the
``metaseg.npz`` parameter tree that both packages' ``load_model`` read.

The step trains over ``parallel/mesh.make_mesh`` of every card (data axis
only, as the JAX script's ``make_mesh()``): ``runtime/train.train_step_on_mesh``
splits each batch over the cards and sums the gradients.  Each batch is
padded to a multiple of the data axis with zero samples that the ``valid``
mask keeps out of the loss; checkpoints and the export are gathered into the
single-device layout, so a run resumes and serves on one card.  From Python,
``main(argv, device="cpu")`` trains on one device and
``main(argv, devices=[...])`` on that list (repeated entries: a logical
mesh).

The initial weights are ``MetasegUNet``'s glorot-uniform draw from a torch
generator seeded with ``--seed``; the JAX script draws from
``PRNGKey(seed)``, so the two start from different weights.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import DeviceLike, DevicesLike, entry_devices
from ..models.metaseg_unet import MetasegUNet
from ..models.weights import params_to_numpy, save_npz
from ..parallel.mesh import make_mesh
from ..runtime import checkpoint as ckpt
from ..runtime.data import crop_batches, load_training_pairs, pad_to_multiple
from ..runtime.train import gather_params, train_step_on_mesh


def main(argv=None, device: DeviceLike = None, devices: DevicesLike = None) -> int:
    ap = argparse.ArgumentParser(description="Train the metaseg U-Net on a metaseg-format folder.")
    ap.add_argument("--inpath", default="example_ecSeg")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints/metaseg")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--out", default="models/metaseg.npz")
    ap.add_argument("--widths", type=int, nargs="+", default=None)
    ap.add_argument("--bottleneck", type=int, default=None)
    args = ap.parse_args(argv)
    mesh = make_mesh(entry_devices(device, devices))

    pairs = load_training_pairs(args.inpath)
    if not pairs:
        print(f"no (image, labels/) training pairs under {args.inpath}")
        return 2
    print(f"{len(pairs)} training images")

    kw = {}
    if args.widths:
        kw["widths"] = tuple(args.widths)
    if args.bottleneck:
        kw["bottleneck"] = args.bottleneck
    model = MetasegUNet(generator=torch.Generator().manual_seed(args.seed), **kw)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    step_fn = train_step_on_mesh(mesh, model, args.lr, dtype=dtype, remat=args.remat)
    n_dev = mesh.shape["data"]

    for step, (x, y) in enumerate(crop_batches(pairs, args.batch, args.steps, seed=args.seed)):
        x, n = pad_to_multiple(x, n_dev)
        y, _ = pad_to_multiple(y, n_dev)
        valid = np.arange(len(x)) < n
        loss = step_fn(x, y, valid)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {float(loss):.4f}")
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            print("checkpoint:", ckpt.save_checkpoint(args.ckpt_dir, step + 1, *step_fn.gather()))

    save_npz(args.out, params_to_numpy(gather_params(step_fn.model)))
    print("exported weights:", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
