"""stat_fish's NuSeT segmentation of a folder:
``pipelines.stat_fish.segment_folder(model, paths, nuclei_size_t)``, the
segmentation loop that ``make stat_fish`` runs, with its defaults (NuSeT's
prep and foreground norm on the card, the certified device watershed,
the device cleanup).

The folder is the mix's RGB images written as uncompressed TIFFs; the
program reads each from disk on its reader threads and yields (path, the
8-bit image, the uint8 {0, 255} nuclei mask) of each image.  A unit of
work is one call of ``segment_folder`` over the whole folder; stat_fish's
tails (min-cut, matched filter, statistics, writes) are left out.

The check keeps a seeded uniform sample of the window's masks (a
reservoir, so nothing is copied in the window) and compares each with the
reference on the same image: the mask pixels that differ, summed over the
sample, and the largest difference of the number of 4-connected nuclei.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy import ndimage as ndi

from portbench import images, nuset_arith
from portbench.sampling import Reservoir


class Driver:
    def __init__(self, run):
        self.run = run
        self.kept = Reservoir(run.cfg["check"]["images"], run.seed)  # (source index, mask)

    def setup(self) -> None:
        # first: a program without the folder entry point fails here, before any work
        from ecseg_torch.pipelines.stat_fish import segment_folder

        from ecseg_torch.models.nuset import NuSeTRPN, NuSeTUNet
        from ecseg_torch.models.nuset_infer import NuSeTModel
        from ecseg_torch.runtime.hostmem import tune_host_allocator

        tune_host_allocator()  # as the program's entry points do first
        run, cfg, mix = self.run, self.run.cfg, self.run.traffic
        self.weights = run.weights_module.make(cfg, run.seed, run.device)
        nets = {"whole": NuSeTUNet(), "fg": NuSeTUNet(),
                "rpn": NuSeTRPN(len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"]))}
        for tag, net in nets.items():
            net.load_state_dict(self.weights[tag])
            nets[tag] = net.to(run.device).eval()
        self.model = NuSeTModel(unet_whole=nets["whole"], unet_fg=nets["fg"], rpn_fg=nets["rpn"],
                                nms_threshold=cfg["nms_threshold"], bbox_min_score=cfg["min_score"],
                                resize_scale=cfg["scale_ratio"])
        self.sources = images.folder(mix, run.seed)
        self.paths = images.write_folder(self.sources, os.path.join(run.workdir, "in"))
        self.index = {p: k for k, p in enumerate(self.paths)}
        self.segment_folder = segment_folder
        # the mix's first images build and load every kernel of a pass (one geometry)
        self._pass(self.paths[: mix["warmup_images"]], keep=False)

    def _pass(self, paths, keep: bool) -> int:
        done = 0
        for path, _, mask in self.segment_folder(self.model, paths, self.run.cfg["nuclei_size_T"]):
            done += 1
            if keep:
                self.kept.add((self.index[path], mask))
        return done

    def step(self) -> int:
        """One pass over the folder: each image's nuclei mask, yielded by the program."""
        return self._pass(self.paths, keep=True)

    def close(self) -> None:
        del self.model
        if self.run.device != "cpu":
            torch.cuda.empty_cache()

    def facts(self) -> Dict:
        cfg, mix = self.run.cfg, self.run.traffic
        h, w = nuset_arith.prep_shape(mix["height"], mix["width"], cfg["scale_ratio"])
        return {"nuset_forward_rows": nuset_arith.forward_rows(cfg, h, w),
                "nuset_flops_per_image": nuset_arith.image_flops(cfg, h, w)}

    def readings(self, control: bool = False) -> Tuple[Dict[str, int], Optional[Dict[str, int]]]:
        """The compared numbers of the kept masks against the reference: the
        mask pixels that differ, summed over the sample, and the largest
        difference of the number of 4-connected nuclei; with ``control``
        also those of the reference in TF32 in the program's place."""
        ref, cfg = self.run.reference, self.run.cfg
        prog = {"mask_px_differ": 0, "nuclei_count_differ": 0}
        ctl = dict(prog) if control else None

        def add(out, mask, want):
            out["mask_px_differ"] += int(np.count_nonzero(mask != want)) if mask.shape == want.shape else int(want.size)
            out["nuclei_count_differ"] = max(out["nuclei_count_differ"], abs(ndi.label(mask)[1] - ndi.label(want)[1]))

        for k, mask in self.kept.items:
            want = ref.segment(self.weights, self.sources[k], cfg)
            add(prog, mask, want)
            if control:
                add(ctl, ref.segment(self.weights, self.sources[k], cfg, tf32=True), want)
        return prog, ctl
