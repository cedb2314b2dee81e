"""metaseg on a folder: ``pipelines.metaseg.segment_folder(model, paths)``,
the path ``make metaseg`` runs, with its default grouping and device post.

The folder is the mix's images written as uncompressed TIFFs; the
program reads each from disk, writes its DAPI PNG beside it and yields
(path, labels, #ecDNA) of each image.
A unit of work is one call of ``segment_folder`` over the whole folder, as
``make metaseg`` runs a folder: its grouping, and the flush of a partial
last group, are the program's own, and the unit repeats the same device
work.  ``main``'s label PNG and int64 ``.npy`` writes are left out (the
configuration's ``write_labels``).

The check keeps a seeded uniform sample of the window's answers (a
reservoir, so nothing is copied in the window) and compares each with the
reference on the same image: the pixels whose final label differs, summed
over the sample, and the largest difference of an ecDNA count.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench import arith, images
from portbench.sampling import Reservoir


class Driver:
    def __init__(self, run):
        if run.cfg.get("write_labels", True):
            raise ValueError("portbench: metaseg_folder leaves main's label writes out; the configuration must say so")
        self.run = run
        self.kept = Reservoir(run.cfg["check"]["images"], run.seed)  # (source index, labels, #ecDNA)

    def setup(self) -> None:
        from ecseg_torch.models.metaseg_unet import MetasegUNet
        from ecseg_torch.pipelines import metaseg
        from ecseg_torch.runtime.hostmem import tune_host_allocator

        tune_host_allocator()  # as the program's entry points do first
        run, cfg, mix = self.run, self.run.cfg, self.run.traffic
        self.weights = run.weights_module.make(cfg, run.seed, run.device)
        model = MetasegUNet(cfg["widths"], cfg["bottleneck"], cfg["in_channels"], cfg["num_classes"])
        model.load_state_dict(self.weights)
        self.model = model.to(run.device).eval()
        self.sources = images.folder(mix, run.seed)
        folder = os.path.join(run.workdir, "in")
        self.paths = images.write_folder(self.sources, folder)
        os.makedirs(os.path.join(folder, "dapi"))
        self.index = {p: k for k, p in enumerate(self.paths)}
        self.segment_folder = metaseg.segment_folder
        # the mix's first images hold every shape of a pass: they build and load its kernels
        self._pass(self.paths[: mix["warmup_images"]], keep=False)

    def _pass(self, paths, keep: bool) -> int:
        done = 0
        for path, labels, num in self.segment_folder(self.model, paths):
            done += 1
            if keep:
                self.kept.add((self.index[path], labels, num))
        return done

    def step(self) -> int:
        """One pass over the folder: each image's labels and count, yielded by the program."""
        return self._pass(self.paths, keep=True)

    def close(self) -> None:
        del self.model
        if self.run.device != "cpu":
            torch.cuda.empty_cache()

    def facts(self) -> Dict:
        cfg, mix = self.run.cfg, self.run.traffic
        return {"patches_per_image": arith.patch_count(mix["height"], mix["width"], cfg["overlap"], cfg["patch"]),
                "rows": arith.metaseg_rows(cfg)}

    def readings(self, control: bool = False) -> Tuple[Dict[str, int], Optional[Dict[str, int]]]:
        """The compared numbers of the kept answers against the reference:
        the label pixels that differ, summed over the sample, and the
        largest difference of an ecDNA count; with ``control`` also those
        of the reference in TF32 in the program's place."""
        ref, cfg = self.run.reference, self.run.cfg
        prog = {"label_px_differ": 0, "ec_count_differ": 0}
        ctl = dict(prog) if control else None

        def add(out, labels, num, want_labels, want_num):
            out["label_px_differ"] += int(np.count_nonzero(labels != want_labels))
            out["ec_count_differ"] = max(out["ec_count_differ"], abs(int(num) - int(want_num)))

        for k, labels, num in self.kept.items:
            want = ref.segment(self.weights, self.sources[k], cfg)
            add(prog, labels, num, *want)
            if control:
                add(ctl, *ref.segment(self.weights, self.sources[k], cfg, tf32=True), *want)
        return prog, ctl
