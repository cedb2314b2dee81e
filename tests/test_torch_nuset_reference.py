"""The port's NuSeT segmentation against the benchmark's plain reference
(``portbench/reference/nuset_unet_rpn.py``, loaded by path, with the
benchmark's seeded weights, ``portbench/weights/nuset_unet_rpn.py``):
``stat_fish.segment_folder`` on two seeded 320^2 interphase images (96^2
after the prep) gives the reference's masks; the reference's anchors,
decode and NMS on hand cases; and the reference imports nothing of the
program.  CPU only."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from ecseg_torch.models import nuset_infer
from ecseg_torch.models.nuset import NuSeTRPN, NuSeTUNet
from ecseg_torch.models.nuset_infer import NuSeTModel
from ecseg_torch.ops import boxes
from ecseg_torch.pipelines import stat_fish

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
SEED = 2**31 + 5


def _load(kind, name):
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"nuset_reference_test_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load("reference", "nuset_unet_rpn")


def _json(rel):
    with open(os.path.join(BENCH, rel)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(configuration, weights, the two source images, their paths, the port's model)."""
    from portbench import images

    cfg = dict(_json("configs/nuset_unet_rpn.json"), nuclei_size_T=200)
    mix = _json("traffic/interphase_rgb_2048.json")
    mix.update(images=2, height=320, width=320)
    mix["objects"][0].update(count=[3, 4], radius=[15, 25], margin=10)
    for obj in mix["objects"][1:]:
        obj.update(count=[3, 3])
    weights = _load("weights", "nuset_unet_rpn").make(cfg, SEED, "cpu")
    nets = {"whole": NuSeTUNet(), "fg": NuSeTUNet(), "rpn": NuSeTRPN(21)}
    for tag, net in nets.items():
        net.load_state_dict(weights[tag])
        net.eval()
    model = NuSeTModel(nets["whole"], nets["fg"], nets["rpn"], cfg["nms_threshold"], cfg["min_score"], cfg["scale_ratio"])
    sources = images.folder(mix, SEED)
    paths = images.write_folder(sources, str(tmp_path_factory.mktemp("interphase")))
    return cfg, weights, sources, paths, model


@pytest.mark.parametrize("device_prep", [False, True], ids=["host-prep", "device-prep"])
def test_segment_folder_equals_the_plain_reference(case, monkeypatch, device_prep):
    """Both preps: the readers' host chain (a CPU model's) and the card's
    float64 chain, which a CUDA model runs (forced here on the CPU)."""
    cfg, weights, sources, paths, model = case
    if device_prep:
        monkeypatch.setattr(nuset_infer, "prep_on_device", lambda m, d: True)
    got = list(stat_fish.segment_folder(model, paths, cfg["nuclei_size_T"]))
    assert [p for p, _, _ in got] == paths
    for (_, I, mask), src in zip(got, sources):
        want = ref.segment(weights, src, cfg)
        assert mask.shape == want.shape == I.shape[:2] == (320, 320)
        np.testing.assert_array_equal(mask, want)
        assert ndi.label(mask)[1] >= 1
    # the proposals placed markers: the watershed split the mask
    dapi = ref.dapi_u8(sources[0])
    img, whole = ref.prep(dapi, cfg["scale_ratio"])
    x = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))[None, None]
    with torch.no_grad():
        m1 = ref.mask_of(ref.unet(weights["whole"], x(whole), cfg)[0])
        logits, feat = ref.unet(weights["fg"], x(ref.foreground_norm(img, m1)), cfg)
        scores, deltas = ref.rpn(weights["rpn"], feat)
    m2 = ref.mask_of(logits)
    props, kept = ref.proposals(scores, deltas, m2, feat.shape[-2:], cfg)
    assert ref.markers_of(props, kept, m2, cfg["min_score"]) is not None


def test_the_tf32_control_differs_from_the_reference_at_the_networks():
    """The control rounds each conv's operands to TF32: the U-Net's logits
    move, by about a TF32 step of the level-1 offset (64 * 2^-10) times the
    head's gain of 5 at most."""
    cfg = _json("configs/nuset_unet_rpn.json")
    weights = _load("weights", "nuset_unet_rpn").make(cfg, SEED, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, 1, 64, 64)).astype(np.float32))
    with torch.no_grad():
        plain, feat = ref.unet(weights["fg"], x, cfg)
        tf32, _ = ref.unet(weights["fg"], x, cfg, tf32=True)
    assert not torch.equal(plain, tf32) and torch.allclose(plain, tf32, atol=1.0)
    assert feat.shape == (1, 512, 4, 4)
    assert ref.tf32_round(torch.tensor([1.0 + 2.0**-12])).item() == 1.0
    assert ref.tf32_round(torch.tensor([1.0 + 2.0**-11])).item() == 1.0 + 2.0**-10  # ties away


@pytest.mark.parametrize("base", [7.0, 16.0, 23.5])
def test_the_references_anchors_are_the_ports(base):
    cfg = _json("configs/nuset_unet_rpn.json")
    want = boxes.generate_anchors(boxes.generate_anchors_reference(base, cfg["anchor_ratios"], cfg["anchor_scales"]),
                                  16, (5, 7))
    got = ref.anchors(base, cfg, (5, 7))
    np.testing.assert_array_equal(got, want)
    # a hand case: ratio 1, scale 1 about the origin of the first cell is (-(b-1)/2, ..., (b-1)/2)
    k = 3 * 3 + 1  # ratio 1 is the fourth of seven, scale 1 the second of three
    np.testing.assert_array_equal(got[k], np.float32([-(base - 1) / 2] * 2 + [(base - 1) / 2] * 2))
    np.testing.assert_array_equal(got[21 + k] - got[k], np.float32([16, 0, 16, 0]))  # the next cell to the right


def test_the_references_decode_by_hand():
    a = np.float32([[0, 0, 9, 19]])  # w 10, h 20, centre (5, 10)
    d = np.float32([[0.1, -0.5, 0.0, np.log(2)]])
    got = ref.decode(a, d)
    # centre (6, 0), w 10, h 40: x1 = 6 - 5, y1 = 0 - 20, x2 = 6 + 5 - 1, y2 = 0 + 20 - 1
    np.testing.assert_allclose(got, [[1, -20, 10, 19]], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, boxes.decode(torch.from_numpy(a), torch.from_numpy(d)).numpy(), rtol=0, atol=2e-6)


def test_the_references_nms_by_hand():
    b = np.float32([[0, 0, 10, 10],  # (y1, x1, y2, x2), in score order
                    [0, 9, 10, 19],  # IoU with 0: 10 / 190 > 0.01: dropped
                    [0, 40, 10, 50],
                    [0, 30, 10, 40],  # touches 2 at a line: IoU 0, kept
                    [0, 0, 10, 10]])  # a copy of 0, not a candidate
    assert ref.nms(b, 4, 0.01, 800) == [0, 2, 3]
    assert ref.nms(b, 4, 0.06, 800) == [0, 1, 2, 3]
    assert ref.nms(b, 4, 0.01, 2) == [0, 2]
    assert ref.nms(b, 0, 0.01, 800) == []
    valid = torch.tensor([True] * 4 + [False])
    np.testing.assert_array_equal(boxes.nms_sorted(torch.from_numpy(b), valid, 800, 0.01), [0, 2, 3])


def test_the_references_flood_draws_a_line_between_two_markers():
    height = np.zeros((5, 7))
    seeds = np.zeros((5, 7), np.int64)
    seeds[2, 1], seeds[2, 5] = 1, 2
    out = ref.flood(height, seeds, np.ones((5, 7), bool))
    assert (out[:, :3] == 1).all() and (out[:, 4:] == 2).all() and (out[:, 3] == 0).all()


def test_the_reference_imports_nothing_of_the_program():
    code = ("import importlib.util, json, sys\n"
            f"s = importlib.util.spec_from_file_location('r', {os.path.join(BENCH, 'reference', 'nuset_unet_rpn.py')!r})\n"
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(ROOT), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded and "scipy" in loaded
    assert not loaded & {"ecseg_torch", "ecseg_tpu", "jax", "jaxlib", "flax", "portbench"}
