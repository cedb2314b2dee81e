"""The port's NuSeT U-Net and RPN (ecseg_torch/models/nuset.py) against
ecseg_tpu's nuset.unet_forward / rpn_forward at the published widths, the
weight bridge, and the demo tree against the JAX package's crafting."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ecseg_tpu.models import demo as jdemo
from ecseg_tpu.models import nuset as jn
from ecseg_tpu.models import nuset_infer as jni
from ecseg_torch.models import nuset as tn
from ecseg_torch.models.demo import demo_nuset_tree
from ecseg_torch.models.weights import load_npz, nuset_from_numpy, nuset_to_numpy, save_npz

from _nusetutil import passthrough_nuset_params
from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

LOGIT_ATOL = 1e-4  # float32 convs summed in another order, through 18 convs
SIZES = ((64, 48), (96, 80))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _trees():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    return {
        "random": _np(jn.init_unet_params(k1)),
        "passthrough": _np(passthrough_nuset_params(k2, thresh=0.5)),
        "rpn": _np(jn.init_rpn_params(k3, jni.NUM_REF_ANCHORS)),
    }


def _port(unet_tree):
    whole, _, rpn = nuset_from_numpy({"whole": unet_tree, "fg": {"unet": unet_tree, "rpn": _trees()["rpn"]}})
    return whole.eval(), rpn.eval()


_jax_unet = jax.jit(jn.unet_forward)
_jax_rpn = jax.jit(jn.rpn_forward)


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 1, (h, w)).astype(np.float32)
    img[h // 4 : h // 2, w // 4 : 3 * w // 4] += 2.0  # a bright block for the passthrough threshold
    return img


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("which", ["random", "passthrough"])
def test_unet_and_rpn_match_jax(which, hw):
    tree = _trees()[which]
    x = _image(*hw, seed=hw[0])
    j_logits, j_feat = _jax_unet(tree, jnp.asarray(x)[None, :, :, None])
    j_rpn = _jax_rpn(_trees()["rpn"], j_feat)
    unet, rpn = _port(tree)
    with torch.no_grad():
        logits, feat = unet(torch.from_numpy(x)[None, None])
        out = rpn(feat)
    np.testing.assert_allclose(logits[0].permute(1, 2, 0).numpy(), np.asarray(j_logits)[0], atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(feat[0].permute(1, 2, 0).numpy(), np.asarray(j_feat)[0], atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tn.pred_mask(logits).numpy(), np.asarray(jn.pred_mask(j_logits)) == 1)
    for key in ("rpn_cls_score", "rpn_cls_prob", "rpn_bbox_pred"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(j_rpn[key]), atol=1e-6, rtol=0, err_msg=key)
    assert out["rpn_cls_prob"].shape == (hw[0] // 16 * hw[1] // 16 * jni.NUM_REF_ANCHORS, 2)


def test_bridge_round_trip_through_npz(tmp_path):
    ref = {"whole": _trees()["random"], "fg": {"unet": _trees()["passthrough"], "rpn": _trees()["rpn"]}}
    path = str(tmp_path / "nuset.npz")
    save_npz(path, ref)
    back = nuset_to_numpy(*nuset_from_numpy(load_npz(path)))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    assert "bias" not in back["whole"]["final"]


def test_bridge_rejects_a_tree_of_other_layers():
    tree = {"whole": dict(_trees()["random"]), "fg": {"unet": _trees()["random"], "rpn": _trees()["rpn"]}}
    del tree["whole"]["conv5-2"]
    with pytest.raises(ValueError, match="do not match"):
        nuset_from_numpy(tree)


def test_demo_tree_crafts_the_jax_packages_level_one():
    """The crafted layers equal the JAX package's demo_nuset_params; the
    deep layers are seeded glorot (within their limits), not its values."""
    ours = demo_nuset_tree()
    for key, thresh in (("whole", 0.5), (("fg", "unet"), -5.0)):
        tree = ours[key] if isinstance(key, str) else ours[key[0]][key[1]]
        want = _np(jdemo.demo_nuset_params(jax.random.PRNGKey(0), thresh))
        for name in ("conv1-1", "conv1-2", "conv1-3", "conv1-4", "final"):
            for leaf in want[name]:
                np.testing.assert_array_equal(tree[name][leaf], want[name][leaf], err_msg=f"{key} {name} {leaf}")
        limit = np.sqrt(6.0 / (9 * 1024 + 9 * 1024))
        assert np.abs(tree["conv5-2"]["kernel"]).max() <= limit
    assert ours["fg"]["rpn"]["rpn_cls_score"]["kernel"].shape == (1, 1, 512, 42)
    again = demo_nuset_tree()
    np.testing.assert_array_equal(again["fg"]["rpn"]["rpn_conv"]["kernel"], ours["fg"]["rpn"]["rpn_conv"]["kernel"])
