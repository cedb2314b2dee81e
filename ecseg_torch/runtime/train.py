"""Training of the metaseg U-Net on one card (twin of
``ecseg_tpu/runtime/train.py:26-76``).

The loss keeps the JAX package's arithmetic: the log of the clamped softmax
probabilities, a one-hot built by comparison (a label outside [0, C) gives
a zero row, so its pixel adds 0 and still counts in the mean), and with a
``valid`` mask the per-sample means weighted by it.  The step is autograd
through :class:`~ecseg_torch.models.metaseg_unet.MetasegUNet` (cuDNN's
convolutions and their gradients; no hand kernel lies on this path) and
``torch.optim.Adam`` with optax's defaults in place of ``optax.adam``.

In float32 the forward and the backward both run under
``layers.parity_flags`` (the JAX package computes both at
``Precision.HIGHEST``): autograd runs the backward after the forward's own
flags have been left, and PyTorch's default lets cuDNN use TF32 there.
``dtype=torch.bfloat16`` computes in bf16 on the float32 weights, which
stay the optimizer's master copy, as the JAX package's ``--bf16`` does.

Not ported: ``jit_train_step_on_mesh``'s data- and tensor-parallel
shardings (a multi-GPU box).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models.layers import parity_flags
from ..models.metaseg_unet import MetasegUNet


def softmax_xent_loss(
    model: MetasegUNet,
    x: torch.Tensor,
    y: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    remat: bool = False,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean pixel cross-entropy of (N, H, W, 1) uint8 patches ``x`` against
    (N, H, W) integer labels ``y``.

    ``valid``: an optional (N,) bool mask that keeps pad samples (zeros
    appended by ``data.pad_to_multiple``) out of the loss and its gradient.
    ``remat=True`` recomputes the forward's activations during the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps the whole
    forward): less memory, about a third more convolution work, the same
    gradients."""
    if remat:
        probs = checkpoint(lambda inp: model(inp, dtype=dtype), x, use_reentrant=False)
    else:
        probs = model(x, dtype=dtype)
    logp = torch.log(torch.clamp(probs, min=1e-12))
    onehot = (y[..., None] == torch.arange(probs.shape[-1], device=y.device)).to(logp.dtype)
    xent = -(onehot * logp).sum(dim=-1)
    if valid is None:
        return xent.mean()
    per_sample = xent.mean(dim=(1, 2))
    vm = valid.to(per_sample.dtype)
    return (per_sample * vm).sum() / torch.clamp(vm.sum(), min=1.0)


def make_optimizer(model: MetasegUNet, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s counterpart: betas 0.9 / 0.999, eps 1e-8, no
    weight decay, no amsgrad.  The update formula is optax's; only the
    order of its roundings differs."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, amsgrad=False)


def train_step(
    model: MetasegUNet,
    optimizer: torch.optim.Optimizer,
    x,
    y,
    valid=None,
    dtype: torch.dtype = torch.float32,
    remat: bool = False,
) -> torch.Tensor:
    """One optimizer step on uint8 NHWC crops ``x`` and int32 labels ``y``
    (numpy arrays or tensors, moved to the model's device); steps the model
    in place and returns the loss, a scalar tensor on the device (reading
    it waits for the step)."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    if valid is not None:
        valid = torch.as_tensor(valid).to(dev)
    optimizer.zero_grad(set_to_none=True)
    with parity_flags() if dtype == torch.float32 else contextlib.nullcontext():
        loss = softmax_xent_loss(model, x, y, dtype=dtype, remat=remat, valid=valid)
        loss.backward()
    optimizer.step()
    return loss.detach()
