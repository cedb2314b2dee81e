"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]
DevicesLike = Optional[Sequence[Union[str, torch.device]]]

_NO_CUDA = "no CUDA device is available; pass device='cpu' (or devices=['cpu'] * n) to run the port on the CPU"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card.  Without one this raises instead of
    quietly running on the CPU; a caller that wants the CPU (the tests) asks
    for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CUDA)
        return torch.device("cuda")
    return torch.device(device)


def resolve_devices(devices: DevicesLike = None) -> List[torch.device]:
    """The device list of a multi-device path (the port's ``jax.devices()``).
    ``None`` means every CUDA card and raises without one, as
    :func:`resolve_device` does.  An explicit list is taken as given: it may
    repeat an entry (a logical mesh: one card listed more than once) and may
    name ``"cpu"``.  A CUDA entry without an index gets the current one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CUDA)
        return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("an empty device list")
    return [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d for d in out]


def entry_devices(device: DeviceLike = None, devices: DevicesLike = None) -> List[torch.device]:
    """The devices an entry point runs on: ``device`` alone (the single-card
    path), else ``devices`` (:func:`resolve_devices`: ``None`` is every
    card)."""
    if device is not None and devices is not None:
        raise ValueError("pass device or devices, not both")
    if device is not None:
        return [resolve_device(device)]
    return resolve_devices(devices)


def pin_thread(device: torch.device) -> None:
    """Make ``device`` the calling thread's current CUDA device (PyTorch
    keeps it per thread), so that the thread's current-device calls
    (``torch.cuda.synchronize``, a stage of the tracer) reach its own card.
    A CPU device needs nothing."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
