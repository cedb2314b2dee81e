"""Host-vs-device branch selection for the pipelines (twin of
``ecseg_tpu/runtime/devicepath.py``).

Several pipeline stages have two equivalent implementations: a host chain
(the parity oracle) and the device path (kernels and torch ops on the
resolved device).  ``ECSEG_DEVICE_PIPELINE=1``/``0`` chooses, as in the
JAX package.  One default differs: unset (or not understood), the JAX
package takes the device path only on a TPU backend; the port always takes
its device path, on the card, or on the kernels' CPU twins when the caller
asked for the CPU.  ``=0`` selects the host post-processing chains only:
the forwards stay on the resolved device.
"""

from __future__ import annotations

import os
import sys


def fast_watershed_mode() -> str:
    """NuSeT marker-watershed execution mode, from ECSEG_FAST_WATERSHED:

    - ``'host'``  (``0``/``off``/``host``, or unset when the device
      pipeline is off): the host priority flood only;
    - ``'auto'``  (``auto``, or unset when the device pipeline is on): the
      device flood with its per-image parity certificate; the device result
      is kept only when the certificate is clean (then it equals the host
      result bit for bit), else the host flood recomputes it
      (``ops/watershed_gpu.nuset_marker_watershed_auto``);
    - ``'on'``    (``1``/``true``/``yes`` and any other value): the device
      fast path unconditionally (may differ from the host on
      order-dependent ridge ties);
    - ``'check'`` (``check``): ``on`` plus per-image permuted-flood tie
      accounting (see :func:`fast_watershed_check`).
    """
    v = os.environ.get("ECSEG_FAST_WATERSHED", "").strip().lower()
    if v in ("", "default"):
        return "auto" if use_device_path() else "host"
    if v in ("0", "false", "no", "off", "host"):
        return "host"
    if v == "auto":
        return "auto"
    if v == "check":
        return "check"
    return "on"


def fast_watershed() -> bool:
    """True when the ungated device fast path is forced
    (ECSEG_FAST_WATERSHED=1/check): the result may differ from the host
    parity path on order-dependent ridge ties."""
    return fast_watershed_mode() in ("on", "check")


def fast_watershed_check() -> bool:
    """``ECSEG_FAST_WATERSHED=check``: the fast path plus per-image tie
    accounting: each watershed runs a second flood with permuted marker ids
    and the contour pixels that flip are counted in ``runtime/fallbacks``
    (``fast_watershed_tie_px`` / ``fast_watershed_tie_images``).  A lower
    bound on the divergence from the host flood (ties broken by geometry
    are stable under the permutation)."""
    return os.environ.get("ECSEG_FAST_WATERSHED", "").strip().lower() == "check"


def use_device_path() -> bool:
    """``ECSEG_DEVICE_PIPELINE`` as the JAX package parses it; unset or not
    understood, True (the port's device path)."""
    v = os.environ.get("ECSEG_DEVICE_PIPELINE")
    if v is not None and v.strip() != "":
        s = v.strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off"):
            return False
        print(
            f"ECSEG_DEVICE_PIPELINE={v!r} not understood "
            "(use 1/0); falling back to the backend default",
            file=sys.stderr,
        )
    return True


def shard_enabled(var: str) -> bool:
    """A fan-out switch (``ECSEG_OVERLAY_SHARD``, ``ECSEG_STAT_FISH_SHARD``,
    ``ECSEG_INTERSEG_SHARD``) as the JAX package parses it: on unless set to
    0/false/no/off.  It matters only on more than one device."""
    return os.environ.get(var, "1").strip().lower() not in ("0", "false", "no", "off")
