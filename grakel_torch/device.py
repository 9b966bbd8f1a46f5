"""Where the port's tensors live.

Resolution order for a kernel's entry point (fit, fit_transform,
transform, diagonal):

1. the instance attribute ``Kernel.device``;
2. the ambient device installed by :func:`use_device`;
3. ``cuda``.

The port never falls back to the CPU on its own: when ``cuda`` is
resolved and no card is visible, :func:`resolve_device` raises.  Run on
the CPU only by asking for it, ``with use_device("cpu"): ...``.

The ambient device is plain module state, deliberately not
thread-local (the same choice as ``grakel_tpu.ops.gram.use_mesh``):
framework base kernels that ``parallel_sum`` dispatches on worker
threads inherit the outer kernel's device.
"""

from __future__ import annotations

import torch

__all__ = ["use_device", "resolve_device", "current_device"]

_DEVICE = None


class _DeviceCtx:
    def __init__(self, device, prev):
        self.device = device
        self.prev = prev

    def __enter__(self):
        return self.device

    def __exit__(self, *exc):
        global _DEVICE
        _DEVICE = self.prev
        return False


def use_device(dev):
    """Context manager: make ``dev`` (a ``torch.device`` or a string such
    as ``"cpu"`` or ``"cuda:0"``) the ambient device of every kernel whose
    own ``device`` attribute is None.  ``None`` clears the ambient
    device for the block."""
    global _DEVICE
    ctx = _DeviceCtx(None if dev is None else torch.device(dev), _DEVICE)
    _DEVICE = ctx.device
    return ctx


def current_device():
    """The device installed by :func:`use_device`, or None."""
    return _DEVICE


def resolve_device(dev=None):
    """``dev``, else the ambient device, else ``cuda``; raises
    ``RuntimeError`` when the result is a CUDA device and no card is
    visible."""
    if dev is None:
        dev = _DEVICE
    dev = torch.device("cuda" if dev is None else dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "grakel_torch resolved device %r but torch.cuda.is_available() "
            "is False; to run on the CPU, ask for it explicitly with "
            "grakel_torch.use_device('cpu') or set Kernel.device = 'cpu'"
            % str(dev))
    return dev
