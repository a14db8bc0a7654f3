"""Where the port's entry points run, and in which float32 precision.

Every constructor of the port that takes a ``device`` resolves ``None`` to
the CUDA card.  A caller who wants the CPU passes ``device="cpu"``; on a
machine without CUDA the default raises PyTorch's own error, and nothing
falls back to the CPU.

:func:`fp32_exact` pins full float32 for the port's own float32 matmuls
and convolutions ("x3" / "highest", as the JAX package runs them), whatever
the caller set: on the card cuDNN's convolutions run in TF32 by default,
and ``torch.set_float32_matmul_precision("high")`` turns TF32 on for
cuBLAS.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

__all__ = ["resolve_device", "bind_device", "fp32_exact", "device_constant"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else as
    ``torch.device`` reads it.  Touches no card."""
    return torch.device("cuda" if device is None else device)


def bind_device(device=None) -> torch.device:
    """The resolved device with its index filled in ("cuda" -> "cuda:0",
    the current card), so that it compares equal to a tensor's device.
    Raises PyTorch's own error where the device does not exist."""
    return torch.empty(0, device=resolve_device(device)).device


@functools.lru_cache(maxsize=64)
def _constant(data: bytes, np_dtype: str, shape: tuple, device: str,
              dtype) -> torch.Tensor:
    a = np.frombuffer(data, dtype=np.dtype(np_dtype)).reshape(shape)
    return torch.from_numpy(a.copy()).to(device=device, dtype=dtype)


def device_constant(a, device, dtype=None) -> torch.Tensor:
    """A host array (taps, a table) as a tensor on ``device``, copied once
    per (contents, device, dtype): a block that reuses it makes no
    host-to-device copy.  The tensor is shared; callers do not write to
    it.  The last 64 are kept."""
    a = np.ascontiguousarray(a)
    return _constant(a.tobytes(), a.dtype.str, a.shape, str(device), dtype)


def _read(getter):
    """A flag's value, or None where this torch lacks it or refuses to
    read it (a caller that mixed its legacy and fp32_precision APIs)."""
    try:
        return getter()
    except (RuntimeError, AttributeError):
        return None


def _precision_attrs() -> list:
    """The ``fp32_precision`` settings (torch >= 2.9) that TF32 reads:
    cuBLAS matmuls and cuDNN convolutions (and RNNs, which the legacy cuDNN
    flag also sets)."""
    cudnn = torch.backends.cudnn
    owners = [torch.backends.cuda.matmul, getattr(cudnn, "conv", None),
              getattr(cudnn, "rnn", None)]
    return [o for o in owners
            if o is not None and _read(lambda o=o: o.fp32_precision)
            is not None]


@contextlib.contextmanager
def fp32_exact():
    """Run the body with TF32 off for cuBLAS and cuDNN, then restore the
    caller's settings exactly: the global matmul precision, cuDNN's
    ``allow_tf32`` and, on torch >= 2.9, every ``fp32_precision`` that
    ``set_float32_matmul_precision`` or the legacy flags also move.  Usable
    as a decorator.  Not thread-safe: the flags are process-wide."""
    cudnn = torch.backends.cudnn
    matmul = _read(torch.get_float32_matmul_precision)
    conv = _read(lambda: cudnn.allow_tf32)
    new = [(o, o.fp32_precision) for o in _precision_attrs()]
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        if matmul is not None:
            torch.set_float32_matmul_precision(matmul)
        if conv is not None:
            cudnn.allow_tf32 = conv
        for owner, value in new:
            owner.fp32_precision = value
