"""What every kernel wrapper does around a launch: check the CUDA tensors it
hands the kernel, pass PyTorch's current stream, and raise when the launch
is refused. Each wrapper also counts its launches in `<wrapper>.launches`;
`reset` and `counts` read a group of wrappers at once."""

from __future__ import annotations

import torch


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, key: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device, aligned: bool = False) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`
    (and, with `aligned`, starts on the 16-byte boundary that a kernel's
    vector loads need)."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {key} has dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {key} is not contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: {key} does not start on a 16-byte boundary")


def raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def reset(wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def counts(wrappers) -> dict[str, int]:
    return {w.__name__: w.launches for w in wrappers}
