"""Device resolution and the dtype policy of the port.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). With no card and no explicit CPU
request they raise: nothing falls back to the CPU.

Resolving a device has no side effect. The precision of fp32 layers is
set once by the owner of a process's models (``use_full_fp32``).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device that is not present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain CPU path explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_full_fp32() -> None:
    """Compute fp32 layers (the UNet's ``conv_out``, the VAE's fp32
    convolutions and attention, the text projections) in full fp32 on
    the card: TF32 off in cuBLAS and cuDNN for the whole process.

    PyTorch leaves TF32 on for cuDNN by default, so two processes of which
    one turned it off compute different bits: a worker's image would then
    differ from a direct run of the same seed.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name (``"bfloat16"``, ``"float32"``) → torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(_DTYPES)}") from None
