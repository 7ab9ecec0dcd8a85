"""Precision and device selection.

colmap_tpu's ``floatx`` gives float64 when JAX's x64 mode is on (tests, CPU
pipelines) and float32 on the accelerator. The port keys the same choice on
the device: float64 on the CPU, float32 on the card, where the kernels take
float32.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when CUDA is asked for and no card is present; there is no silent
    drop to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --device cpu) to run on the CPU"
        )
    return dev


def floatx(device=None) -> torch.dtype:
    """float64 on the CPU, float32 on the card."""
    return torch.float64 if torch.device(device or "cuda").type == "cpu" else torch.float32
