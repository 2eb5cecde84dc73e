"""The device an entry point runs on.

An entry point takes ``device`` (default ``"cuda"``) and runs there; the
port never swaps the card for the CPU, and a device that is neither
raises."""

from __future__ import annotations

import torch


def checked(device, what="this tool"):
    """torch.device(device), raising unless it is the CPU or a CUDA card."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    return dev
