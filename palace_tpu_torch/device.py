"""Device selection for the port's entry points.

The entry points run on the CUDA device unless the caller asks for the
CPU by name.  There is no silent fallback: without a card, asking for
``cuda`` raises.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (default) or ``"cpu"`` → ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable;
    the caller must pass ``device="cpu"`` to run on the host."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "palace_tpu_torch runs on a CUDA device by default, and "
                "torch.cuda.is_available() is False here; pass "
                "device='cpu' (CLI: --device cpu) to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def device_info() -> dict:
    """Name, count and power limit of the CUDA cards, for the numbers the
    port prints.  ``nvidia_smi`` is the raw
    ``name, power.limit`` line of the first card, or ``None``."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_info() needs a CUDA device")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi[0].strip() if smi else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
