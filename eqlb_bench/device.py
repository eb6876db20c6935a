"""The card a run measures.  ``device_line`` is a frozen copy of
``dolfinx_eqlb_tpu_torch/bench.py``'s."""

from __future__ import annotations

import subprocess

import torch


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, the
    card picked by its UUID (torch's index counts only the visible cards);
    "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    if not uuid.startswith("GPU-"):
        uuid = f"GPU-{uuid}"
    res = subprocess.run(
        ["nvidia-smi", "-i", uuid, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()
