"""The card's name and power limit, written beside every number: a card
set below its 700 W runs slower under load."""

from __future__ import annotations

import subprocess


def describe():
    """``nvidia-smi``'s name and power limit of the cards, one line; what
    torch says where ``nvidia-smi`` cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return "; ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.TimeoutExpired):
        pass
    import torch
    return f"{torch.cuda.get_device_name()}, power limit not read"
