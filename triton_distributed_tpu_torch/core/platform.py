"""Device selection, seeding, and the card's identity for printed numbers.

Counterpart of ``triton_distributed_tpu/core/platform.py``.  The entry points
of the port run on CUDA unless the caller asks for the CPU; with no CUDA and
no explicit request they raise rather than move to the CPU on their own.
"""

from __future__ import annotations

import random
import subprocess

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; ``"cpu"`` runs the plain
    PyTorch versions of the kernels.  Raises when CUDA is asked for (or
    implied) and absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def init_seed(seed: int) -> None:
    """Seed Python's, numpy's and PyTorch's global generators (reference
    ``utils.py:75-94`` ``init_seed``).  Model weights take an explicit
    ``torch.Generator`` instead."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def device_kind() -> str:
    """The device part of every tuner key (JAX ``platform.device_kind()``):
    the current CUDA device's name as ``torch.cuda.get_device_name`` gives
    it, or ``"cpu"`` without CUDA."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(torch.cuda.current_device())


def card_identity() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (first card).  Printed beside every number measured on it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout
    return out.strip().splitlines()[0].strip()
