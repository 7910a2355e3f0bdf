"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(platform: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``, ``'cuda'`` or ``'gpu'`` -> the CUDA card (raises when there
    is none: the port never falls back to the CPU on its own); ``'cpu'`` ->
    the host."""
    if isinstance(platform, torch.device):
        platform = platform.type
    if platform in (None, "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the GPU by "
                "default; pass platform='cpu' to run on the host")
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"platform must be None, 'cuda', 'gpu' or 'cpu', "
                     f"got {platform!r}")


__all__ = ["resolve_device"]
