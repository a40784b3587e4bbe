"""Where the port runs: the CUDA card unless the caller asks for the CPU.

Entry points (``core.build``, ``core.search_block_major``, ``engine.run``)
take a ``device`` argument that defaults to ``"cuda"``.  Asking for CUDA
on a machine without a card raises; nothing carries on silently on the
CPU.  Tests pass ``device="cpu"`` explicitly, and the kernel wrappers
then take their plain PyTorch versions because their tensors lie there.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """-> a torch.device; ``None`` means the card.  Raises if CUDA is asked
    for and unavailable.  A bare ``"cuda"`` resolves to the current card
    (``cuda:0`` by default), the device its tensors report."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA card by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
