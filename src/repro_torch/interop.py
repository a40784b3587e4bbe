"""Carry a block index across as plain numpy arrays.

The array names and layouts are those of ``repro.core.index.BlockIndex``
(raw (B, C, n), slo/shi (B, w, C), elo/ehi (w, B), ids (B, C)), so an
index built by either package can be searched by the other on identical
data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import BlockIndex
from repro_torch.device import resolve_device

ARRAYS = ("raw", "slo", "shi", "elo", "ehi", "ids")
_DTYPES = {"ids": np.int32}


def block_index_from_arrays(arrays: dict[str, np.ndarray], *, n: int, w: int,
                            card: int, capacity: int, n_real: int,
                            device: str | torch.device | None = "cuda"
                            ) -> BlockIndex:
    """Numpy arrays (as ``block_index_to_arrays`` gives them) -> a
    ``BlockIndex`` on ``device``.  The bits are kept."""
    dev = resolve_device(device)
    tensors = {}
    for name in ARRAYS:
        a = np.ascontiguousarray(arrays[name],
                                 dtype=_DTYPES.get(name, np.float32))
        tensors[name] = torch.tensor(a, device=dev)        # a copy
    return BlockIndex(**tensors, n=n, w=w, card=card, capacity=capacity,
                      n_real=n_real)


def block_index_to_arrays(index: BlockIndex) -> dict[str, np.ndarray]:
    """``BlockIndex`` -> {name: numpy array} on the host."""
    return {name: getattr(index, name).cpu().numpy() for name in ARRAYS}
