"""Carry an index across as plain numpy arrays.

The array names and layouts are those of ``repro.core.index.BlockIndex``
(raw (B, C, n), slo/shi (B, w, C), elo/ehi (w, B), ids (B, C)) and
``FlatIndex`` (raw (Np, n), lo/hi (w, Np), ids (Np,)), so an index built
by either package can be searched by the other on identical data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import BlockIndex, FlatIndex
from repro_torch.device import resolve_device

ARRAYS = ("raw", "slo", "shi", "elo", "ehi", "ids")
FLAT_ARRAYS = ("raw", "lo", "hi", "ids")
_DTYPES = {"ids": np.int32}


def _tensors(arrays, names, device) -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {name: torch.tensor(np.ascontiguousarray(
        arrays[name], dtype=_DTYPES.get(name, np.float32)), device=dev)
        for name in names}                                # copies


def block_index_from_arrays(arrays: dict[str, np.ndarray], *, n: int, w: int,
                            card: int, capacity: int, n_real: int,
                            device: str | torch.device | None = "cuda"
                            ) -> BlockIndex:
    """Numpy arrays (as ``block_index_to_arrays`` gives them) -> a
    ``BlockIndex`` on ``device``.  The bits are kept."""
    return BlockIndex(**_tensors(arrays, ARRAYS, device), n=n, w=w,
                      card=card, capacity=capacity, n_real=n_real)


def block_index_to_arrays(index: BlockIndex) -> dict[str, np.ndarray]:
    """``BlockIndex`` -> {name: numpy array} on the host."""
    return {name: getattr(index, name).cpu().numpy() for name in ARRAYS}


def flat_index_from_arrays(arrays: dict[str, np.ndarray], *, n: int, w: int,
                           card: int, n_real: int,
                           device: str | torch.device | None = "cuda"
                           ) -> FlatIndex:
    """Numpy arrays of a flat SAX array -> a ``FlatIndex`` on ``device``.
    The bits are kept."""
    return FlatIndex(**_tensors(arrays, FLAT_ARRAYS, device), n=n, w=w,
                     card=card, n_real=n_real)

