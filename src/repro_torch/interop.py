"""Carry an index, a model's parameters or its cache across as plain
numpy arrays.

The array names and layouts are those of ``repro.core.index.BlockIndex``
(raw (B, C, n), slo/shi (B, w, C), elo/ehi (w, B), ids (B, C)) and
``FlatIndex`` (raw (Np, n), lo/hi (w, Np), ids (Np,)), so an index built
by either package can be searched by the other on identical data.  A
parameter tree is the reference's nested dict with its names and stacked
(L, ...) layouts, and a cache its list of per-segment dicts, so weights
and caches cross name for name.
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



def _to_tensors(tree: dict, dev: torch.device) -> dict:
    return {k: _to_tensors(v, dev) if isinstance(v, dict)
            else torch.tensor(np.ascontiguousarray(v), device=dev)
            for k, v in tree.items()}


def _to_arrays(tree: dict) -> dict:
    return {k: _to_arrays(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in tree.items()}


def params_from_arrays(tree: dict, device: str | torch.device | None = "cuda"
                       ) -> dict:
    """A nested dict of numpy arrays (e.g. ``repro``'s parameters through
    ``np.asarray``) -> the same tree of tensors on ``device``.  The bits
    and dtypes are kept."""
    return _to_tensors(tree, resolve_device(device))


def params_to_arrays(params: dict) -> dict:
    """A parameter tree of tensors -> the same tree of numpy arrays."""
    return _to_arrays(params)


def cache_from_arrays(cache: list, device: str | torch.device | None = "cuda"
                      ) -> list:
    """A list of per-segment dicts of numpy arrays -> tensors on ``device``."""
    dev = resolve_device(device)
    return [_to_tensors(seg, dev) for seg in cache]


def cache_to_arrays(cache: list) -> list:
    """A list of per-segment dicts of tensors -> numpy arrays."""
    return [_to_arrays(seg) for seg in cache]
