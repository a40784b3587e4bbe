"""Out-of-core index build: series file -> index file
(``repro.storage.ooc_build``).

A thin wrapper: the build path — parallel pass-1 workers emitting sorted
summary runs, a k-way external merge producing the global block order,
and the pass-2 permute streaming raw series into the final file, all
resumable from a JSON manifest — lives in ``storage/pipeline/``.
``build_on_disk`` drives it with one worker and one shard, and the file
it produces is byte-identical to ``save_index(core.build(...))`` on the
same data and device, so ``load_index`` / ``open_index`` / ``ooc_search``
cannot tell which builder wrote it.  Callers that want shards, workers
or kill-resume call ``storage.pipeline_build`` / ``storage.run_pipeline``.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.core import isax
from repro_torch.core.index import BlockIndex
from repro_torch.storage.pipeline.driver import pipeline_build
from repro_torch.storage.pipeline.runs import SummaryBuilder  # noqa: F401

__all__ = ["build_on_disk", "SummaryBuilder"]


def build_on_disk(source, out_path: str | Path, *, length: int | None = None,
                  w: int = isax.W, card: int = isax.CARD, capacity: int = 512,
                  chunk: int = 1 << 14, normalize: bool = True,
                  extra: dict | None = None,
                  device: str | torch.device | None = "cuda") -> BlockIndex:
    """Build a persisted index from a series file, out of core, on
    ``device`` (the card unless the caller asks for the CPU).

    ``source``: a ``SeriesStore``, or a path to a headerless float32 file
    (then ``length`` is required).  Returns the index re-opened
    out-of-core on ``device`` — hand it to ``storage.ooc_search``, or
    ``load_index(out_path)`` for the in-memory paths.
    """
    return pipeline_build(source, out_path, length=length, w=w, card=card,
                          capacity=capacity, chunk=chunk,
                          normalize=normalize, extra=extra,
                          workers=1, shards=1, device=device)
