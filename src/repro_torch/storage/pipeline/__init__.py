"""Staged, sharded, resumable out-of-core build pipeline
(``repro.storage.pipeline``).

The write path behind every on-disk index:

    runs.py      pass-1 workers -> sorted summary run files (one/shard)
    merge.py     k-way external merge -> global block order
    driver.py    stage orchestration, manifest resume, pass-2 permute
    manifest.py  the JSON resume ledger (per-unit records, checksums)

``driver.run_pipeline`` is the full-control entry point (returns the
instrumented ``BuildReport``); ``driver.pipeline_build`` returns the
built index opened out-of-core; ``ooc_build.build_on_disk`` is the
single-worker wrapper.  Every file is byte-identical to the reference
pipeline's on the same data.
"""
from repro_torch.storage.pipeline.driver import (BuildInterrupted,
                                                 BuildReport, StageCounters,
                                                 pipeline_build, run_pipeline)
from repro_torch.storage.pipeline.manifest import Manifest
from repro_torch.storage.pipeline.merge import (merge_order, merge_runs,
                                                open_merge)
from repro_torch.storage.pipeline.runs import (SummaryBuilder, build_run,
                                               open_run)

__all__ = [
    "run_pipeline", "pipeline_build", "BuildReport", "StageCounters",
    "BuildInterrupted", "Manifest",
    "build_run", "open_run", "SummaryBuilder",
    "merge_runs", "merge_order", "open_merge",
]
