"""On-disk index subsystem (``repro.storage``): the persisted DSIX
format, the staged, sharded, resumable build pipeline, the streaming
exact k-NN search and the block-cache serving sessions.  Every entry
point takes ``device=`` (the card unless the caller asks for the CPU)."""
from repro_torch.storage.cache import BlockCache, PreparedRound, SearchSession
from repro_torch.storage.format import (SeriesStore, load_index, open_index,
                                        read_meta, save_index)
from repro_torch.storage.ooc_build import SummaryBuilder, build_on_disk
from repro_torch.storage.ooc_search import IOStats, OocSearchResult, ooc_search
from repro_torch.storage.pipeline import (BuildInterrupted, BuildReport,
                                          pipeline_build, run_pipeline)

__all__ = [
    "SeriesStore", "save_index", "load_index", "open_index", "read_meta",
    "build_on_disk", "SummaryBuilder",
    "pipeline_build", "run_pipeline", "BuildReport", "BuildInterrupted",
    "ooc_search", "OocSearchResult", "IOStats",
    "BlockCache", "SearchSession", "PreparedRound",
]
