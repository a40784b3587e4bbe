from repro_torch.data.generators import (PAPER_SCALES, make_dataset,
                                         random_walk, sald_like, seismic_like)
from repro_torch.data.loader import (ChunkedLoader, IncrementalBuilder,
                                     build_streaming)

__all__ = ["PAPER_SCALES", "make_dataset", "random_walk", "sald_like",
           "seismic_like", "ChunkedLoader", "IncrementalBuilder",
           "build_streaming"]
