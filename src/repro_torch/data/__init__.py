from repro_torch.data.generators import (PAPER_SCALES, make_dataset,
                                         random_walk, sald_like, seismic_like)

__all__ = ["PAPER_SCALES", "make_dataset", "random_walk", "sald_like",
           "seismic_like"]
