"""Step factories of the port: the serving steps so far (training waits
for the training slice, ROADMAP.md Queue 1, item 18)."""
from repro_torch.train.step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
