"""The port's training stack: optimizers, the train / eval / serving
steps, gradient compression and the checkpointer."""
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optimizer import (adafactor_init, adamw_init,
                                         opt_init, opt_update, opt_update_)
from repro_torch.train.step import (make_eval_step, make_prefill_step,
                                    make_serve_step, make_train_step)

__all__ = ["Checkpointer", "adafactor_init", "adamw_init", "opt_init",
           "opt_update", "opt_update_", "make_eval_step",
           "make_prefill_step", "make_serve_step", "make_train_step"]
