"""Architecture registry of the port.  Importing this package registers
all ten architectures (and their reduced smoke variants);
``get_config(name)`` resolves them.  Which families the model code runs
is decided in ``repro_torch.models.transformer``."""
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeCell,
                                      active_params, count_params,
                                      get_config, list_archs)
from repro_torch.configs import (command_r_35b, gemma3_27b,  # noqa: F401
                                 granite_moe_1b_a400m, h2o_danube_1_8b,
                                 hymba_1_5b, moonshot_v1_16b_a3b,
                                 nemotron_4_340b, pixtral_12b, rwkv6_7b,
                                 whisper_medium)

__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "get_config", "list_archs",
           "count_params", "active_params"]
