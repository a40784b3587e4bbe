"""Architecture registry of the port.  Importing this package registers
the architectures the port serves (Hymba so far); ``get_config(name)``
resolves them."""
from repro_torch.configs.base import ModelConfig, count_params, get_config
from repro_torch.configs import hymba_1_5b  # noqa: F401

__all__ = ["ModelConfig", "get_config", "count_params"]
