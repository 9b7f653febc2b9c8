"""Named codec configurations (the port's own copy of the registry)."""

from nsc_tpu_torch.configs.base import (  # noqa: F401
    CodecConfig,
    TrainConfig,
    get_config,
    list_configs,
    register_config,
)
