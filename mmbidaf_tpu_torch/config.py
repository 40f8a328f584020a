"""The port's configuration: the JAX package's config dataclasses, which are
plain Python (no JAX), shared so that one config drives either package."""

from mmbidaf_tpu.config import (  # noqa: F401
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    config_from_dict,
    config_from_json,
    tiny_test_config,
)
