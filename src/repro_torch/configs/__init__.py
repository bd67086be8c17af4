from .base import DiLoCoConfig, ModelConfig, TrainConfig  # noqa: F401
