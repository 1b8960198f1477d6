"""Model-configurator protocol (reference: ltx_core/model/model_protocol.py:1-10)."""

from typing import Protocol, TypeVar

ModelType = TypeVar("ModelType")


class ModelConfigurator(Protocol[ModelType]):
    """Protocol for loaders that instantiate models from a config dict."""

    @classmethod
    def from_config(cls, config: dict) -> ModelType: ...


__all__ = ["ModelConfigurator", "ModelType"]
