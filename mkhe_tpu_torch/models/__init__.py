"""Application models (port of mkhe_tpu/models)."""

from . import cnn

__all__ = ["cnn"]
