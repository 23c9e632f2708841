"""PyTorch model zoo of the port (dense family so far)."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
