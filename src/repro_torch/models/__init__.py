"""PyTorch model zoo of the port (the dense and MoE families so far)."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
