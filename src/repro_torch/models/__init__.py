"""PyTorch model zoo of the port: every family of the JAX package."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
