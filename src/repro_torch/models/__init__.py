"""Model zoo of the port: the dense decoder-only LM family."""
from .zoo import ModelApi, build_model, make_generator

__all__ = ["ModelApi", "build_model", "make_generator"]
