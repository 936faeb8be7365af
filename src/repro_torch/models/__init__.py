"""Model zoo of the port: the dense and MoE decoder-only LM families."""
from .zoo import ModelApi, build_model, make_generator

__all__ = ["ModelApi", "build_model", "make_generator"]
