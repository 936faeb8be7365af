"""Model zoo of the port: the dense, MoE, SSM (xLSTM) and hybrid (Zamba2)
LM families."""
from .zoo import ModelApi, build_model, make_generator

__all__ = ["ModelApi", "build_model", "make_generator"]
