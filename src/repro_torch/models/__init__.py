"""Model zoo of the port: the dense, MoE, SSM (xLSTM), hybrid (Zamba2),
encoder-decoder (Whisper) and VLM (Llama-3.2-Vision) LM families."""
from .zoo import ModelApi, build_model, make_generator

__all__ = ["ModelApi", "build_model", "make_generator"]
