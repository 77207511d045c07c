"""The LM substrate's models: GQA transformers with SwiGLU or GELU FFNs."""
