"""deepseek-coder-33b — dense llama-arch [arXiv:2401.14196; hf].

62 layers, d_model=7168, 56H GQA (kv=8), d_ff=19200, vocab=32256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    head_dim=128,
)
