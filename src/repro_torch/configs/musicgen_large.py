"""musicgen-large -- decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48 layers, d_model=2048, 32 MHA heads of 64 (kv=32), d_ff=8192, vocab=2048
(the EnCodec codebook), parametric LayerNorm.  The EnCodec frontend is a
stub, as in the reference: the model takes precomputed frame embeddings of
width d_model (``embed_inputs``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    norm_type="layernorm",
    embed_inputs=True,
)
