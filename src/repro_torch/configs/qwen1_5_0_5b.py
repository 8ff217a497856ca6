"""qwen1.5-0.5b [dense] — QKV bias, MHA-as-GQA (kv=16).  24L d=1024 16H
d_ff=2816 vocab=151936 [hf:Qwen/Qwen1.5-0.5B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    activation="silu",
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab=512)
