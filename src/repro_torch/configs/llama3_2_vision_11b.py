"""llama-3.2-vision-11b [vlm] — cross-attn image layers.  40L d=4096 32H
(kv=8) d_ff=14336 vocab=128256 [hf:meta-llama/Llama-3.2-11B-Vision].

Backbone only per assignment: the vision tower is a stub; `input_specs()`
provides precomputed patch embeddings (B, 1601, d).  40 layers = 32
self-attention + 8 gated cross-attention layers (every 5th position,
offset 3 — matching the HF cross_attention_layers list modulo counting).
"""
from .base import LayerSpec, ModelConfig

_PERIOD = (
    LayerSpec(mixer="attn", ffn="mlp"),
    LayerSpec(mixer="attn", ffn="mlp"),
    LayerSpec(mixer="attn", ffn="mlp"),
    LayerSpec(mixer="none", ffn="mlp", cross=True),   # gated cross-attn layer
    LayerSpec(mixer="attn", ffn="mlp"),
)

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    pattern=_PERIOD,
    rope_theta=5e5,
    activation="silu",
    n_img_tokens=1601,
)

REDUCED = CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=512, n_img_tokens=8)
