"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free.

24L d=2048 (32 heads of 64) d_ff=7168 vocab=65536 [arXiv:2404.05892].
The paper's GELU-via-softmax technique is N/A for the channel-mix
(squared-ReLU is not sigmoid-family — DESIGN.md §6); arch fully supported.
Attention-free -> O(1) state -> runs long_500k.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    pattern=(LayerSpec(mixer="rwkv", ffn="rwkv_cm"),),
    activation="relu2",
    use_rope=False,
    pos_emb="none",
    rwkv_lora_r=64,
    sub_quadratic=True,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                         vocab=512, rwkv_lora_r=8)
