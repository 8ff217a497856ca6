"""minicpm3-4b [dense] — MLA attention.  62L d=2560 40H (kv=40 spec; MLA
expands per-head) d_ff=6400 vocab=73448 [hf:openbmb/MiniCPM3-4B].

MLA dims from the HF config: q_lora=768, kv_lora=256, qk_nope=64,
qk_rope=32, v_head=64.
"""
from .base import LayerSpec, MLACfg, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab=73448,
    pattern=(LayerSpec(mixer="mla", ffn="mlp"),),
    mla=MLACfg(q_lora_rank=768, kv_lora_rank=256, nope_dim=64, rope_dim=32,
               v_dim=64),
    activation="silu",
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=512,
    mla=MLACfg(q_lora_rank=32, kv_lora_rank=16, nope_dim=16, rope_dim=8,
               v_dim=16))
