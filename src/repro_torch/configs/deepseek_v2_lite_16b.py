"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, shared+routed MoE top-6.

27L d=2048 16H d_ff(expert)=1408 vocab=102400 [arXiv:2405.04434].
Assignment note says both "MoE 64e top-6" and "160 routed"; V2-Lite is
64 routed + 2 shared top-6 (160 routed is full V2) — we follow 64
(see DESIGN.md §Config fidelity).  First layer uses a dense MLP
(d_ff=10944), remaining 26 are MoE — expressed as prefix + period.
MLA: kv_lora=512, rope=64, nope=128, v=128, no q-lora.
"""
from .base import LayerSpec, MLACfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,                      # dense first-layer MLP
    vocab=102400,
    prefix=(LayerSpec(mixer="mla", ffn="mlp"),),
    pattern=(LayerSpec(mixer="mla", ffn="moe"),),
    mla=MLACfg(q_lora_rank=0, kv_lora_rank=512, nope_dim=128, rope_dim=64,
               v_dim=128),
    moe=MoECfg(n_experts=64, top_k=6, d_ff=1408, n_shared=2),
    activation="silu",
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=256,
    vocab=512,
    mla=MLACfg(q_lora_rank=0, kv_lora_rank=32, nope_dim=16, rope_dim=8,
               v_dim=16),
    moe=MoECfg(n_experts=8, top_k=2, d_ff=32, n_shared=1))
