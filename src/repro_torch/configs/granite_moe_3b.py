"""granite-moe-3b-a800m [moe] — per assignment spec line: MoE 40e top-8.

32L d=1536 24H (kv=8) d_ff(expert)=512 vocab=49155
[hf:ibm-granite family].  The assignment's note says 32 experts; the spec
line says 40e — we follow the spec line (DESIGN.md §Config fidelity).
"""
from .base import LayerSpec, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    # ep_pad=48: 40 experts don't divide the 16-wide EP axis; 8 zero-init
    # unroutable pad experts make the stacks (48,...) so expert
    # parallelism shards 3/chip instead of replicating (DESIGN.md §8)
    moe=MoECfg(n_experts=40, top_k=8, d_ff=512, ep_pad=48),
    activation="silu",
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=64, vocab=512,
                         moe=MoECfg(n_experts=4, top_k=2, d_ff=64))
