"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536 [arXiv:2403.19887].
Period-8 unit: attention at index 4, Mamba elsewhere; MoE on odd indices
(every other layer), dense MLP on even.  No positional encoding (the Mamba
layers carry position).  Sub-quadratic -> runs long_500k.
"""
from .base import LayerSpec, MambaCfg, ModelConfig, MoECfg


def _pattern():
    out = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "mlp"
        out.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(out)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    pattern=_pattern(),
    activation="silu",
    use_rope=False,
    moe=MoECfg(n_experts=16, top_k=2, d_ff=14336),
    mamba=MambaCfg(d_inner=8192, d_state=16, d_conv=4, dt_rank=256),
    sub_quadratic=True,
)

REDUCED = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    moe=MoECfg(n_experts=4, top_k=2, d_ff=128),
    mamba=MambaCfg(d_inner=128, d_state=8, d_conv=4, dt_rank=8),
)
