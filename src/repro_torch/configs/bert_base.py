"""bert-base — the paper's own evaluation model (encoder-only, GELU FFN).

12L d=768 12H d_ff=3072 vocab=30522 [Devlin et al. 2019].  This is the
architecture of the paper's Table I experiments: GELU in the FFN runs
through the dual-mode softmax unit ('gelu_dualmode'), i-GELU, or FP32.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="bert-base",
    family="encoder",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=30522,
    pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    activation="gelu_tanh",
    gated_mlp=False,
    norm="layer",
    pos_emb="learned",
    causal=False,
    max_seq=512,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab=512)
