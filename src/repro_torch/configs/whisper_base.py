"""whisper-base [audio] — enc-dec, conv frontend (stub).  6L d=512 8H
(kv=8) d_ff=2048 vocab=51865 [arXiv:2212.04356].

Backbone only: the conv frontend is a stub; `input_specs()` provides
precomputed frame embeddings (B, 1500, d).  Decoder = 6 layers of
self-attn + cross-attn + GELU MLP; GELU runs through the paper's
dual-mode unit when activation='gelu_dualmode'.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    pattern=(LayerSpec(mixer="attn", ffn="mlp", cross=True),),
    activation="gelu_tanh",
    gated_mlp=False,
    norm="layer",
    pos_emb="learned",
    enc_layers=6,
    n_frames=1500,
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab=512, enc_layers=2, n_frames=16)
