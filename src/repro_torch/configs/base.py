"""Config schema: model architecture + shape cells + run settings.

Every assigned architecture is expressed as a `ModelConfig`; the repeating
layer structure is a `pattern` (one period) plus optional non-repeated
`prefix` layers, which is what lets heterogeneous stacks (Jamba's 1:7
mamba:attn interleave, the VLM's every-5th cross-attn layer, DeepSeek's
dense first layer) run under one scan-over-periods loop.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"       # attn | mla | mamba | rwkv | none
    ffn: str = "mlp"          # mlp | moe | rwkv_cm | none
    cross: bool = False       # cross-attention sublayer after the mixer


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden size
    n_shared: int = 0
    capacity_factor: float = 1.25
    # pad the expert STACKS (not the router) to a multiple of the EP axis
    # so expert parallelism divides the mesh; padded experts are zero-init
    # and unroutable (router has exactly n_experts outputs).  0 = no pad.
    ep_pad: int = 0


@dataclass(frozen=True)
class MLACfg:
    q_lora_rank: int          # 0 = full-rank q
    kv_lora_rank: int
    nope_dim: int
    rope_dim: int
    v_dim: int


@dataclass(frozen=True)
class MambaCfg:
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | vlm | encdec | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    prefix: tuple[LayerSpec, ...] = ()
    activation: str = "silu"
    gated_mlp: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    norm: str = "rms"         # rms | layer
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    use_rope: bool = True
    pos_emb: str = "rope"     # rope | learned | sinusoid
    max_seq: int = 1 << 20    # learned-pos table size cap / cache bound
    causal: bool = True
    tie_embeddings: bool = False
    mla: MLACfg | None = None
    moe: MoECfg | None = None
    mamba: MambaCfg | None = None
    rwkv_lora_r: int = 64
    softmax_impl: str = "float"     # float | dualmode  (paper's unit)
    # attention execution strategy (kernels/dispatch.py registry):
    #   auto             naive for short T, blocked online-softmax
    #                    otherwise (dualmode -> the int blocked kernel)
    #   naive            always materialize (S,T) scores; honors any
    #                    softmax_impl
    #   flash            pure-JAX blocked online softmax (models/flash.py)
    #   flash_pallas     Pallas blocked kernel (kernels/flash_attention.py)
    #   flash_pallas_int Pallas blocked BIT-ACCURATE unit
    #                    (kernels/flash_attention_int.py); requires
    #                    softmax_impl='dualmode'
    #   flash_ring       sequence-parallel ring flash attention
    #                    (kernels/ring_attention.py): KV shards rotate
    #                    over the `ring_axis` mesh axis via ppermute
    # resolution refuses float blocked impls + softmax_impl='dualmode'
    attn_impl: str = "auto"
    # mesh axis for sequence-parallel ring attention ("" = off).  When
    # set (usually "model"), attn_impl='auto' upgrades its blocked picks
    # to 'flash_ring' whenever the ambient mesh carries the axis and the
    # sequence dims divide it — long-context prefill shards the KV
    # sequence instead of replicating 32k-deep caches per chip.
    ring_axis: str = ""
    # gated-MLP execution: dense | fused_pallas (kernels/fused_ffn.py)
    # | auto (resolves to fused_pallas on TPU, dense elsewhere — explicit
    # strings are never rewritten; see kernels/dispatch.resolve_ffn)
    ffn_impl: str = "dense"
    # norm-seam execution: dense | fused_pallas (kernels/fused_norm.py:
    # residual-add+norm epilogues and norm->matmul prologues) | auto
    # (fused_pallas on TPU, dense elsewhere — dispatch.resolve_norm).
    # Fused seams match the dense contract to <=1e-5, not bitwise.
    norm_impl: str = "dense"
    moe_dispatch: str = "sort"      # sort | dense
    # modality stubs (assignment: frontend is a stub, backbone is real)
    enc_layers: int = 0       # whisper encoder depth
    n_frames: int = 1500      # whisper stub frame count
    n_img_tokens: int = 0     # VLM stub image-token count
    sub_quadratic: bool = False     # may run long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        body = self.n_layers - len(self.prefix)
        assert body % len(self.pattern) == 0, (
            f"{self.name}: {body} layers not divisible by "
            f"period {len(self.pattern)}")
        return body // len(self.pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


# the assigned LM shape set (identical for all 10 archs)
SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatch: int = 0           # 0 = no gradient accumulation
    remat: bool = True
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    grad_compress: bool = False   # int8 + error feedback
    fsdp: bool = False            # shard params/opt-state over 'data'
    seq_shard: bool = True        # SP: shard seq over 'model' at boundaries
    inner_pins: bool = False      # Megatron AG/RS pins inside blocks (§Perf)
    profile: str = "auto"         # auto | tp | dp   (sharding profile)
    remat_mode: str = "period"    # period | two_level (sqrt-L groups)
