"""Model configuration system.

One ``ModelConfig`` describes any of the assigned architectures: dense,
MoE, SSM (xLSTM), hybrid (Jamba), VLM-backbone, audio enc-dec.  The layer
stack is a repeated ``period`` of block specs (scan-over-periods keeps the
HLO size independent of depth); heterogeneous stacks (Jamba's 1:7
attention:mamba interleave, xLSTM's mLSTM/sLSTM mix, MoE-every-k) are all
expressed through the period pattern.

A copy of the reference's ``repro.models.config``: pure dataclasses, no
framework (importing ``repro.models`` would load JAX).  The port runs the
dense-attention part of it (``repro_torch.models.model``); the fields of
the other block kinds are kept so every configuration reads the same.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = False   # deepseek: normalize over chosen top-k
    # accuracy-tier name to route the top-k combine-weight normalization
    # denominator through repro.reduce (None = plain XLA sum, bitwise
    # identical to the pre-algebra path)
    router_norm_policy: Optional[str] = None


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclass(frozen=True)
class XLSTMCfg:
    num_heads: int = 4
    proj_factor_m: float = 2.0      # mLSTM up-projection
    proj_factor_s: float = 1.3      # sLSTM FFN factor
    conv_kernel: int = 4


@dataclass(frozen=True)
class BlockSpec:
    """One block in the period pattern."""
    kind: str              # 'attn' | 'mamba' | 'mlstm' | 'slstm'
    mlp: str = "swiglu"    # 'swiglu' | 'gelu' | 'moe' | 'none'


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    period: Tuple[BlockSpec, ...] = (BlockSpec("attn", "swiglu"),)
    head_dim: Optional[int] = None
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    # attention flavor
    attn_type: str = "gqa"            # 'gqa' | 'mla'
    window: Optional[int] = None      # sliding-window size (SWA)
    rope_theta: float = 1e4
    mrope: bool = False               # qwen2-vl multimodal rope (3 sections)
    # MLA (deepseek-v2) dims
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # enc-dec (seamless): encoder depth; decoder uses n_layers
    encoder_layers: int = 0
    # modality frontend stub: inputs arrive as precomputed embeddings
    embed_inputs: bool = False        # True => input_specs gives (B,S,D) f32
    norm_eps: float = 1e-5
    # accuracy-tier name to route every rmsnorm's mean-square through the
    # repro.reduce front door (None = plain XLA mean, bitwise identical
    # to the pre-algebra path); with an integer tier the norm denominator
    # — like the clip norm via adamw's norm_policy and the MoE combine
    # weights via MoECfg.router_norm_policy — stops depending on XLA's
    # internal reduction tiling
    norm_reduce_policy: Optional[str] = None
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # chunk length for the SSM inner scans (mamba/mLSTM chunkwise forms);
    # dry-run cost-variants set it to seq_len so cost_analysis sees the
    # whole sequence (while bodies are counted once by XLA).
    scan_chunk: int = 512
    # query-block size for chunked (memory-bounded) training attention;
    # blocks of q attend to the full K/V without materializing (S, S).
    attn_qchunk: int = 1024
    # data-parallel mesh axes to pin activations to (None = unconstrained,
    # for single-device smoke runs).  Without this GSPMD may all-gather the
    # batch to exploit FSDP-sharded contracting dims (16x activation blowup).
    act_dp_axes: Optional[Tuple[str, ...]] = None
    # sequence-chunked fused head+xent: the (B, chunk, V) logits block is
    # the only vocab-sized tensor ever materialized (256k-vocab archs would
    # otherwise spend >10 GB/device on loss intermediates).
    loss_chunk: int = 1024
    # sequence parallelism: shard the residual stream's sequence axis over
    # this mesh axis between blocks (Megatron-SP).  The remat-saved per-layer
    # carries shrink by the axis size; blocks re-gather as needed.
    act_sp_axis: Optional[str] = None
    # MoE activation sharding: expert axis (EP) or expert-FF axis (expert-TP
    # when E doesn't divide the model axis) — set by the mesh plan.
    moe_expert_axis: Optional[str] = None
    moe_ff_axis: Optional[str] = None
    # expert-TP: reduce the wo partial sums cross-shard in bf16 instead of
    # f32 (halves the dominant all-reduce; per-shard accumulation stays f32)
    moe_bf16_combine: bool = False
    # virtual experts: split each expert's FFN into v column shards, giving
    # E*v schedulable experts — exact EP when E*v divides the model axis
    # (mixtral: 8*2=16).  The cross-shard f32 partial-sum all-reduce of
    # expert-TP becomes part of the (bf16) combine gather: each virtual
    # expert's partial output is one more row in the token's top-(k*v)
    # segmented sum — the JugglePAC variable-length-set combine, literally.
    moe_virtual_split: int = 1
    # long-context capability marker (for long_500k applicability)
    subquadratic: bool = False

    def __post_init__(self):
        assert self.n_layers % len(self.period) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by period "
            f"{len(self.period)}")

    @property
    def hdim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab, 256)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----------

    def param_counts(self) -> dict:
        """Returns dict(total=..., active=...) parameter counts (no embed
        double count; embeddings included)."""
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.hdim
        per_kind_total = {}
        per_kind_active = {}

        def attn_params():
            if self.attn_type == "mla":
                r, nd, rd, vd = (self.kv_lora_rank, self.qk_nope_dim,
                                 self.qk_rope_dim, self.v_head_dim)
                q = d * h * (nd + rd)
                kv_a = d * (r + rd)
                kv_b = r * h * (nd + vd)
                o = h * vd * d
                return q + kv_a + kv_b + o
            return d * h * hd + 2 * d * kv * hd + h * hd * d

        def mlp_params(spec: BlockSpec):
            if spec.mlp == "moe":
                m = self.moe
                routed = m.num_experts * 3 * d * m.d_ff_expert
                shared = m.num_shared * 3 * d * (m.d_ff_shared or m.d_ff_expert)
                router = d * m.num_experts
                active = (m.top_k * 3 * d * m.d_ff_expert + shared + router)
                return routed + shared + router, active
            if spec.mlp == "none":
                return 0, 0
            ff = 3 * d * self.d_ff if spec.mlp == "swiglu" else 2 * d * self.d_ff
            return ff, ff

        def block_params(spec: BlockSpec):
            if spec.kind == "attn":
                core = attn_params()
            elif spec.kind == "mamba":
                m = self.mamba or MambaCfg()
                di = m.expand * d
                core = (d * 2 * di + di * m.d_conv + di * (2 * m.d_state + 1)
                        + di + di * d)
            elif spec.kind == "mlstm":
                x = self.xlstm or XLSTMCfg()
                di = int(x.proj_factor_m * d)
                core = d * 2 * di + 3 * di * di // x.num_heads + di * d + 3 * di
            elif spec.kind == "slstm":
                x = self.xlstm or XLSTMCfg()
                core = 4 * d * d + 4 * d * d + int(x.proj_factor_s * d) * d * 2
            else:
                raise ValueError(spec.kind)
            mlp_t, mlp_a = mlp_params(spec)
            return core + mlp_t, core + mlp_a

        total = active = 0
        for spec in self.period:
            t, a = block_params(spec)
            total += t * self.n_periods
            active += a * self.n_periods
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        total += emb
        active += emb
        if self.is_encdec:
            enc_block = attn_params() + 3 * d * self.d_ff
            total += self.encoder_layers * enc_block
            active += self.encoder_layers * enc_block
            # decoder cross-attention
            total += self.n_layers * attn_params()
            active += self.n_layers * attn_params()
        return dict(total=total, active=active)


# Shape set assigned to the LM family (applies to all 10 archs).
@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES = (
    ShapeCfg("train_4k", 4096, 256, "train"),
    ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    ShapeCfg("decode_32k", 32768, 128, "decode"),
    ShapeCfg("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
