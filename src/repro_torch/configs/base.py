"""Architecture + input-shape configuration for the repro framework.

Every assigned architecture gets one module in this package defining a
module-level ``CONFIG`` (exact published dims, source cited in its docstring)
and is registered in ``registry.py``.  ``ArchConfig.reduced()`` produces the
CPU-smoke variant (<=2 layers, d_model<=512, <=4 experts) required by the
per-arch smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    num_shared_experts: int = 0
    expert_d_ff: int = 0        # per routed expert
    shared_d_ff: int = 0        # total for the shared expert block
    router_aux_coef: float = 0.01
    capacity_factor: object = 1.25  # None -> no-drop dispatch (capacity = T)


@dataclass(frozen=True)
class SSMConfig:
    kind: str                   # 'mamba1' | 'mamba2'
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64          # mamba2 only
    dt_rank: int = 0            # mamba1: ceil(d_model/16) when 0


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) models."""
    num_layers: int
    context_len: int            # number of frame embeddings fed to the encoder


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None      # native SWA (mixtral)
    long_context_window: Optional[int] = None  # swa-variant used only for long_500k
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_period: int = 0      # zamba2: shared attn block applied every N layers
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None  # 'vision' | 'audio' (stubbed; embeddings provided)
    frontend_tokens: int = 0        # patch/frame embeddings prepended (vlm)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    gated_mlp: bool = True      # SwiGLU (3 mats) vs classic GELU MLP (2 mats)
    source: str = ""            # citation

    # ---- derived -------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm is not None and self.ssm.kind == "mamba1" and self.ssm.dt_rank == 0:
            object.__setattr__(
                self, "ssm",
                dataclasses.replace(self.ssm, dt_rank=-(-self.d_model // 16)))

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def supports_long_context(self) -> bool:
        """Whether long_500k decode is runnable (sub-quadratic path exists)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window is not None or self.long_context_window is not None:
            return True
        return False

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-decoder-layer block kind ('attn', 'mamba1', 'mamba2')."""
        if self.family == "ssm":
            return (self.ssm.kind,) * self.num_layers
        if self.family == "hybrid":
            # mamba2 backbone; shared attn applied every `hybrid_period` layers
            return tuple("mamba2" for _ in range(self.num_layers))
        return ("attn",) * self.num_layers

    def reduced(self) -> "ArchConfig":
        """CPU smoke variant of the same family (2 layers, d_model<=512, <=4 experts)."""
        heads = min(self.num_heads, 4) or 4
        kv = max(1, heads * self.num_kv_heads // max(self.num_heads, 1)) if self.num_kv_heads else 0
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                expert_d_ff=128, shared_d_ff=128,
                capacity_factor=None)  # exact dispatch for correctness tests
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=min(self.ssm.d_state, 16),
                                      head_dim=32, dt_rank=16)
        enc = None
        if self.encoder is not None:
            enc = EncoderConfig(num_layers=2, context_len=16)
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=2, d_model=256,
            num_heads=heads, num_kv_heads=kv, head_dim=256 // heads if heads else 0,
            d_ff=512, vocab_size=512, moe=moe, ssm=ssm, encoder=enc,
            hybrid_period=2 if self.hybrid_period else 0,
            sliding_window=64 if self.sliding_window else None,
            long_context_window=64 if self.long_context_window else None,
            frontend_tokens=8 if self.frontend_tokens else 0)

    # ---- analytics -----------------------------------------------------
    def param_count(self) -> int:
        """Decoder-stack parameter estimate (used for 6ND model-FLOPs)."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        kinds = self.layer_kinds()
        for k in kinds:
            if k == "attn":
                per_layer = self._attn_params() + self._ffn_params()
                break
        total = 0
        for k in kinds:
            if k == "attn":
                total += self._attn_params() + self._ffn_params()
            elif k == "mamba1":
                total += self._mamba1_params()
            elif k == "mamba2":
                total += self._mamba2_params()
        if self.family == "hybrid" and self.hybrid_period:
            total += self._attn_params() + self._ffn_params()  # one shared block
        if self.encoder is not None:
            total += self.encoder.num_layers * (
                self._attn_params() + self._ffn_params())
            total += L * self._attn_params()  # decoder cross-attn
        return emb + total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full_moe = self.moe.num_experts * 3 * d * self.moe.expert_d_ff
        active_moe = self.moe.top_k * 3 * d * self.moe.expert_d_ff
        return self.param_count() - self.num_layers * (full_moe - active_moe)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads + hd * self.num_heads * d

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            routed = m.num_experts * 3 * d * m.expert_d_ff
            shared = 3 * d * m.shared_d_ff if m.num_shared_experts else 0
            router = d * m.num_experts
            return routed + shared + router
        n_mats = 3 if self.gated_mlp else 2
        return n_mats * d * self.d_ff

    def _mamba1_params(self) -> int:
        d, di = self.d_model, self.d_inner
        s = self.ssm
        return (d * 2 * di + di * s.d_conv + di * (s.dt_rank + 2 * s.d_state)
                + s.dt_rank * di + di * s.d_state + di + di * d)

    def _mamba2_params(self) -> int:
        d, di = self.d_model, self.d_inner
        s = self.ssm
        nheads = di // s.head_dim
        return (d * (2 * di + 2 * s.d_state + nheads) + di * s.d_conv
                + nheads + nheads + di + di * d)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


# ---------------------------------------------------------------------------
# CNN configs (the paper's own models: VGG-19 / MobileNetV2, Figs. 2-3)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CNNLayer:
    kind: str                   # conv | dwconv | pool | flatten | dense | block
    out_ch: int = 0
    kernel: int = 3
    stride: int = 1
    units: int = 0              # dense
    expand: int = 0             # mobilenet inverted residual expansion
    repeats: int = 1            # block: treated as one unit (paper §II-A)


@dataclass(frozen=True)
class CNNConfig:
    name: str
    family: str
    input_hw: int
    input_ch: int
    layers: Tuple[CNNLayer, ...]
    num_classes: int
    source: str = ""

    def reduced(self) -> "CNNConfig":
        return self  # CNN configs are already laptop-scale
