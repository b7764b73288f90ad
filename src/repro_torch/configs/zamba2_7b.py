"""Zamba2-7B — Mamba-2 backbone with shared attention blocks [arXiv:2411.15242].

81 layers, d_model=3584, 32 heads (MHA kv=32), d_ff=14336, vocab=32000,
ssm_state=64.  The shared transformer (attn+MLP) block is applied every 6th
layer, reusing one set of weights (Zamba-style parameter sharing).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2, head_dim=64),
    hybrid_period=6,
    source="arXiv:2411.15242",
)
