"""Mixtral-8x22B [arXiv:2401.04088].

56 layers, d_model=6144, 48 heads (GQA kv=8), d_ff=16384, vocab=32768,
8 experts top-2, sliding-window attention (window 4096 per Mistral lineage).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=0,
                  expert_d_ff=16384),
    source="arXiv:2401.04088",
)
