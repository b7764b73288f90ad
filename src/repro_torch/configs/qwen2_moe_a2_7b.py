"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24 layers, d_model=2048, 16 heads (kv=16), per-expert d_ff=1408,
vocab=151936; MoE: 60 routed experts top-4 + 4 shared experts
(shared intermediate = 4x1408 = 5632).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    long_context_window=8192,  # swa-variant for long_500k only (DESIGN.md s4)
    moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=4,
                  expert_d_ff=1408, shared_d_ff=5632),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
