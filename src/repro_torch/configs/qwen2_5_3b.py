"""Qwen2.5-3B — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family card].

36 layers, d_model=2048, 16 heads (GQA kv=2), d_ff=11008, vocab=151936.
long_500k runs under the sliding-window variant [swa-variant].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    long_context_window=8192,
    source="hf:Qwen/Qwen2.5-0.5B",
)
