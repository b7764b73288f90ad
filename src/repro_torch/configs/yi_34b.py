"""Yi-34B — Llama-architecture dense model with GQA [arXiv:2403.04652].

60 layers, d_model=7168, 56 heads (GQA kv=8), d_ff=20480, vocab=64000.
long_500k runs under the sliding-window variant [swa-variant].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    long_context_window=8192,
    source="arXiv:2403.04652",
)
