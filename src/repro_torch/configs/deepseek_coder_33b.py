"""DeepSeek-Coder-33B — Llama-architecture dense model [arXiv:2401.14196].

62 layers, d_model=7168, 56 heads (GQA kv=8), d_ff=19200, vocab=32256.
long_500k runs under the sliding-window variant [swa-variant].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    long_context_window=8192,
    source="arXiv:2401.14196",
)
