"""InternVL2-76B — InternViT vision encoder + LLM backbone [arXiv:2404.16821].

Assigned spec covers the TRANSFORMER BACKBONE (Llama-3-70B-shaped LM):
80 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=28672, vocab=128256.
The InternViT frontend is STUBBED per instructions: ``input_specs()``
provides precomputed patch embeddings (frontend_tokens x d_model) that are
prepended to the token embeddings.

long_500k runs under the sliding-window variant (long_context_window=8192),
marked [swa-variant] in the roofline table.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    frontend="vision",
    frontend_tokens=256,
    long_context_window=8192,
    source="arXiv:2404.16821",
)
