"""Whisper-medium — encoder-decoder speech model [arXiv:2212.04356].

24 encoder + 24 decoder layers, d_model=1024, 16 heads (kv=16), d_ff=4096,
vocab=51865.  The mel-spectrogram + conv frontend is STUBBED per
instructions: ``input_specs()`` provides 1500 precomputed frame embeddings
(Whisper's 30 s context after 2x conv downsampling).

long_500k is SKIPPED for this arch (see DESIGN.md section 4): Whisper's decoder
context is <=448 tokens by construction; a 500k-token transcript decode has
no semantic analogue.  decode_32k lowers the decoder serve_step.
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    encoder=EncoderConfig(num_layers=24, context_len=1500),
    frontend="audio",
    gated_mlp=False,  # whisper uses classic GELU MLPs
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
