"""Data sources of the port (see ``repro.data``)."""
from repro_torch.data.pipeline import Frame, FrameSource, SyntheticTokens
