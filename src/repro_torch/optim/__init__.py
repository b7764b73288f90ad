"""Optimizer of the port (see ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWState, adamw, clip_by_global_norm,
                                     cosine_schedule, global_norm)
