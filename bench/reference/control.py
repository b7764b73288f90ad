"""The comparison that decides ``correct``, and its control.

``widest_gap``: at each position, by how much the reference's logit of
the token the program served (its greedy choice) lies below the
reference's best there; the widest over the positions.  A served token
that is the reference's own best gives 0.

``low_precision``: the control's weights.  The configurations are served
in bf16, and the next step down a later change might take is fp8: each
weight rounded to float8 e4m3 with one scale a tensor (its largest
magnitude onto e4m3's largest, 448), then read in f32.  The reference
with these weights, put in the program's place, has to fail the limit.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """``max_p (max_v ref[p, v] - ref[p, tokens[p]])``."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens.reshape(-1, 1).long()).squeeze(-1)
    return float((best - got).max())


def low_precision(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 at one scale a tensor, back in f32."""
    x = t.float()
    amax = x.abs().max()
    if float(amax) == 0.0:
        return x
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale
