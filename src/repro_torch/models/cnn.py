"""The paper's own CNN models (VGG-19, MobileNetV2) in PyTorch.

The counterpart of ``repro/models/cnn.py``: the model is a list of
``(name, apply_fn)`` units so the NEUKONFIG partitioner can run and
profile any layer range (the paper's "sequence of layers", section II-A);
MobileNetV2's inverted-residual regions are single units ("layers in the
parallel path are not partitioned").  No kernel of the port lies on this
path: the reference's convolutions and pools are XLA's, the port's are
cuDNN's (``torch.nn.functional``).

Layouts.  Activations, ``shapes`` and every stage boundary are NHWC, as in
the reference, so flatten reads (h, w, c) order and the dense weights'
rows match.  A unit views an NHWC tensor as NCHW with ``permute(0, 3, 1,
2)``: a channels-last NCHW tensor, no copy, which cuDNN runs natively.
Params keep the reference's structure and layout (a list with one entry a
unit, ``{}`` for pool and flatten, a list of ``{"expand", "dw",
"project"}`` a block; HWIO conv weights, ``(in, out)`` dense weights), so
``params.from_numpy`` of the reference's params and the ``.npz``
checkpoints of either package carry across.  ``place_params`` stores each
HWIO weight once as a view of an OIHW tensor in channels-last memory (what
``F.conv2d`` takes beside a channels-last input without a copy); the
checkpoint reload keeps that layout (``checkpoint.load_pytree(like=)``).

Padding.  XLA's "SAME" pads ``max((ceil(n / s) - 1) * s + k - n, 0)`` in
all, the smaller half first: at stride 2 on an even size that is (0, 1),
which ``F.conv2d(padding=1)`` would shift, so such a conv pads
explicitly.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import CNNConfig

Unit = Tuple[str, Callable]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_layout(w: torch.Tensor) -> torch.Tensor:
    """An HWIO weight as an HWIO view of an OIHW tensor in channels-last
    memory: ``w.permute(3, 2, 0, 1)`` is then what ``F.conv2d`` takes
    beside a channels-last input, without a copy.  A weight already in
    this layout is returned as it is."""
    return w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last).permute(2, 3, 1, 0)


def place_params(params, device) -> Any:
    """The params on ``device``, each conv weight (4-d, HWIO) in
    ``conv_layout``: once, when the weights are placed."""
    if isinstance(params, dict):
        return {k: place_params(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(place_params(v, device) for v in params)
    t = params.to(device)
    return conv_layout(t) if t.dim() == 4 else t


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int = 1, groups: int = 1) -> torch.Tensor:
    """NHWC ``x`` convolved with the HWIO ``w`` under "SAME" padding,
    plus ``b``; NHWC out."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    ph = same_pads(xc.shape[2], wc.shape[2], stride)
    pw = same_pads(xc.shape[3], wc.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        pad = (0, 0)
    y = F.conv2d(xc, wc, b, stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)


def _dwconv(x, w, b, stride=1):
    return _conv(x, w, b, stride, groups=x.shape[-1])


def _init_conv(gen, k, cin, cout, dtype):
    w = torch.randn((k, k, cin, cout), generator=gen, dtype=dtype,
                    device=gen.device) * np.sqrt(2.0 / (k * k * cin))
    return {"w": w, "b": torch.zeros((cout,), dtype=dtype, device=gen.device)}


def _conv_unit(p, x, s):
    return F.relu(_conv(x, p["w"], p["b"], s))


def _pool_unit(p, x, s):
    y = F.max_pool2d(x.permute(0, 3, 1, 2), s, s)
    return y.permute(0, 2, 3, 1)


def _block_unit(p, x, meta):
    for bp, (stride, residual) in zip(p, meta):
        y = x
        if "expand" in bp:
            y = F.relu6(_conv(y, bp["expand"]["w"], bp["expand"]["b"]))
        y = F.relu6(_dwconv(y, bp["dw"]["w"], bp["dw"]["b"], stride))
        y = _conv(y, bp["project"]["w"], bp["project"]["b"])
        x = x + y if residual else y
    return x


def _flatten_unit(p, x):
    return x.reshape(x.shape[0], -1)


def _dense_unit(p, x, last):
    y = x @ p["w"] + p["b"]
    return y if last else F.relu(y)


def cnn_units(cfg: CNNConfig) -> Tuple[List[Unit], List[Tuple[int, ...]],
                                       List[Any]]:
    """The model's units, ``shapes`` (the activation after unit i at batch
    1, NHWC or (1, features): the boundary the partitioner prices) and
    each unit's param spec: ``None`` (none), ``("conv", k, cin, cout)``,
    ``("block", [(cin, exp, cout, has_expand), ...])`` or ``("dense",
    fan_in, units)``; no weights are made."""
    units: List[Unit] = []
    shapes: List[Tuple[int, ...]] = []
    specs: List[Any] = []
    hw, ch = cfg.input_hw, cfg.input_ch
    n = len(cfg.layers)
    for i, spec in enumerate(cfg.layers):
        if spec.kind == "conv":
            s = spec.stride
            specs.append(("conv", spec.kernel, ch, spec.out_ch))
            units.append((f"conv{i}",
                          lambda p, x, s=s: _conv_unit(p, x, s)))
            hw = -(-hw // s)
            ch = spec.out_ch
        elif spec.kind == "pool":
            s = min(spec.stride, hw)   # clamp (global pool at low input res)
            specs.append(None)
            units.append((f"pool{i}",
                          lambda p, x, s=s: _pool_unit(p, x, s)))
            hw = hw // s
        elif spec.kind == "block":
            # inverted-residual region = ONE partition unit
            subs, meta, in_ch = [], [], ch
            for r in range(spec.repeats):
                stride = spec.stride if r == 0 else 1
                subs.append((in_ch, in_ch * spec.expand, spec.out_ch,
                             spec.expand != 1))
                meta.append((stride, in_ch == spec.out_ch and stride == 1))
                in_ch = spec.out_ch
                hw = -(-hw // stride)
            specs.append(("block", subs))
            units.append((f"block{i}",
                          lambda p, x, meta=tuple(meta):
                          _block_unit(p, x, meta)))
            ch = spec.out_ch
        elif spec.kind == "flatten":
            specs.append(None)
            units.append((f"flatten{i}", _flatten_unit))
        elif spec.kind == "dense":
            fan = shapes[-1][-1]       # the flatten's (or a dense's) width
            specs.append(("dense", fan, spec.units))
            last = i == n - 1
            units.append((f"dense{i}",
                          lambda p, x, last=last: _dense_unit(p, x, last)))
        else:
            raise ValueError(spec.kind)
        if spec.kind == "flatten":
            shapes.append((1, hw * hw * ch))
            ch, hw = hw * hw * ch, 1
        elif spec.kind == "dense":
            shapes.append((1, spec.units))
        else:
            shapes.append((1, hw, hw, ch))
    return units, shapes, specs


def build_cnn(cfg: CNNConfig, generator: Optional[torch.Generator] = None,
              device="cpu", dtype=torch.float32):
    """Returns ``(params, units, shapes)`` as ``repro.models.cnn.build_cnn``
    does: He-normal conv weights (depthwise ``sqrt(2 / 9)``), ``1 /
    fan_in`` dense weights, zero biases, drawn from ``generator`` (seed 0
    on the CPU by default; on its own device) in the reference's order
    (convs and blocks in layer order, the dense layers after), then placed
    on ``device`` (``place_params``)."""
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    units, shapes, specs = cnn_units(cfg)
    params: List[Any] = []
    for spec in specs:
        if spec is None or spec[0] == "dense":
            params.append({})
        elif spec[0] == "conv":
            _, k, cin, cout = spec
            params.append(_init_conv(gen, k, cin, cout, dtype))
        else:
            block = []
            for cin, exp, cout, has_expand in spec[1]:
                bp = {}
                if has_expand:
                    bp["expand"] = _init_conv(gen, 1, cin, exp, dtype)
                bp["dw"] = {"w": torch.randn((3, 3, 1, exp), generator=gen,
                                             dtype=dtype, device=gen.device)
                            * np.sqrt(2.0 / 9),
                            "b": torch.zeros((exp,), dtype=dtype,
                                             device=gen.device)}
                bp["project"] = _init_conv(gen, 1, exp, cout, dtype)
                block.append(bp)
            params.append(block)
    # second pass: dense layers (fan-in from the flatten)
    for i, spec in enumerate(specs):
        if spec is not None and spec[0] == "dense":
            _, fan, n = spec
            params[i] = {"w": torch.randn((fan, n), generator=gen,
                                          dtype=dtype, device=gen.device)
                         * np.sqrt(1.0 / fan),
                         "b": torch.zeros((n,), dtype=dtype,
                                          device=gen.device)}
    return place_params(params, device), units, shapes


def run_range(params, units: List[Unit], x: torch.Tensor, lo: int,
              hi: int) -> torch.Tensor:
    """Run units [lo, hi): the partitioner's stage executor."""
    for i in range(lo, hi):
        x = units[i][1](params[i], x)
    return x


def boundary_bytes(shapes, split: int, batch: int = 1,
                   bytes_per_elem: int = 4) -> int:
    """Bytes crossing the edge->cloud link when splitting after unit
    ``split``."""
    return int(np.prod(shapes[split])) * batch * bytes_per_elem
