"""Sharding rules: logical param/activation/state axes -> mesh axes.

The counterpart of ``repro/distributed/sharding.py``: the same rule
table, MoE expert-parallel fallback, divisibility guard and
``ShardingDegraded`` warning, as pure functions over nested dicts of
tensors (or ``TensorSpec``s) and a ``launch.mesh.CloudMesh``.  Each
function returns a tree of ``P`` (the port's ``PartitionSpec``: a tuple
with one mesh axis, a tuple of axes, or None per dim) where the
reference's returns ``NamedSharding``s.  Trees are walked in sorted key
order, as JAX flattens dicts, so degraded-leaf lists come out in the
reference's order.

Logical axes:
  fsdp   weight sharding axis ("data" on a 2-D mesh), used for training
         and for serving weights that exceed what tensor parallelism
         alone fits;
  tp     tensor-parallel axis = "model": heads / d_ff / experts / vocab.

``shard_tree`` cuts a tree into one tree of contiguous per-shard tensors
per mesh position, each on its shard's device; ``gather_tree`` puts them
back together.  They are how the tensor-parallel executor
(``distributed.tp``) places weights and decode state: its specs are
``param_rules``' except on the attention leaves, which it cuts by whole
heads, and on the Mamba projections whose column groups mean different
things, which it cuts group by group (``Cat``; ``tp.param_specs``).
"""
from __future__ import annotations

import functools
import itertools
import re
import warnings
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import CloudMesh


class P(tuple):
    """A partition spec: per dim, a mesh axis name, a tuple of names, or
    None (replicated)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Cat:
    """The spec of a leaf whose last dim concatenates column groups with
    specs of their own: ``Cat((width, spec), ...)``.  Each shard holds its
    block of every group, concatenated in the groups' order."""

    def __init__(self, *parts):
        self.parts = tuple((int(w), spec) for w, spec in parts)

    def offsets(self):
        """``(offset, width, spec)`` of each group along the last dim."""
        o = 0
        for w, spec in self.parts:
            yield o, w, spec
            o += w

    def __repr__(self) -> str:
        return f"Cat{self.parts!r}"


class ShardingDegraded(UserWarning):
    """A leaf's intended sharding was degraded to replication because a
    tensor dim does not divide its mesh axis.  The maths stays correct;
    the cost is per-device memory and missing parallelism on those
    leaves.  Warned once per ``param_shardings``/``decode_state_shardings``
    call with every degraded leaf listed."""


def _sizes(mesh: CloudMesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def _warn_degraded(fn_name: str, mesh: CloudMesh, degraded) -> None:
    if not degraded:
        return
    detail = ", ".join(f"{name}[dim {dim}]={size} !% {ax}={n}"
                       for name, dim, size, ax, n in degraded[:8])
    more = f" (+{len(degraded) - 8} more)" if len(degraded) > 8 else ""
    warnings.warn(
        f"{fn_name}: {len(degraded)} leaf dim(s) do not divide the "
        f"{_sizes(mesh)} mesh and were replicated: {detail}{more}",
        ShardingDegraded, stacklevel=3)


def mesh_axes(mesh: CloudMesh):
    names = mesh.axis_names
    dp = tuple(n for n in names if n in ("pod", "data"))
    tp = "model" if "model" in names else None
    return dp, tp


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict/list/tuple, keys visited in
    sorted order; the path joins keys and indices with "/"."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        out = {k: map_with_path(fn, tree[k], join(k))
               for k in sorted(tree, key=str)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------

def _stack_dims(name: str) -> int:
    return 1 if name.startswith("layers/") \
        or name.startswith("encoder/layers/") else 0


def _param_spec(name: str, ndim: int, *, fsdp, tp, shard_fsdp: bool,
                shape=None, ax_size=None) -> P:
    """Spec of one leaf; ``ndim`` includes a stacked layer dim, padded
    with None."""
    f = fsdp if shard_fsdp else None
    leaf = name.split("/")[-1]
    table = {
        "embed":    P(tp, f),
        "lm_head":  P(f, tp),
        "vision_proj": P(f, tp),
        "wq": P(f, tp), "wk": P(f, tp), "wv": P(f, tp), "wo": P(tp, f),
        "bq": P(tp), "bk": P(tp), "bv": P(tp),
        "w_gate": P(f, tp), "w_up": P(f, tp), "w_down": P(tp, f),
        "shared_w_gate": P(f, tp), "shared_w_up": P(f, tp),
        "shared_w_down": P(tp, f),
        "router": P(f, None),
        "in_proj": P(f, tp),
        "conv_w": P(None, tp), "conv_b": P(tp),
        "x_proj": P(tp, None),
        "dt_proj": P(None, tp),
        "dt_bias": P(tp),
        "A_log": P(tp),        # mamba1: (Di,N) -> tp on Di; mamba2: (H,) -> tp
        "D": P(tp),
        "out_proj": P(tp, f),
        "norm": P(tp),
        "scale": P(), "bias": P(),
    }
    if leaf not in table:
        return P()
    spec = table[leaf]
    # MoE expert stacks: expert-parallel (experts -> tp) when the count
    # divides the axis, else tensor-parallel inside each expert
    if re.search(r"moe/", name) and leaf in ("w_gate", "w_up", "w_down"):
        n_exp = shape[-3] if shape is not None and len(shape) >= 3 else 0
        expert_par = ax_size is not None and n_exp % ax_size(tp) == 0
        if expert_par:
            spec = P(tp, f, None) if leaf != "w_down" else P(tp, None, f)
        else:
            spec = P(None, f, tp) if leaf != "w_down" else P(None, tp, f)
    if leaf == "A_log" and ndim - _stack_dims(name) == 2:
        spec = P(tp, None)
    extra = ndim - len(spec)
    if extra > 0:
        spec = P(*([None] * extra + list(spec)))
    elif extra < 0:
        spec = P(*list(spec)[-ndim:]) if ndim else P()
    return spec


def param_shardings(cfg: ArchConfig, mesh: CloudMesh, params_shape, *,
                    shard_fsdp: bool = True):
    """Tree of ``P`` matching ``params_shape`` (tensors or specs)."""
    out, degraded = param_rules(cfg, mesh, params_shape,
                                shard_fsdp=shard_fsdp)
    _warn_degraded("param_shardings", mesh, degraded)
    return out


def param_rules(cfg: ArchConfig, mesh: CloudMesh, params_shape, *,
                shard_fsdp: bool = True):
    """``param_shardings``' specs and the leaf dims its guard degraded
    (``(name, dim, size, axis, axis size)``), without the warning."""
    dp, tp = mesh_axes(mesh)
    fsdp = dp if len(dp) > 1 else (dp[0] if dp else None)
    sizes = _sizes(mesh)

    def ax_size(a):
        if a is None:
            return 1
        if isinstance(a, tuple):
            return int(np.prod([sizes[x] for x in a]))
        return sizes[a]

    degraded = []

    def rule(name, leaf):
        shape = _shape(leaf)
        spec = _param_spec(name, len(shape), fsdp=fsdp, tp=tp,
                           shard_fsdp=shard_fsdp, shape=shape,
                           ax_size=ax_size)
        # divisibility guard: replicate any dim that does not divide its
        # axis, and say so
        fixed = []
        for dim, ax in enumerate(spec):
            n = ax_size(ax)
            if n > 1 and shape[dim] % n != 0:
                degraded.append((name, dim, shape[dim], ax, n))
                fixed.append(None)
            else:
                fixed.append(ax)
        return P(*fixed)

    return map_with_path(rule, params_shape), degraded


def should_shard_fsdp_serving(cfg: ArchConfig, mesh: CloudMesh,
                              bytes_per_param: int = 2) -> bool:
    """Serve with weights sharded beyond TP only if TP alone won't fit
    (the reference's 10 GB a device)."""
    tp_size = _sizes(mesh).get("model", 1)
    per_dev = cfg.param_count() * bytes_per_param / tp_size
    return per_dev > 10e9


# ---------------------------------------------------------------------------
# activation / input / state shardings
# ---------------------------------------------------------------------------

def batch_spec(mesh: CloudMesh) -> P:
    dp, _ = mesh_axes(mesh)
    return P(dp if len(dp) > 1 else (dp[0] if dp else None))


def input_shardings(cfg: ArchConfig, mesh: CloudMesh, inputs_shape,
                    shape: InputShape):
    """Tree of ``P`` for the inputs of this shape: batch -> data when the
    global batch covers it."""
    dp, _ = mesh_axes(mesh)
    dpa = dp if len(dp) > 1 else (dp[0] if dp else None)
    sizes = _sizes(mesh)
    dp_size = int(np.prod([sizes[x] for x in (
        dp if isinstance(dpa, tuple) else (dpa,))])) if dpa else 1
    b_ok = shape.global_batch >= dp_size

    def rule(name, leaf):
        spec = [None] * len(_shape(leaf))
        if spec and b_ok:
            spec[0] = dpa
        return P(*spec)

    return map_with_path(rule, inputs_shape)


def cache_shardings(cfg: ArchConfig, mesh: CloudMesh, cache_shape,
                    shape: InputShape, kv_layout: str = "heads"):
    """Decode-cache specs (``transformer.init_cache``'s stacked layout).

    kv_layout='heads': batch -> dp, kv heads -> tp (or head_dim -> tp for
    GQA with KH < tp); kv_layout='seq': batch -> dp, cache SEQUENCE -> tp.
    Mamba states: channels/heads -> tp, batch -> dp when divisible."""
    dp, tp = mesh_axes(mesh)
    dpa = dp if len(dp) > 1 else (dp[0] if dp else None)
    sizes = _sizes(mesh)
    dp_size = int(np.prod([sizes[x] for x in dp])) if dp else 1
    tp_size = sizes.get("model", 1)
    b_ok = shape.global_batch >= dp_size

    def rule(name, leaf):
        shp = _shape(leaf)
        nd = len(shp)
        if name == "pos":
            return P()
        if "conv" in name:     # (L, B, K-1, C)
            spec = [None, dpa if b_ok else None, None, tp]
            return P(*spec[:nd])
        if "ssm" in name and nd == 4:   # mamba1 (L, B, Di, N)
            return P(None, dpa if b_ok else None, tp, None)
        if "ssm" in name and nd == 5:   # mamba2 (L, B, H, P, N)
            return P(None, dpa if b_ok else None, tp, None, None)
        if nd == 5:       # heads-major (L_or_apps, B, KH, S, hd) kv cache
            spec = [None] * 5
            seq_ax = None
            if b_ok:
                spec[1] = dpa
            else:
                seq_ax = "data" if "data" in mesh.axis_names else None
            if kv_layout == "seq":
                seq_ax = tp if seq_ax is None else ("data", "model")
                n = tp_size if seq_ax == tp else tp_size * dp_size
                if shp[3] % n == 0:
                    spec[3] = seq_ax
            else:
                if seq_ax is not None and shp[3] % dp_size == 0:
                    spec[3] = seq_ax
                if shp[2] % tp_size == 0:
                    spec[2] = tp
                elif shp[4] % tp_size == 0:
                    spec[4] = tp
            return P(*spec)
        return P()

    return map_with_path(rule, cache_shape)


def decode_state_shardings(cfg: ArchConfig, mesh: CloudMesh, state):
    """Specs for a live serving state dict (``DecodeSession.cache``
    entries ``k{i}``/``v{i}``/``ak{g}``/``av{g}`` heads-major (B, KH, S,
    hd), ``conv{i}`` (B, K-1, C), ``ssm{i}``).  Tensor-parallel only (a
    batch-of-1 stream replicates over data); non-divisible dims degrade
    to replication with a ``ShardingDegraded`` warning."""
    _, tp = mesh_axes(mesh)
    tp_size = _sizes(mesh).get("model", 1)
    degraded = []

    def want(name: str, nd: int):
        if name[0] in ("k", "v", "a") and nd == 4:   # (B, KH, S, hd)
            return [(1, 3)]      # kv heads -> tp, else head_dim -> tp
        if name.startswith("conv"):                  # (B, K-1, C)
            return [(nd - 1,)]
        if name.startswith("ssm"):                   # channels/heads dim
            return [(1,)]
        return []

    def rule(name, leaf):
        shp = _shape(leaf)
        spec = [None] * len(shp)
        if tp is not None and tp_size > 1:
            for dims in want(name, len(shp)):
                hit = next((d for d in dims if shp[d] % tp_size == 0), None)
                if hit is not None:
                    spec[hit] = tp
                else:
                    degraded.append((name, dims[0], shp[dims[0]], tp,
                                     tp_size))
        return P(*spec)

    out = map_with_path(rule, state)
    _warn_degraded("decode_state_shardings", mesh, degraded)
    return out


# ---------------------------------------------------------------------------
# placing a tree on the mesh
# ---------------------------------------------------------------------------

def _positions(mesh: CloudMesh) -> Tuple[dict, ...]:
    """Each shard's coordinate along every axis, in row-major order."""
    return _coords(mesh.axis_names, mesh.shape)


@functools.lru_cache(maxsize=None)
def _coords(axis_names: tuple, shape: tuple) -> Tuple[dict, ...]:
    return tuple(dict(zip(axis_names, c))
                 for c in itertools.product(*map(range, shape)))


def _block(spec: Sequence, shape: tuple, coords: dict, sizes: dict):
    """The slices of ``shape`` the shard at ``coords`` holds.  A sharded
    dim that divides by its axis is cut in equal blocks; one shorter than
    its axis that divides the axis is spread, each index held by
    ``axis / dim`` consecutive shards."""
    out = []
    for dim, n_dim in enumerate(shape):
        ax = spec[dim] if dim < len(spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * sizes[a] + int(coords[a]), n * sizes[a]
        if n_dim % n == 0:
            c = n_dim // n
            out.append(slice(idx * c, (idx + 1) * c))
        elif n % n_dim == 0:
            i = idx * n_dim // n
            out.append(slice(i, i + 1))
        else:
            raise ValueError(f"dim {dim} of {shape} does not split over "
                             f"{ax}={n}")
    return tuple(out)


def _by_path(tree) -> dict:
    flat = {}
    map_with_path(lambda n, x: flat.__setitem__(n, x), tree)
    return flat


def _cut(t, spec, coords: dict, sizes: dict):
    """The block of ``t`` the shard at ``coords`` holds under ``spec``."""
    if isinstance(spec, Cat):
        return torch.cat([_cut(t[..., o:o + w], s, coords, sizes)
                          for o, w, s in spec.offsets()], dim=-1)
    return t[_block(spec, tuple(t.shape), coords, sizes)]


def _place(out, part, spec, coords: dict, sizes: dict, done: set,
           at: tuple = ()) -> None:
    """Copy ``part``, the block of the shard at ``coords`` under
    ``spec``, into ``out``, the whole leaf, unless a replica of it was
    copied already (``done``)."""
    if isinstance(spec, Cat):
        col = 0
        for o, w, s in spec.offsets():
            dst = out[..., o:o + w]
            n = len(range(w)[_block(s, tuple(dst.shape), coords, sizes)[-1]])
            _place(dst, part[..., col:col + n], s, coords, sizes, done,
                   at + (o,))
            col += n
        return
    block = _block(spec, tuple(out.shape), coords, sizes)
    key = at + tuple((b.start, b.stop) for b in block)
    if key not in done:
        done.add(key)
        out[block] = part


def shard_tree(tree, specs, mesh: CloudMesh) -> list:
    """One tree per mesh position (row-major): each leaf's block under its
    spec, as a contiguous tensor of its own on the shard's device."""
    sizes = _sizes(mesh)
    specs_by_path = _by_path(specs)

    def one(coords, dev):
        def cut(name, t):
            block = _cut(t, specs_by_path[name], coords, sizes)
            return torch.empty(block.shape, dtype=t.dtype,
                               device=dev).copy_(block)
        return map_with_path(cut, tree)
    return [one(c, d) for c, d in zip(_positions(mesh), mesh.devices)]


def blocks(t, spec, mesh: CloudMesh) -> list:
    """The block of ``t`` each mesh position holds under ``spec``, in
    ``shard_tree``'s order, where ``t`` lies (views where ``spec`` has no
    ``Cat``; no copy to the shards' devices)."""
    sizes = _sizes(mesh)
    return [_cut(t, spec, c, sizes) for c in _positions(mesh)]


def gather_tree(shards: list, specs, mesh: CloudMesh, device, like) -> Any:
    """Inverse of ``shard_tree``: whole tensors shaped as ``like``'s
    leaves (tensors or specs) on ``device``, each block copied from the
    first shard that holds it."""
    sizes = _sizes(mesh)
    positions = _positions(mesh)
    specs_by_path = _by_path(specs)
    shapes = _by_path(like)
    parts = [_by_path(tree) for tree in shards]

    def put(name, t0):
        spec = specs_by_path[name]
        shape = tuple(shapes[name].shape)
        out = torch.empty(shape, dtype=t0.dtype, device=device)
        done = set()
        for coords, part in zip(positions, parts):
            _place(out, part[name], spec, coords, sizes, done)
        return out
    return map_with_path(put, shards[0])

