"""The tensor-parallel cloud stage of the attention families (``dense``,
``vlm``): what GSPMD does for the reference, done explicitly by the one
process that holds the pool.

The reference compiles its cloud stage SPMD over a device mesh from the
rules in ``distributed/sharding.py``, and GSPMD inserts the collectives.
Eager PyTorch has no partitioner, so this module places each shard's
weights and decode state on the shard's device (``launch.mesh``) and runs
the cloud range shard by shard, issuing the all-reduces itself.  One
Python thread drives every shard; there is no process group.

Layout, for a mesh whose ``"model"`` axis has ``tp`` shards (a leading
``"data"`` axis holds no copy: a batch-of-1 stream has nothing to split
over it, so the executor runs on the mesh's first row).  It is a spec per
leaf (``param_specs``), placed by ``sharding.shard_tree``; the specs are
the reference's rules (``sharding.param_rules``) except where noted:

* attention: ``wq``/``bq`` column-parallel by query heads, shard ``i``
  holding heads ``[i H/tp, (i+1) H/tp)``; ``wo`` row-parallel over the
  same heads.  ``wk``/``wv``/``bk``/``bv`` and the decode state hold the
  KV heads those query heads read.  Where ``num_kv_heads < tp`` the
  reference's rules shard ``wk``/``wv`` and the cache on ``head_dim``
  and GSPMD all-reduces the scores; here each KV head is spread over the
  ``tp / KH`` shards that share it instead, so every shard's attention
  is head-local and runs the hand-written kernels on its own contiguous
  Q/K/V and caches.  Where the heads do not split so (``H % tp``, or KV
  heads that neither divide nor are divided by ``tp``) attention runs
  replicated, where the rules may still cut the columns.
* MLP: ``w_gate``/``w_up`` column-parallel over ``d_ff``, ``w_down``
  row-parallel.
* every row-parallel product is followed by ``all_reduce``: the partials
  summed in shard order on the first shard's device and the sum copied
  back to each shard, so two runs on one mesh are bit-equal.
* the head is vocabulary-parallel (the tied embedding's rows, or the
  untied ``lm_head``'s columns), its logits concatenated in shard order
  on the first shard's device.  Norms are replicated; so is the residual
  stream.  ``vision_proj`` and an untied ``embed`` follow the rules and
  are never read on the mesh (the edge's unit 0 reads them).
* where ``d_ff`` or the vocabulary does not divide, the rules replicate
  that block and it runs replicated on every shard (the head: on the
  first); every block that runs replicated is named in one
  ``ShardingDegraded`` warning, as the reference degrades its argument
  shardings.

The numbers are the reference's: only their placement differs.  The
``moe``, ``ssm``, ``hybrid`` and ``audio`` families raise
``NotImplementedError`` (ROADMAP.md, Queue A item 4).
"""
from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import (P, ShardingDegraded,
                                              gather_tree, map_with_path,
                                              param_rules, shard_tree)
from repro_torch.launch.mesh import CloudMesh
from repro_torch.models import layers as Lyr
from repro_torch.models import transformer as T

_TP_FAMILIES = ("dense", "vlm")
_LATER = {"moe": "the expert-parallel MoE",
          "ssm": "channel-parallel Mamba-1",
          "hybrid": "channel-parallel Mamba-2",
          "audio": "whisper's encoder and cross attention"}


def check_family(cfg) -> None:
    """Raise unless the executor runs ``cfg``'s family on a mesh."""
    if cfg.family in _TP_FAMILIES:
        return
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"a sharded cloud stage of the {cfg.family!r} family is not "
            f"ported yet: it comes with the slice that ports "
            f"{_LATER[cfg.family]} (ROADMAP.md, Queue A item 4)")
    raise NotImplementedError(f"no sharded cloud stage for {cfg.family!r}")


def shard_devices(mesh: CloudMesh) -> Tuple[torch.device, ...]:
    """The devices the executor runs on: the model axis' first row."""
    return tuple(mesh.devices[:mesh.tp])


def _on(device: torch.device):
    """Launch on ``device``'s card (the kernels launch on the current
    device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def synchronize_mesh(mesh: CloudMesh) -> None:
    for d in set(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TPLayout:
    """Each shard's slice of every sharded dimension; None where the block
    runs replicated.  ``heads[i]`` = ``(q_lo, q_hi, kv_lo, kv_hi)``."""
    tp: int
    heads: Optional[Tuple[Tuple[int, int, int, int], ...]]
    ff: Optional[Tuple[Tuple[int, int], ...]]
    vocab: Optional[Tuple[Tuple[int, int], ...]]
    degraded: Tuple[str, ...]


def _ranges(n: int, tp: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((i * n // tp, (i + 1) * n // tp) for i in range(tp))


def _head_ranges(H: int, KH: int, tp: int):
    """Each shard's query heads and the KV heads they read: the KV heads
    in equal blocks where ``tp`` divides them, each spread over ``tp /
    KH`` shards where they divide ``tp`` (``sharding._block``); None
    where the heads do not split so."""
    if H % tp or (KH % tp and tp % KH):
        return None
    kv = max(KH // tp, 1)
    return tuple((q_lo, q_hi, i * KH // tp, i * KH // tp + kv)
                 for i, (q_lo, q_hi) in enumerate(_ranges(H, tp)))


def tp_layout(cfg, tp: int) -> TPLayout:
    check_family(cfg)
    degraded = []
    heads = _head_ranges(cfg.num_heads, cfg.num_kv_heads, tp)
    if heads is None:
        degraded.append(f"attention: num_heads={cfg.num_heads}, "
                        f"num_kv_heads={cfg.num_kv_heads} !% model={tp}")
    ff = _ranges(cfg.d_ff, tp) if cfg.d_ff % tp == 0 else None
    if ff is None:
        degraded.append(f"mlp: d_ff={cfg.d_ff} !% model={tp}")
    vocab = _ranges(cfg.vocab_size, tp) if cfg.vocab_size % tp == 0 \
        else None
    if vocab is None:
        degraded.append(f"head: vocab_size={cfg.vocab_size} !% model={tp}")
    return TPLayout(tp, heads, ff, vocab, tuple(degraded))


def row_mesh(mesh: CloudMesh) -> CloudMesh:
    """The ``"model"`` axis' first row, the shards the executor runs on."""
    return CloudMesh(("model",), (mesh.tp,), shard_devices(mesh))


# ---------------------------------------------------------------------------
# placed weights
# ---------------------------------------------------------------------------

# attention leaves -> the dim that holds their heads (times head_dim)
_HEAD_DIM = {"wq": -1, "bq": -1, "wk": -1, "bk": -1, "wv": -1, "bv": -1,
             "wo": -2}


def _leaf(name: str) -> str:
    return name.rsplit("/", 1)[-1]


def by_heads(cfg, params):
    """``params`` with each attention leaf viewed with its heads as a dim
    of their own, ``(..., heads, head_dim, ...)`` (no copy)."""
    def view(name, t):
        dim = _HEAD_DIM.get(_leaf(name)) if "attn/" in name else None
        return t if dim is None else t.unflatten(dim, (-1, cfg.head_dim))
    return map_with_path(view, params)


def _flat(name: str, t):
    dim = _HEAD_DIM.get(_leaf(name)) if "attn/" in name else None
    return t if dim is None else t.flatten(dim - 1, dim)


def param_specs(cfg, params, mesh: CloudMesh):
    """The executor's layout: ``(TPLayout, specs)``, a spec per leaf of
    ``by_heads(cfg, params)`` over ``row_mesh(mesh)``.  They are the
    reference's rules (``sharding.param_rules``, no fsdp), except on the
    attention leaves, cut by whole heads or replicated (``tp_layout``):
    the rules cut ``wk``/``wv`` on ``head_dim`` where ``num_kv_heads <
    tp``, and shard the columns of heads that do not split."""
    row = row_mesh(mesh)
    lay = tp_layout(cfg, row.tp)
    rules, _ = param_rules(cfg, row, params, shard_fsdp=False)
    heads = "model" if lay.heads is not None else None

    def spec(name, rule):
        dim = _HEAD_DIM.get(_leaf(name)) if "attn/" in name else None
        if dim is None:
            return rule
        out = [None] * (len(rule) + 1)
        out[dim - 1] = heads
        return P(*out)
    return lay, map_with_path(spec, rules)


@dataclass
class TPParams:
    """One tree of contiguous weights per shard, in the executor's layout.
    ``logical_bytes`` is the whole tree's size, what the reference counts
    for its mesh-resident copy."""
    mesh: CloudMesh
    layout: TPLayout
    shards: List[Dict[str, Any]]
    logical_bytes: int

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return shard_devices(self.mesh)


def place_params(cfg, params, mesh: CloudMesh) -> TPParams:
    """Copy ``params`` onto the mesh in the executor's layout
    (``param_specs``, placed by ``sharding.shard_tree``; warns
    ``ShardingDegraded`` for each block that runs replicated)."""
    lay, specs = param_specs(cfg, params, mesh)
    if lay.degraded:
        warnings.warn(f"tensor-parallel executor: {len(lay.degraded)} "
                      f"block(s) do not divide the "
                      f"{dict(zip(mesh.axis_names, mesh.shape))} mesh and "
                      f"run replicated: {', '.join(lay.degraded)}",
                      ShardingDegraded, stacklevel=2)
    shards = [map_with_path(_flat, tree) for tree in
              shard_tree(by_heads(cfg, params), specs, row_mesh(mesh))]
    from repro_torch.core.stages import param_bytes
    return TPParams(mesh, lay, shards, param_bytes(params))


# ---------------------------------------------------------------------------
# placed decode state
# ---------------------------------------------------------------------------

class ShardedTensor:
    """A heads-major KV state entry (B, KH, S, hd) on the mesh, cut on its
    heads as the executor cuts ``wk``/``wv`` (``state_spec``): each shard
    holds its heads as a contiguous tensor on its device.  ``shape``,
    ``dtype``, ``numel`` and ``element_size`` describe the whole entry."""
    __slots__ = ("shards", "spec", "row", "shape", "dtype", "mesh_key")

    def __init__(self, shards, spec, row, shape, dtype, mesh_key):
        self.shards = list(shards)
        self.spec = spec
        self.row = row
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.mesh_key = mesh_key

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def numel(self) -> int:
        return self.shape.numel()

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def gather(self, device) -> torch.Tensor:
        """The whole entry on ``device`` (``sharding.gather_tree``)."""
        return gather_tree(self.shards, self.spec, self.row, device,
                           like=self)

    def clone(self) -> "ShardedTensor":
        return ShardedTensor([t.clone() for t in self.shards], self.spec,
                             self.row, self.shape, self.dtype, self.mesh_key)


def state_spec(layout: TPLayout) -> P:
    """A KV entry's spec: its heads as ``wk``'s, on the model axis."""
    return P(None, "model" if layout.heads is not None else None)


def place_entry(tpp: TPParams, t) -> ShardedTensor:
    """A whole KV entry (or one placed on another mesh) on ``tpp``'s."""
    if isinstance(t, ShardedTensor):
        if t.mesh_key == tpp.mesh.key():
            return t
        t = t.gather(tpp.devices[0])
    spec, row = state_spec(tpp.layout), row_mesh(tpp.mesh)
    return ShardedTensor(shard_tree(t, spec, row), spec, row, t.shape,
                         t.dtype, tpp.mesh.key())


def whole(t, device) -> torch.Tensor:
    """``t`` as a whole tensor on ``device`` (gathered if sharded)."""
    return t.gather(device) if isinstance(t, ShardedTensor) else t


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Sum the shards' partials in shard order on the first shard's
    device and copy the sum back to each shard (counted in
    ``all_reduce.calls``)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(devices[0])
    all_reduce.calls += 1
    return [total.to(d) for d in devices]


all_reduce.calls = 0


def _residual(xs, parts, devices, sharded: bool):
    """``x + y`` on each shard: ``y`` the all-reduced partials of a
    row-parallel product, or each shard's own where the block ran
    replicated."""
    ys = all_reduce(parts, devices) if sharded else parts
    out = []
    for d, x, y in zip(devices, xs, ys):
        with _on(d):
            out.append(x + y)
    return out


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def replicate(x: torch.Tensor, devices) -> List[torch.Tensor]:
    return [x.to(d) for d in devices]


def _mlp_block(cfg, tpp: TPParams, li: int, xs):
    devs = tpp.devices
    parts = []
    for d, x, p in zip(devs, xs, tpp.shards):
        with _on(d):
            lp = T.layer_params(p, li)
            h = T._apply_norm(cfg, lp["ln2"], x)
            parts.append(Lyr.mlp(lp["mlp"], h, gated=cfg.gated_mlp))
    return _residual(xs, parts, devs, tpp.layout.ff is not None)


def full_layer(cfg, tpp: TPParams, li: int, xs, ropes, *, impl: str):
    """Decoder layer ``li`` over a full sequence: the replicated hidden
    ``xs`` in, the replicated hidden out."""
    devs = tpp.devices
    parts = []
    for d, x, p in zip(devs, xs, tpp.shards):
        with _on(d):
            parts.append(T.attn_out_full(cfg, T.layer_params(p, li), x,
                                         ropes[d], impl=impl,
                                         window=cfg.sliding_window)[0])
    xs = _residual(xs, parts, devs, tpp.layout.heads is not None)
    return _mlp_block(cfg, tpp, li, xs)


def head(cfg, tpp: TPParams, xs, *, last: bool) -> torch.Tensor:
    """Final norm and the vocabulary-parallel head: f32 logits on the
    first shard's device (``last``: of the last row only)."""
    devs = tpp.devices
    n = len(devs) if tpp.layout.vocab is not None else 1
    outs = []
    for d, x, p in list(zip(devs, xs, tpp.shards))[:n]:
        with _on(d):
            if last:
                x = x[:, -1:]
            x = T._apply_norm(cfg, p["final_norm"], x)
            y = (x @ T.lm_head_weights(cfg, p)).float()
            outs.append(y[:, 0] if last else y)
    if n == 1:
        return outs[0]
    return torch.cat([y.to(devs[0]) for y in outs], dim=-1)


def run_units(cfg, tpp: TPParams, state, lo: int, hi: int, *,
              impl: str, num_units: int):
    """``StageRunner``'s units ``[lo, hi)`` (``lo >= 1``: the embedding
    stays on the edge) over ``state["h"]``, on the mesh; the result lies
    on the first shard's device."""
    if lo < 1:
        raise ValueError("the embedding unit runs on the edge, not the mesh")
    devs = tpp.devices
    xs = replicate(state["h"], devs)
    ropes = {d: T._rope_for(cfg, xs[0].shape[1], device=d)
             for d in set(devs)}
    for i in range(lo, hi):
        if i == num_units - 1:
            return {"logits": head(cfg, tpp, xs, last=False)}
        xs = full_layer(cfg, tpp, i - 1, xs, ropes, impl=impl)
    return {"h": xs[0]}


def decode_units(cfg, tpp: TPParams, layers: Sequence[int], x, cache,
                 pos, attend: Callable):
    """One token through decoder ``layers`` on the mesh.  ``cache`` maps
    ``k{i}``/``v{i}`` to entries (a whole entry is placed on the mesh
    first); each shard writes its heads' K/V at ``pos`` in place and
    attends with ``attend(q, k_cache, v_cache, valid)``.  Returns the
    replicated hidden, the entries written, and each layer's input
    (stacked, on the first shard's device)."""
    devs = tpp.devices
    xs = replicate(x, devs)
    B = x.shape[0]
    hd = cfg.head_dim
    poss = {d: pos.to(d) for d in set(devs)}
    ropes = {}
    for d, p in poss.items():
        if p.dim() == 0:
            cos, sin = Lyr.rope_cos_sin(p.reshape(1), hd, cfg.rope_theta)
            ropes[d] = (cos[None], sin[None])
        else:
            ropes[d] = Lyr.rope_cos_sin(p[:, None], hd, cfg.rope_theta)
    valid = {d: p + 1 for d, p in poss.items()}
    new: Dict[str, ShardedTensor] = {}
    bounds = []
    for li in layers:
        bounds.append(xs[0])
        kk, vk = f"k{li}", f"v{li}"
        kc, vc = place_entry(tpp, cache[kk]), place_entry(tpp, cache[vk])
        new[kk], new[vk] = kc, vc
        parts = []
        for s, (d, x_s, p) in enumerate(zip(devs, xs, tpp.shards)):
            with _on(d):
                lp = T.layer_params(p, li)
                h = T._apply_norm(cfg, lp["ln1"], x_s)
                q, k, v = T._project_qkv(cfg, lp["attn"], h)
                cos, sin = ropes[d]
                q, k = Lyr.apply_rope(q, cos, sin), Lyr.apply_rope(k, cos, sin)
                kcs, vcs = kc.shards[s], vc.shards[s]
                where = poss[d].reshape(-1, 1, 1, 1).long().expand(
                    B, kcs.shape[1], 1, hd)
                kcs.scatter_(2, where, k.transpose(1, 2).to(kcs.dtype))
                vcs.scatter_(2, where, v.transpose(1, 2).to(vcs.dtype))
                att = attend(q, kcs, vcs, valid[d])
                parts.append(att.reshape(B, 1, -1) @ lp["attn"]["wo"])
        xs = _residual(xs, parts, devs, tpp.layout.heads is not None)
        xs = _mlp_block(cfg, tpp, li, xs)
    b = torch.stack(bounds) if bounds \
        else x.new_zeros((0,) + tuple(x.shape)).to(devs[0])
    return xs, new, b
