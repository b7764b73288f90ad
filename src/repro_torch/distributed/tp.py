"""The tensor-parallel cloud stage of every served family (``dense``,
``vlm``, ``moe``, ``ssm``, ``hybrid``, ``audio``): what GSPMD does for
the reference, done explicitly by the one process that holds the pool.

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

* attention (the decoder's, the hybrid family's shared block's,
  whisper's self and cross attention): ``wq``/``bq`` column-parallel by
  query heads, shard ``i`` holding heads ``[i H/tp, (i+1) H/tp)``; ``wo``
  row-parallel over the same heads.  ``wk``/``wv``/``bk``/``bv`` and the
  decode state hold the KV heads those query heads read.  Where
  ``num_kv_heads < tp`` the reference's rules shard ``wk``/``wv`` and the
  cache on ``head_dim`` and GSPMD all-reduces the scores; here each KV
  head is spread over the ``tp / KH`` shards that share it instead, so
  every shard's attention is head-local and runs the hand-written kernels
  on its own contiguous Q/K/V and caches.  Where the heads do not split
  so (``H % tp``, or KV heads that neither divide nor are divided by
  ``tp``) attention runs replicated, where the rules may still cut the
  columns.  Whisper's cross K/V are computed on each shard, for its
  heads, from the encoder context that rides every boundary replicated.
* MLP: ``w_gate``/``w_up`` column-parallel over ``d_ff``, ``w_down``
  row-parallel.
* MoE (the rules): the router replicated, so every shard computes the
  same routing, capacities and drops from every expert's count; the
  expert stacks expert-parallel where ``tp`` divides their count (shard
  ``i`` runs only its experts' assignments), else tensor-parallel inside
  each expert (``d_ff`` split); the shared experts column/row-parallel.
  One all-reduce sums the routed and the shared partials.
* Mamba-1 (``ssm``): shard ``i`` owns channels ``[i Di/tp, (i+1)
  Di/tp)`` of ``d_inner``.  ``in_proj`` is ``[x | z]``: each shard holds
  its channels of **both** halves (the rules' even cut of the columns
  would give one shard all of ``x`` and another all of ``z``).
  ``conv_w``/``conv_b``/``dt_bias``/``A_log``/``D`` and the conv and SSM
  state go by channel, ``x_proj`` is row-parallel (its ``dt_rank + 2N``
  outputs all-reduced), ``dt_proj`` column-parallel and ``out_proj``
  row-parallel.
* Mamba-2 (``hybrid``): by heads.  ``in_proj`` is ``[z | x | B | C |
  dt]`` and ``conv_w``/``conv_b`` ``[x | B | C]``: each shard holds its
  heads' columns of ``z``, ``x`` and ``dt`` and, with one group, all of
  ``B`` and ``C`` (computed on every shard), so its conv state is its
  ``x`` channels beside the whole ``B``/``C`` ones (``sharding.Cat``).
  The gated RMSNorm's mean runs over all of ``d_inner``: each shard sums
  its squares in f32 and one ``(B, S, 1)`` all-reduce gives the mean.
  Where the heads do not divide ``tp``, the Mamba-2 (or Mamba-1) block
  runs replicated.
* every row-parallel product is followed by ``all_reduce``: the partials
  summed in shard order on the first shard's device and the sum copied
  back to each shard, so two runs on one mesh are bit-equal.
* the head is vocabulary-parallel (the tied embedding's rows, or the
  untied ``lm_head``'s columns), its logits concatenated in shard order
  on the first shard's device.  Norms (whisper's LayerNorm scale and
  bias) are replicated; so is the residual stream.  ``vision_proj``, an
  untied ``embed`` and whisper's encoder follow the rules and are never
  read on the mesh (the edge's unit 0 reads them).
* where a block does not divide, it runs replicated on every shard (the
  head: on the first; an MoE's replicated experts or shared experts: on
  the first, beside the others' partials); every block that runs
  replicated is named in one ``ShardingDegraded`` warning, as the
  reference degrades its argument shardings.

The numbers are the reference's: only their placement differs.
"""
from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import timing
from repro_torch.distributed.op_analysis import counted_collective
from repro_torch.distributed.sharding import (Cat, P, ShardingDegraded,
                                              blocks, gather_tree,
                                              map_with_path, param_rules,
                                              shard_tree)
from repro_torch.launch.mesh import CloudMesh
from repro_torch.models import layers as Lyr
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

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
    """Wait for every card of the mesh, each on its current stream (as
    ``device.synchronize``): one ``wait`` span, one ``syncs``."""
    with timing.span("wait"):
        timing.count("syncs")
        for d in set(mesh.devices):
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

Ranges = Optional[Tuple[Tuple[int, int], ...]]


@dataclass(frozen=True)
class TPLayout:
    """Each shard's slice of every sharded dimension; None where the block
    runs replicated or the family has none.  ``heads[i]`` = ``(q_lo,
    q_hi, kv_lo, kv_hi)``; ``mamba``: Mamba-1's channels of ``d_inner``,
    Mamba-2's heads; ``experts`` (expert-parallel) or ``expert_ff`` (inside
    each expert) the routed experts', ``shared_ff`` the shared experts'."""
    tp: int
    heads: Optional[Tuple[Tuple[int, int, int, int], ...]]
    ff: Ranges
    vocab: Ranges
    mamba: Ranges
    experts: Ranges
    expert_ff: Ranges
    shared_ff: Ranges
    degraded: Tuple[str, ...]


def _ranges(n: int, tp: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((i * n // tp, (i + 1) * n // tp) for i in range(tp))


def _split(n: int, tp: int) -> Ranges:
    return _ranges(n, tp) if n % tp == 0 else None


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
    degraded = []
    heads = ff = mamba = experts = expert_ff = shared_ff = None
    if cfg.family != "ssm":
        heads = _head_ranges(cfg.num_heads, cfg.num_kv_heads, tp)
        if heads is None:
            degraded.append(f"attention: num_heads={cfg.num_heads}, "
                            f"num_kv_heads={cfg.num_kv_heads} !% model={tp}")
    if cfg.family == "moe":
        m = cfg.moe
        experts = _split(m.num_experts, tp)
        if experts is None:
            expert_ff = _split(m.expert_d_ff, tp)
            if expert_ff is None:
                degraded.append(f"moe: num_experts={m.num_experts}, "
                                f"expert_d_ff={m.expert_d_ff} !% model={tp}")
        if m.num_shared_experts:
            shared_ff = _split(m.shared_d_ff, tp)
            if shared_ff is None:
                degraded.append(f"moe shared: shared_d_ff={m.shared_d_ff} "
                                f"!% model={tp}")
    elif cfg.family != "ssm":
        ff = _split(cfg.d_ff, tp)
        if ff is None:
            degraded.append(f"mlp: d_ff={cfg.d_ff} !% model={tp}")
    if cfg.ssm is not None:       # Mamba-1 by channel, Mamba-2 by head
        mamba1 = cfg.ssm.kind == "mamba1"
        n = cfg.d_inner if mamba1 else cfg.d_inner // cfg.ssm.head_dim
        mamba = _split(n, tp)
        if mamba is None:
            degraded.append(f"{cfg.ssm.kind}: "
                            f"{'d_inner' if mamba1 else 'heads'}={n} "
                            f"!% model={tp}")
    vocab = _split(cfg.vocab_size, tp)
    if vocab is None:
        degraded.append(f"head: vocab_size={cfg.vocab_size} !% model={tp}")
    return TPLayout(tp, heads, ff, vocab, mamba, experts, expert_ff,
                    shared_ff, tuple(degraded))


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


def _last(ndim: int, axis) -> P:
    """A spec cutting only the last of ``ndim`` dims on ``axis``."""
    return P(*([None] * (ndim - 1) + [axis]))


def _mamba_spec(cfg, lay: TPLayout, name: str, rule, ndim: int):
    """A Mamba leaf's spec: replicated where the block runs so; else
    ``in_proj`` (and Mamba-2's ``conv_w``/``conv_b``) cut column group by
    column group, every other leaf by the rules (which cut it by channel
    or head)."""
    if lay.mamba is None:
        return P()
    s, di = cfg.ssm, cfg.d_inner
    cut, whole = _last(ndim, "model"), P()
    leaf = _leaf(name)
    if s.kind == "mamba1":
        return Cat((di, cut), (di, cut)) if leaf == "in_proj" else rule
    if leaf == "in_proj":
        return Cat((di, cut), (di, cut), (2 * s.d_state, whole),
                   (di // s.head_dim, cut))
    if leaf in ("conv_w", "conv_b"):
        return Cat((di, cut), (2 * s.d_state, whole))
    return rule


def param_specs(cfg, params, mesh: CloudMesh):
    """The executor's layout: ``(TPLayout, specs)``, a spec per leaf of
    ``by_heads(cfg, params)`` over ``row_mesh(mesh)``.  They are the
    reference's rules (``sharding.param_rules``, no fsdp), except on the
    attention leaves, cut by whole heads or replicated (``tp_layout``):
    the rules cut ``wk``/``wv`` on ``head_dim`` where ``num_kv_heads <
    tp``, and shard the columns of heads that do not split; and on the
    Mamba leaves (``_mamba_spec``)."""
    row = row_mesh(mesh)
    lay = tp_layout(cfg, row.tp)
    rules, _ = param_rules(cfg, row, params, shard_fsdp=False)
    heads = "model" if lay.heads is not None else None
    ndims = {}
    map_with_path(lambda n, t: ndims.__setitem__(n, t.dim()), params)

    def spec(name, rule):
        if "mamba/" in name:
            return _mamba_spec(cfg, lay, name, rule, ndims[name])
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
    cfg: Any
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
    return TPParams(cfg, mesh, lay, shards, param_bytes(params))


# ---------------------------------------------------------------------------
# placed decode state
# ---------------------------------------------------------------------------

class ShardedTensor:
    """A decode state entry on the mesh, cut as the executor cuts the
    weights that write it (``state_spec``): each shard holds its block as
    a contiguous tensor on its device.  ``shape``, ``dtype``, ``numel``
    and ``element_size`` describe the whole entry."""
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

    def like(self, shards) -> "ShardedTensor":
        """New per-shard values of this entry, in its layout."""
        return ShardedTensor(shards, self.spec, self.row, self.shape,
                             shards[0].dtype, self.mesh_key)

    # -- rows: a slot pool's axis 0, which no ``state_spec`` cuts --------
    def _rows(self, j: int) -> List[torch.Tensor]:
        assert _axis0_whole(self.spec), \
            f"{self.spec} cuts axis 0: a row is not whole on each shard"
        return [t[j:j + 1] for t in self.shards]

    def read_row(self, j: int, device) -> torch.Tensor:
        """Row ``j`` whole on ``device`` (each shard's slice of the row
        gathered; the other rows are not read)."""
        like = torch.empty((1,) + tuple(self.shape[1:]), dtype=self.dtype,
                           device="meta")
        return gather_tree(self._rows(j), self.spec, self.row, device,
                           like=like)[0]

    def write_row(self, j: int, row: torch.Tensor) -> None:
        """Write the whole row ``row`` (``shape[1:]``) into row ``j`` of
        every shard, each shard's slice cut from it by the entry's spec:
        one copy a shard, the other rows untouched."""
        for dst, src in zip(self._rows(j), blocks(row[None], self.spec,
                                                  self.row)):
            dst.copy_(src)

    def zero_row(self, j: int) -> None:
        for dst in self._rows(j):
            dst.zero_()


def _axis0_whole(spec) -> bool:
    if isinstance(spec, Cat):
        return all(_axis0_whole(s) for _, s in spec.parts)
    return len(spec) == 0 or spec[0] is None


def state_spec(cfg, layout: TPLayout, key: str):
    """A state entry's spec: a KV entry (``k``/``v``/``ak``/``av``, (B,
    KH, S, hd)) by heads as ``wk``'s; a Mamba entry as its block's
    channels (``conv`` (B, K-1, C), Mamba-2's ``x`` channels beside the
    whole ``B``/``C`` ones; ``ssm`` (B, Di, N) or (B, H, P, N))."""
    if key[0] in ("k", "v", "a"):
        return P(None, "model" if layout.heads is not None else None)
    if layout.mamba is None:
        return P()
    if key.startswith("ssm"):
        return P(None, "model")
    s = cfg.ssm
    if s.kind == "mamba1":
        return P(None, None, "model")
    return Cat((cfg.d_inner, P(None, None, "model")), (2 * s.d_state, P()))


def place_entry(tpp: TPParams, key: str, t) -> ShardedTensor:
    """A whole state entry ``key`` (or one placed on another mesh) on
    ``tpp``'s mesh."""
    if isinstance(t, ShardedTensor):
        if t.mesh_key == tpp.mesh.key():
            return t
        t = t.gather(tpp.devices[0])
    spec, row = state_spec(tpp.cfg, tpp.layout, key), row_mesh(tpp.mesh)
    return ShardedTensor(shard_tree(t, spec, row), spec, row, t.shape,
                         t.dtype, tpp.mesh.key())


def whole(t, device) -> torch.Tensor:
    """``t`` as a whole tensor on ``device`` (gathered if sharded)."""
    return t.gather(device) if isinstance(t, ShardedTensor) else t


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@counted_collective("all-reduce")
def all_reduce(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Sum the shards' partials in shard order on the first shard's
    device and copy the sum back to each shard (counted in
    ``all_reduce.calls``; an ``op_analysis.OpCounter`` reads the call and
    the sum's bytes)."""
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


def _each(tpp: TPParams, fn) -> list:
    """``fn(s)`` for each shard ``s``, launched on its device."""
    out = []
    for s, d in enumerate(tpp.devices):
        with _on(d):
            out.append(fn(s))
    return out


# ---------------------------------------------------------------------------
# execution: blocks
# ---------------------------------------------------------------------------

def replicate(x: torch.Tensor, devices) -> List[torch.Tensor]:
    return [x.to(d) for d in devices]


def _mlp_block(cfg, tpp: TPParams, lps, xs):
    def part(s):
        h = T._apply_norm(cfg, lps[s]["ln2"], xs[s])
        return Lyr.mlp(lps[s]["mlp"], h, gated=cfg.gated_mlp)
    return _residual(xs, _each(tpp, part), tpp.devices,
                     tpp.layout.ff is not None)


def _moe_block(cfg, tpp: TPParams, lps, xs):
    """The MoE sublayer: every shard routes (the router replicated), runs
    its experts' assignments (or its slice of every expert) and its slice
    of the shared experts; a block that does not divide runs on the first
    shard beside the others' partials, or everywhere where none divides."""
    lay, m = tpp.layout, cfg.moe
    routed = lay.experts is not None or lay.expert_ff is not None
    shared = lay.shared_ff is not None
    sharded = routed or shared

    def part(s):
        mp = lps[s]["moe"]
        h = T._apply_norm(cfg, lps[s]["ln2"], xs[s])
        here = s == 0 or not sharded      # the replicated blocks run here
        y = torch.zeros_like(h)
        if routed or here:
            route = Lyr.moe_route(mp["router"], h, top_k=m.top_k,
                                  capacity_factor=m.capacity_factor)
            first = lay.experts[s][0] if lay.experts is not None else 0
            y = Lyr.moe_experts(mp, h, route, first=first)
        if "shared_w_gate" in mp and (shared or here):
            y = y + Lyr.moe_shared(mp, h)
        return y
    return _residual(xs, _each(tpp, part), tpp.devices, sharded)


def _ff_block(cfg, tpp, lps, xs):
    if "moe" in lps[0]:
        return _moe_block(cfg, tpp, lps, xs)
    return _mlp_block(cfg, tpp, lps, xs)


def _attn_full(cfg, tpp: TPParams, lps, xs, ropes, *, impl, causal=True):
    """The self-attention sublayer over a full sequence, residual added."""
    devs = tpp.devices
    parts = _each(tpp, lambda s: T.attn_out_full(
        cfg, lps[s], xs[s], ropes[devs[s]], impl=impl, causal=causal,
        window=cfg.sliding_window)[0])
    return _residual(xs, parts, devs, tpp.layout.heads is not None)


def _cross_full(cfg, tpp: TPParams, lps, xs, encs, *, impl):
    """Whisper's cross-attention sublayer: each shard's heads' K/V from
    its replica of the encoder context."""
    parts = _each(tpp, lambda s: T.cross_out_full(
        cfg, lps[s], xs[s], T._enc_cross_kv(cfg, lps[s], encs[s]),
        impl=impl))
    return _residual(xs, parts, tpp.devices, tpp.layout.heads is not None)


def _mamba_block(cfg, tpp: TPParams, lps, xs, caches, *, impl):
    """The Mamba block with its residual over each shard's channels (or
    heads): ``(xs, new caches)``, one cache dict a shard; ``caches`` None
    starts from zero state.  Mamba-1 all-reduces ``x_proj``'s outputs,
    Mamba-2 its gated norm's sum of squares, both ``out_proj``'s."""
    devs = tpp.devices
    hs = _each(tpp, lambda s: T._apply_norm(cfg, lps[s]["ln"], xs[s]))
    def cache(s):
        return None if caches is None else caches[s]
    if tpp.layout.mamba is None:
        outs = _each(tpp, lambda s: SSM.ssm_block(
            cfg, lps[s]["mamba"], hs[s], cache(s), impl=impl))
        return _residual(xs, [y for y, _ in outs], devs, False), \
            [c for _, c in outs]
    if cfg.ssm.kind == "mamba1":
        pre = _each(tpp, lambda s: SSM.mamba1_in(lps[s]["mamba"], hs[s],
                                                 cache(s)))
        dbcs = all_reduce(_each(tpp, lambda s: pre[s][0]
                                @ lps[s]["mamba"]["x_proj"]), devs)

        def out(s):
            xc, z, conv = pre[s]
            h0 = None if caches is None else caches[s]["ssm"]
            y, h = SSM.mamba1_out(lps[s]["mamba"], dbcs[s], xc, z, h0,
                                  cfg=cfg, impl=impl)
            return y, {"conv": conv, "ssm": h}
    else:
        pre = _each(tpp, lambda s: SSM.mamba2_gated(
            lps[s]["mamba"], hs[s], cache(s), cfg=cfg, impl=impl))
        sums = all_reduce(_each(tpp, lambda s: pre[s][0].float().square()
                                .sum(-1, keepdim=True)), devs)

        def out(s):
            y, c = pre[s]
            var = sums[s] / cfg.d_inner
            return SSM.mamba2_out(lps[s]["mamba"], y, var), c
    outs = _each(tpp, out)
    return _residual(xs, [y for y, _ in outs], devs, True), \
        [c for _, c in outs]


def _layer(tpp: TPParams, li: int):
    return [T.layer_params(p, li) for p in tpp.shards]


def _shared(tpp: TPParams):
    return [p["shared"] for p in tpp.shards]


def full_layer(cfg, tpp: TPParams, li: int, xs, ropes, *, impl: str,
               encs=None):
    """Decoder layer ``li`` over a full sequence (a hybrid layer with the
    shared block it applies; whisper's with its cross attention against
    ``encs``, the encoder context on each shard): the replicated hidden
    ``xs`` in, the replicated hidden out."""
    lps = _layer(tpp, li)
    if cfg.ssm is not None:
        xs, _ = _mamba_block(cfg, tpp, lps, xs, None, impl="kernel")
        if cfg.family == "hybrid" and cfg.hybrid_period \
                and (li + 1) % cfg.hybrid_period == 0:
            lps = _shared(tpp)
            xs = _attn_full(cfg, tpp, lps, xs, ropes, impl=impl)
            xs = _mlp_block(cfg, tpp, lps, xs)
        return xs
    xs = _attn_full(cfg, tpp, lps, xs, ropes, impl=impl)
    xs = _ff_block(cfg, tpp, lps, xs)
    if cfg.family == "audio":      # after the MLP, as the reference's
        xs = _cross_full(cfg, tpp, lps, xs, encs, impl=impl)
    return xs


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
    """``StageRunner``'s units ``[lo, hi)`` (``lo >= 1``: the embedding,
    and whisper's encoder, stay on the edge) over ``state["h"]`` (and
    whisper's ``state["enc"]``), on the mesh; the result lies on the
    first shard's device."""
    if lo < 1:
        raise ValueError("the embedding unit runs on the edge, not the mesh")
    devs = tpp.devices
    xs = replicate(state["h"], devs)
    encs = replicate(state["enc"], devs) if "enc" in state else None
    ropes = {d: T._rope_for(cfg, xs[0].shape[1], device=d)
             for d in set(devs)} if cfg.family != "ssm" else None
    for i in range(lo, hi):
        if i == num_units - 1:
            return {"logits": head(cfg, tpp, xs, last=False)}
        xs = full_layer(cfg, tpp, i - 1, xs, ropes, impl=impl, encs=encs)
    return dict(state, h=xs[0])


# ---------------------------------------------------------------------------
# execution: one decode step
# ---------------------------------------------------------------------------

def _decode_attention(cfg, tpp: TPParams, lps, xs, kc, vc, step, attend):
    """One token's self-attention sublayer against the placed caches
    ``kc``/``vc``: each shard writes its heads' K/V at the step's position
    in place and attends with ``attend(q, k_cache, v_cache, valid)``."""
    poss, ropes, valid = step
    hd = cfg.head_dim

    def part(s):
        d = tpp.devices[s]
        B = xs[s].shape[0]
        h = T._apply_norm(cfg, lps[s]["ln1"], xs[s])
        q, k, v = T._project_qkv(cfg, lps[s]["attn"], h)
        cos, sin = ropes[d]
        q, k = Lyr.apply_rope(q, cos, sin), Lyr.apply_rope(k, cos, sin)
        kcs, vcs = kc.shards[s], vc.shards[s]
        where = poss[d].reshape(-1, 1, 1, 1).long().expand(
            B, kcs.shape[1], 1, hd)
        kcs.scatter_(2, where, k.transpose(1, 2).to(kcs.dtype))
        vcs.scatter_(2, where, v.transpose(1, 2).to(vcs.dtype))
        att = attend(q, kcs, vcs, valid[d])
        return att.reshape(B, 1, -1) @ lps[s]["attn"]["wo"]
    return _residual(xs, _each(tpp, part), tpp.devices,
                     tpp.layout.heads is not None)


def _step_operands(cfg, devs, pos):
    """Per device: the position, its one-token rope tables, and the valid
    length ``pos + 1``."""
    hd = cfg.head_dim
    poss = {d: pos.to(d) for d in set(devs)}
    ropes = {}
    for d, p in poss.items():
        if p.dim() == 0:
            cos, sin = Lyr.rope_cos_sin(p.reshape(1), hd, cfg.rope_theta)
            ropes[d] = (cos[None], sin[None])
        else:
            ropes[d] = Lyr.rope_cos_sin(p[:, None], hd, cfg.rope_theta)
    return poss, ropes, {d: p + 1 for d, p in poss.items()}


def decode_units(cfg, tpp: TPParams, units: Sequence, x, cache, pos,
                 attend: Callable, *, ssm_impl: str = "kernel"):
    """One token through ``units`` on the mesh: ``(unit, state keys)``
    pairs, a unit ``("layer", i)`` or a hybrid's shared-block application
    ``("app", g)``.  ``cache`` maps the keys to entries (a whole entry is
    placed on the mesh first).  Attention units write their K/V at
    ``pos`` in place and attend with ``attend(q, k_cache, v_cache,
    valid)``; Mamba units return new conv and SSM state (scans on
    ``ssm_impl``).  Returns the replicated hidden, the entries written,
    and each unit's input (stacked, on the first shard's device)."""
    devs = tpp.devices
    xs = replicate(x, devs)
    step = _step_operands(cfg, devs, pos) if any(
        kind == "app" or cfg.family in T._ATTN_FAMILIES
        for (kind, _), _ in units) else None
    new: Dict[str, ShardedTensor] = {}
    bounds = []
    for (kind, idx), keys in units:
        bounds.append(xs[0])
        placed = [place_entry(tpp, k, cache[k]) for k in keys]
        lps = _shared(tpp) if kind == "app" else _layer(tpp, idx)
        if kind == "app" or cfg.family in T._ATTN_FAMILIES:
            kc, vc = placed
            new.update(zip(keys, placed))
            xs = _decode_attention(cfg, tpp, lps, xs, kc, vc, step, attend)
            xs = _ff_block(cfg, tpp, lps, xs)
            continue
        conv, ssm = placed
        caches = [{"conv": conv.shards[s], "ssm": ssm.shards[s]}
                  for s in range(len(devs))]
        xs, out = _mamba_block(cfg, tpp, lps, xs, caches, impl=ssm_impl)
        new[keys[0]] = conv.like([c["conv"] for c in out])
        new[keys[1]] = ssm.like([c["ssm"] for c in out])
    b = torch.stack(bounds) if bounds \
        else x.new_zeros((0,) + tuple(x.shape)).to(devs[0])
    return xs, new, b
