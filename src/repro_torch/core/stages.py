"""Stage-wise model execution: the "sequence of layers" abstraction.

The counterpart of ``repro/core/stages.py`` for every family.  A model
is a list of UNITS: unit 0 = embedding (+frontend/encoder), units 1..L =
decoder layers, unit L+1 = LM head.  A split after unit ``k`` puts units
[0, k] on the edge stage and (k, N) on the cloud stage; the boundary
tensor is the hidden state (plus, for whisper, the encoder context ``enc``
— the encoder itself is ONE unit, the paper's rule that parallel paths
are not split).

``abstractify``/``aval_fingerprint`` turn a nested structure of tensors
into ``TensorSpec``s (shape, dtype, device) and a hashable key over
structure, shapes and dtypes; both runners cache their built stages on it.

Building a stage.  JAX compiles an executable per ``(range, avals)``
(``_CompiledStageCache``).  PyTorch runs eagerly, so building a stage here
is making its callable and running one synchronised warm-up forward on
scratch state shaped like the inputs (``StageRunner.stage_executable``).
A warm build caches the callable per ``(lo, hi, fingerprint)`` and a hit
returns it; ``fresh=True`` builds anew, warms up, and caches nothing (the
paper's "new container").  An eager callable serves any input shape, so
the reference's retrace fallback for unseen shapes has no counterpart.

A sharded cloud stage (``stage_executable(..., mesh=)``) runs the unit
range on the tensor-parallel executor (``repro_torch.distributed.tp``)
over weights placed on the mesh (``StageRunner.place_on_mesh``); the
mesh's identity (axis names, shape, devices) enters the cache key, so a
sharded and a single-device callable for one range never collide.

``CnnStageRunner`` runs the paper's own CNNs (``models/cnn.py``) behind
the same interface: unit i is a conv, pool, block, flatten or dense
layer; ``{"image"}`` goes in, NHWC ``{"h"}`` crosses each boundary and
``{"logits"}`` comes out; the boundary bytes VARY with depth, so the
optimal split moves with the bandwidth.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, CNNConfig
from repro_torch.core import timing
from repro_torch.core.concurrency import (RANK_STAGE_CACHE, guarded_by,
                                          make_lock)
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import cnn as CNN
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.transformer import layer_params


@dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and device of a tensor: what a stage is built for."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)


def abstractify(tree):
    """Nested dicts/lists/tuples of tensors -> the same of ``TensorSpec``s
    (specs pass through)."""
    if isinstance(tree, dict):
        return {k: abstractify(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(abstractify(v) for v in tree)
    if isinstance(tree, TensorSpec):
        return tree
    return TensorSpec(tuple(tree.shape), tree.dtype, tree.device)


def materialize(tree):
    """Zero tensors shaped like the specs of ``tree`` (scratch state)."""
    if isinstance(tree, dict):
        return {k: materialize(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(materialize(v) for v in tree)
    return tree.zeros()


def aval_fingerprint(tree) -> Tuple:
    """Hashable identity of a structure's specs (keys, shapes, dtypes,
    devices) in a fixed order."""
    def walk(t, path, out):
        if isinstance(t, dict):
            for k in sorted(t, key=repr):
                walk(t[k], path + (k,), out)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,), out)
        else:
            out.append((path, t.shape, str(t.dtype), str(t.device)))
        return out
    return tuple(walk(abstractify(tree), (), []))


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def to_device(tree, device: torch.device):
    """Tensors (or array-likes) of a nested structure, on ``device``."""
    return tree_map(lambda t: torch.as_tensor(t, device=device), tree)


@guarded_by("_cache_lock", "_stage_cache", rank=RANK_STAGE_CACHE,
            init_methods=("_init_stage_cache",))
class _BuiltStageCache:
    """Built stages shared by both runners: a subclass gives ``device``
    and ``_run(params, state, lo, hi)``, and ``_run_on_mesh`` with the
    same signature where its stages run on a mesh (``StageRunner``)."""

    def _init_stage_cache(self) -> None:
        self._stage_cache: Dict[Tuple, Any] = {}
        self._cache_lock = make_lock("stage-cache", RANK_STAGE_CACHE)

    def run_units(self, state, lo: int, hi: int):
        return self._run(self.params, state, lo, hi)

    def stage_executable(self, lo: int, hi: int, params, state, *,
                         fresh: bool = False, mesh=None):
        """Built callable ``fn(params, state)`` for units [lo, hi), for a
        ``state`` shaped like ``state`` (tensors or ``TensorSpec``s; never
        read, only their shapes).  A miss (or ``fresh=True``) makes the
        callable and runs one synchronised warm-up forward on scratch state
        shaped like ``state``; only a warm (``fresh=False``) build is
        cached, per ``(lo, hi, mesh identity, fingerprint)``.

        With ``mesh`` (a ``launch.mesh.CloudMesh``) the callable runs the
        range on the tensor-parallel executor and ``params`` are weights
        placed on that mesh (``place_on_mesh``); the boundary goes in
        replicated, as ``stage_shardings`` has it.  The reference's
        ``shardings`` argument has no counterpart: the executor's layout
        (``distributed/tp.py``) places the weights."""
        specs = abstractify(state)
        mesh_key = None if mesh is None else mesh.key()
        key = (lo, hi, mesh_key) + aval_fingerprint(specs)
        if not fresh:
            with self._cache_lock:
                hit = self._stage_cache.get(key)
            if hit is not None:
                return hit
        if mesh is None:
            def fn(params, state):
                return self._run(params, state, lo, hi)
        else:
            def fn(params, state):
                return self._run_on_mesh(params, state, lo, hi)
        with timing.span("stage_build", units=(lo, hi)):
            timing.count("stage_builds")
            fn(params, materialize(specs))       # warm-up on scratch state
            synchronize(self.device)
            if mesh is not None:
                from repro_torch.distributed.tp import synchronize_mesh
                synchronize_mesh(mesh)
        if not fresh:
            with self._cache_lock:
                fn = self._stage_cache.setdefault(key, fn)
        return fn


class StageRunner(_BuiltStageCache):
    """Executes unit ranges [lo, hi) of a model for full-sequence
    inference.

    ``params`` are placed on ``device``, which defaults to the card and
    raises without one unless the caller asks for ``"cpu"``.
    ``attn_impl`` is the attention of every attention layer and of the
    hybrid family's shared block (``layers.attention``): ``"kernel"`` (or
    the reference's ``"pallas"``) runs the hand-written flash-attention
    kernel.  Every mamba layer's scan runs the scan kernels
    (``models.ssm``); the reference's stateless path runs its jnp scan.
    Whisper's encoder runs in unit 0 on ``frames`` (their dtype is the
    encoder's: give them in the model's); internvl2's ``vision_embeds``
    are projected and prepended there."""

    def __init__(self, cfg: ArchConfig, params, attn_impl: str = "chunked",
                 *, device="cuda"):
        T._check_family(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.attn_impl = attn_impl
        self._init_stage_cache()

    # -- unit layout --------------------------------------------------
    @property
    def num_units(self) -> int:
        return self.cfg.num_layers + 2

    def edge_param_bytes(self, split: int) -> int:
        """Approximate parameter bytes the edge holds at ``split`` (layers
        ``[0, split)`` plus the embedding): the layer-proportional share
        of the full model."""
        frac = (split + 1) / (self.cfg.num_layers + 2)
        return int(param_bytes(self.params) * frac)

    # -- execution ----------------------------------------------------
    def _apply_unit(self, params, state: Dict[str, Any],
                    i: int) -> Dict[str, Any]:
        cfg = self.cfg
        if i == 0:
            x = T.embed_inputs(cfg, params, state)
            if cfg.family == "audio":
                x = x + T.text_positions(cfg, x.shape[1], x.device).to(
                    x.dtype)
                enc = T.encode_audio(cfg, params, state["frames"],
                                     attn_impl=self.attn_impl, remat=False)
                return {"h": x, "enc": enc}
            return {"h": x}
        if i == self.num_units - 1:
            x = T._apply_norm(cfg, params["final_norm"], state["h"])
            return {"logits": (x @ T.lm_head_weights(cfg, params)).float()}
        li = i - 1                                   # decoder layer i - 1
        x = state["h"]
        lp = layer_params(params, li)
        if cfg.family in ("dense", "moe", "vlm", "audio"):
            rope_cs = T._rope_for(cfg, x.shape[1], device=x.device)
            x, _, _ = T.attn_block_full(cfg, lp, x, rope_cs,
                                        impl=self.attn_impl,
                                        window=cfg.sliding_window)
            if cfg.family == "audio":
                ckv = T._enc_cross_kv(cfg, lp, state["enc"])
                x = T.cross_block_full(cfg, lp, x, ckv, impl=self.attn_impl)
        else:
            y, _ = SSM.ssm_block(cfg, lp["mamba"],
                                 T._apply_norm(cfg, lp["ln"], x))
            x = x + y
            if cfg.family == "hybrid" and cfg.hybrid_period \
                    and (li + 1) % cfg.hybrid_period == 0:
                # the shared attention block folds into every
                # hybrid_period-th layer's unit
                rope_cs = T._rope_for(cfg, x.shape[1], device=x.device)
                x, _, _ = T.attn_block_full(cfg, params["shared"], x,
                                            rope_cs, impl=self.attn_impl,
                                            window=cfg.sliding_window)
        out = dict(state)
        out["h"] = x
        return out

    def _run(self, params, state, lo: int, hi: int):
        for i in range(lo, hi):
            state = self._apply_unit(params, state, i)
        return state

    # -- sharded (tensor-parallel) cloud stage ---------------------------
    def stage_shardings(self, mesh, state):
        """``(param_shardings, state_shardings)`` for a stage over
        ``mesh``: parameters follow ``distributed.sharding.param_shardings``
        (heads / d_ff / experts / vocab -> the "model" axis) and the
        boundary activation is REPLICATED: the edge ships one hidden state
        and every tensor-parallel shard consumes it whole."""
        from repro_torch.distributed.sharding import P, param_shardings
        psh = param_shardings(self.cfg, mesh, abstractify(self.params),
                              shard_fsdp=False)
        return psh, tree_map(lambda _: P(), abstractify(state))

    def place_on_mesh(self, params, mesh):
        """``params`` copied onto ``mesh`` in the executor's layout
        (``distributed.tp.place_params``)."""
        from repro_torch.distributed import tp as TP
        return TP.place_params(self.cfg, params, mesh)

    def _run_on_mesh(self, params, state, lo: int, hi: int):
        from repro_torch.distributed import tp as TP
        return TP.run_units(self.cfg, params, state, lo, hi,
                            impl=self.attn_impl, num_units=self.num_units)

    # -- built stages ----------------------------------------------------
    def stage_out_avals(self, lo: int, hi: int, params, state):
        """Specs of the output of units [lo, hi) for inputs shaped like
        ``state``, worked out from the unit layout (nothing runs; the
        reference traces with ``eval_shape``): the hidden has the vision
        frontend's rows before the text's, and whisper's ``enc`` ``(B,
        T_enc, d_model)`` in the frames' dtype rides every boundary."""
        cfg = self.cfg
        spec = abstractify(state)
        if lo == 0:
            B, S = spec["tokens"].shape
            if cfg.frontend == "vision":
                S += spec["vision_embeds"].shape[1]
            emb = params["embed"]
            out = {"h": TensorSpec((B, S, cfg.d_model), emb.dtype,
                                   emb.device)}
            if cfg.family == "audio":
                f = spec["frames"]
                out["enc"] = TensorSpec(f.shape[:2] + (cfg.d_model,),
                                        f.dtype, f.device)
        else:
            out = dict(spec)
        if hi == self.num_units:
            h = out["h"]
            return {"logits": TensorSpec(h.shape[:2] + (cfg.vocab_size,),
                                         torch.float32, h.device)}
        return out

    def boundary_bytes(self, split: int, batch: int, seq: int,
                       act_bytes: int = 4) -> int:
        """Bytes crossing the link for a split after unit ``split``: the
        hidden at ``seq`` rows, and whisper's encoder context.  Like the
        reference's, it counts no vision-frontend rows (the pipeline
        passes the text length as ``seq``; ROADMAP.md, Queue C)."""
        cfg = self.cfg
        n = batch * seq * cfg.d_model * act_bytes
        if cfg.family == "audio":
            n += batch * cfg.encoder.context_len * cfg.d_model * act_bytes
        return n


class CnnStageRunner(_BuiltStageCache):
    """StageRunner-compatible executor for the paper's own CNN models
    (the video-analytics workload, Figs. 2-3): unit i = conv, pool, block,
    flatten or dense layer; the boundary activations VARY with depth, so
    the optimal split really moves with the bandwidth.

    ``params`` (the reference's structure and layout, e.g.
    ``params.from_numpy`` of ``repro.models.cnn.build_cnn``'s) or, without
    them, weights drawn from ``generator`` (``models.cnn.build_cnn``) are
    placed on ``device`` once, conv weights in the layout ``F.conv2d``
    takes (``models.cnn.place_params``).  ``device`` defaults to the card
    and raises without one unless the caller asks for ``"cpu"``.  Like
    the reference's runner it has no ``edge_param_bytes``."""

    def __init__(self, cfg: CNNConfig, params=None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params, self.units, self.shapes = CNN.build_cnn(
                cfg, generator, device=self.device)
        else:
            self.units, self.shapes, _ = CNN.cnn_units(cfg)
        self.params = CNN.place_params(params, self.device)
        self._init_stage_cache()

    @property
    def num_units(self) -> int:
        return len(self.units)

    def _run(self, params, state, lo: int, hi: int):
        x = state["h"] if "h" in state else state["image"]
        x = CNN.run_range(params, self.units, x, lo, hi)
        return {"logits": x} if hi == self.num_units else {"h": x}

    def stage_out_avals(self, lo: int, hi: int, params, state):
        """Specs of the output of units [lo, hi) for inputs shaped like
        ``state``: ``shapes[hi - 1]`` at the input's batch (nothing runs;
        the reference traces with ``eval_shape``)."""
        spec = abstractify(state)
        x = spec["h"] if "h" in spec else spec["image"]
        out = TensorSpec(x.shape[:1] + tuple(self.shapes[hi - 1][1:]),
                         x.dtype, x.device)
        return {"logits": out} if hi == self.num_units else {"h": out}

    def boundary_bytes(self, split: int, batch: int, seq: int = 1,
                       act_bytes: int = 4) -> int:
        """Bytes crossing the link for a split after unit ``split``."""
        return CNN.boundary_bytes(self.shapes, split, batch, act_bytes)
