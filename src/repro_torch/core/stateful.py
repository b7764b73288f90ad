"""Stateful dynamic switching: live KV/SSM state hand-off at repartition.

The PyTorch counterpart of ``repro/core/stateful.py`` for the dense, moe,
vlm, ssm and hybrid families (``vlm`` as a dense model: the stateful path
embeds text tokens only, as the reference's does; ``audio`` is refused
with the reference's ``ValueError``).  A decode pipeline is stateful:
every layer carries per-stream decode state (a KV cache for attention layers, conv +
SSM state for mamba layers, a KV cache for each application of the hybrid
family's shared attention block), and when the split moves from ``a`` to
``b`` the state of layers ``[min(a,b), max(a,b))`` changes sides.
``core/state_handoff.plan_handoff`` prices the two ways of moving it; this
module executes the plan:

* ``transfer``  — the moved layers' state is really serialized (``bytes``),
  the link time for those bytes is priced with the current
  ``NetworkModel``, and the payload is deserialized back on the target;
* ``recompute`` — the moved layers are re-prefilled on the target from
  the per-layer boundary activations the session checkpoints as it
  decodes, and the measured wall of that re-prefill blocks the stream.

Split ``s`` = layers ``[0, s)`` on the edge; the embedding rides with the
edge stage, the LM head with the cloud stage.

Where the port differs from the reference, and why:

* **Building a stage.**  JAX compiles an executable per ``(mode, range,
  avals)``.  PyTorch runs eagerly, so building a stage here is making its
  callable and running one synchronised warm-up forward on scratch state
  (``StatefulStageRunner.executable``).  A warm build caches the callable
  per ``(mode, u0, u1, fingerprint)`` and a hit returns it; ``fresh=True``
  builds anew, warms up, and caches nothing (the paper's "new container");
  ``owns_weights`` pipelines also copy the weights on the device.  Switch
  downtimes are made of these walls.
* **In-place state.**  A decode step writes its token's K/V into the
  layer's cache at the decode position in place (a mamba layer's conv and
  SSM state come back as new tensors, which the commit copies into the
  session's entries), and the session writes each step's token and
  boundary activations into device buffers preallocated at ``max_seq``:
  the reference concatenates its history on the host every step, which
  at full width would copy hundreds of MB per token.  Every writer of the
  state (a step's commit, an import, a recompute) writes into the
  entries where they lie (``write_state``), so an entry keeps its address
  for the session's life; only ``restore`` and a mesh's ``reshard``
  rebind.  Snapshots therefore copy.
* **CUDA graphs.**  On one CUDA device (no mesh), each of a pipeline's
  two decode stages (the embedding and layers ``[0, split)``; layers
  ``[split, L)`` and the head) is captured as a CUDA graph at its first
  step on the serving thread and replayed every step after
  (``core.graphs``): a step is then two replays instead of thousands of
  launches.  The captured stage writes conv and SSM state into the
  session's entries inside the graph; a guard recaptures when an entry
  has moved, and a stage whose capture raises runs eagerly.  The CPU
  route and a mesh's stages run the eager callables.
* **The position stays on the device.**  ``step_pos`` is an int32 device
  tensor; the decode path and the flash-decode kernel read it there and
  never wait on the host.  The host keeps its own integer ``pos`` for
  bookkeeping (context full, export slicing).
* **Timing.**  Stage walls synchronise the card where JAX blocks until
  ready; otherwise they would time the launches only.
* **Scans.**  Every mamba layer's scan runs the hand-written kernels
  (``models.ssm``, ``impl="kernel"``) in the prefill, the decode steps and
  the masked recompute; the reference's prefill and recompute run its jnp
  scan.  ``decode_impl="reference"`` puts the decode steps' scans on the
  plain versions, as the reference's puts them on jnp.
* **No rolled path.**  The reference's ``rolled`` ranges (``_segments``,
  ``lax.scan`` over a span) shrink a compile that eager PyTorch does not
  have; every range here is one Python loop over its units.
* **Payloads** keep the reference's ``(dtype str, shape, buffer)`` entries
  and ``(epoch, pos, crc32)`` envelope, so the two packages' hand-offs
  interchange; bf16 travels as its raw 16-bit pattern tagged
  ``"bfloat16"``, which is also what the reference's bytes are.  On the
  card a payload's tensors cross to and from the host through
  page-locked memory: an export's buffer is that memory itself, read-only
  (``HostBuffer``), and an import copies it to the card in one DMA
  (``_from_payload``); nothing is copied into fresh pageable pages.
* **A sharded cloud stage** (``mesh_shape``; every family served here)
  runs on the tensor-parallel executor (``repro_torch.distributed.tp``),
  its weights copied onto the mesh at build.  The session then holds the
  cloud range's state entries per shard (``tp.ShardedTensor``: KV by
  heads, conv and SSM state by channel or head); a transfer export
  gathers them to whole tensors first, so the payload is the
  reference's.  Hand-offs run on the
  session's device (the recompute in its ``RecomputeArena``) and write
  whole tensors, which the next step places on the mesh; a mesh-changing
  activation moves the live cloud-range state itself (``reshard``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
import zlib
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.concurrency import (RANK_SESSION, RANK_STATEFUL_RUNNER,
                                          guarded_by, make_lock)
from repro_torch.core.graphs import StageGraph, addresses
from repro_torch.core.hardware import CLOUD_SPEC, EDGE_SPEC
from repro_torch.core.heap import freeze_startup_heap
from repro_torch.core.network import NetworkModel
from repro_torch.core.pipeline import BuildReport, RequestTiming
from repro_torch.core.pool import PipelinePool
from repro_torch.core.stages import (TensorSpec, abstractify,
                                     aval_fingerprint, layer_params,
                                     materialize, param_bytes, tree_map)
from repro_torch.core.state_handoff import HandoffPlan, plan_handoff
from repro_torch.core import timing
from repro_torch.core.timing import Stopwatch
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed import tp as TP
from repro_torch.kernels import flash_decode as FD
from repro_torch.models import layers as Lyr
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

if TYPE_CHECKING:
    from repro_torch.serving.sessions import SessionManager

_ATTN_FAMILIES = ("dense", "moe", "vlm")
_SUPPORTED = _ATTN_FAMILIES + ("ssm", "hybrid")
_DECODE_IMPLS = ("auto", "kernel", "reference")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _SUPPORTED:
        raise ValueError(f"stateful serving unsupported for {cfg.family!r}")


# ---------------------------------------------------------------------------
# hand-off integrity envelope
# ---------------------------------------------------------------------------

# Envelope entry every export_layers payload carries: (epoch, pos, crc).
HANDOFF_META_KEY = "__meta__"


class HandoffCorrupted(RuntimeError):
    """An imported hand-off payload failed checksum/epoch validation."""


class HandoffIntegrityWarning(UserWarning):
    """A corrupt hand-off payload was detected and recovered from by
    falling back to masked recompute — the stream served no bad state."""


def payload_checksum(payload: Dict[Any, tuple]) -> int:
    """CRC32 chained over every tensor entry (meta excluded), in sorted
    key order so the digest is independent of dict insertion order."""
    crc = 0
    for k in sorted((k for k in payload if k != HANDOFF_META_KEY), key=repr):
        dtype, shape, buf = payload[k]
        crc = zlib.crc32(repr((k, dtype, tuple(shape))).encode(), crc)
        crc = zlib.crc32(buf, crc)
    return crc


def _host_array(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """A host tensor as (dtype str, numpy view of its memory); bf16 as its
    16-bit pattern."""
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return str(a.dtype), a


class HostBuffer:
    """A host tensor's bytes, read-only through the buffer protocol.

    The buffer of an exported hand-off entry: ``zlib.crc32``,
    ``np.frombuffer``, ``bytes()``, ``len()`` and slicing read it as they
    read ``bytes``, so the reference's ``validate_payload`` and
    ``import_layers`` take it, but nothing copies it into fresh pageable
    pages.  It keeps ``tensor`` (page-locked memory from PyTorch's caching
    host allocator, for a CUDA source) alive until the payload is
    dropped, and ``_from_payload`` copies that tensor to the card
    straight."""

    __slots__ = ("tensor", "dtype", "_view")

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self.dtype, arr = _host_array(tensor)
        flat = arr.reshape(-1).view(np.uint8)
        flat.flags.writeable = False
        self._view = memoryview(flat)

    def __buffer__(self, flags: int) -> memoryview:
        return self._view

    def __len__(self) -> int:
        return self._view.nbytes

    def __getitem__(self, i):
        return self._view[i]


def _payload_entry(t: torch.Tensor, capacity: Optional[int] = None
                   ) -> Tuple[str, Tuple[int, ...], HostBuffer]:
    """A tensor as an export's ``(dtype str, shape, buffer)`` entry, in
    host memory of its own: page-locked for a CUDA tensor (one DMA), a
    copy for a CPU one (the payload must not alias live state).

    ``capacity`` (elements): the page-locked block is requested at this
    size whatever ``t``'s, and ``t`` lands in its first elements.  An
    export passes each KV entry's size at ``max_seq``, so every export of
    the entry asks the caching host allocator for one block size (it
    rounds to powers of two), whatever the live context: the block that
    ``warm_host_blocks`` left in its cache serves it."""
    t = t.detach()
    if t.device.type == "cuda":
        n = t.numel()
        block = torch.empty(max(n, capacity or 0), dtype=t.dtype,
                            pin_memory=True)
        host = block[:n].view(t.shape)
        host.copy_(t)
    else:
        host = t.clone(memory_format=torch.contiguous_format)
    buf = HostBuffer(host)
    return buf.dtype, tuple(host.shape), buf


def warm_host_blocks(entries) -> int:
    """Take from the caching host allocator, all at once, the page-locked
    blocks that an export of the CUDA tensors ``entries`` takes
    (``_payload_entry`` at each one's whole size, its capacity), then give
    them back to its cache.  The first export of a process would
    otherwise ``cudaHostAlloc`` its blocks inside a switch's downtime
    (PERF.md; ROADMAP.md, Queue C); after this it finds them cached.
    Returns the bytes requested."""
    blocks = [torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
              for t in entries if t.device.type == "cuda"]
    return sum(b.numel() * b.element_size() for b in blocks)


def _from_payload(dtype: str, shape, buf, device=None) -> torch.Tensor:
    """An entry's buffer as a tensor on ``device`` (the CPU by default);
    raises ``ValueError``/``TypeError`` on a short buffer or a bad dtype.
    An export's ``HostBuffer`` that still matches its entry is copied to
    ``device`` straight (one DMA from page-locked memory to the card);
    other bytes are copied once into page-locked host memory and DMA'd
    from there."""
    cuda = device is not None and torch.device(device).type == "cuda"
    if isinstance(buf, HostBuffer) and buf.dtype == dtype \
            and tuple(buf.tensor.shape) == tuple(shape):
        if cuda:
            return buf.tensor.to(device, non_blocking=True)
        return buf.tensor.clone()
    bf16 = dtype == "bfloat16"
    a = np.frombuffer(buf, dtype=np.uint16 if bf16 else dtype).reshape(shape)
    if cuda:
        host = torch.empty(a.shape, pin_memory=True,
                           dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)
        host.numpy()[...] = a
        t = host.to(device, non_blocking=True)
    else:
        t = torch.from_numpy(a.copy())
    return t.view(torch.bfloat16) if bf16 else t


# ---------------------------------------------------------------------------
# unit layout
# ---------------------------------------------------------------------------

def unit_list(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """Execution-ordered state units: ``("layer", i)`` per decoder layer,
    plus ``("app", g)`` after every ``hybrid_period``-th hybrid layer."""
    _check_family(cfg)
    units: List[Tuple[str, int]] = []
    for i in range(cfg.num_layers):
        units.append(("layer", i))
        if cfg.family == "hybrid" and cfg.hybrid_period \
                and (i + 1) % cfg.hybrid_period == 0:
            units.append(("app", (i + 1) // cfg.hybrid_period - 1))
    return units


def unit_index_of_split(cfg: ArchConfig, split: int) -> int:
    """Units on the edge for a split of ``split`` LAYERS: layers
    ``[0, split)`` plus any shared-attn application firing inside them."""
    split = min(max(split, 0), cfg.num_layers)
    idx = split
    if cfg.family == "hybrid" and cfg.hybrid_period:
        idx += split // cfg.hybrid_period
    return idx


def _unit_state_keys(cfg: ArchConfig, unit: Tuple[str, int]) -> Tuple[str, ...]:
    kind, idx = unit
    if kind == "app":
        return (f"ak{idx}", f"av{idx}")
    if cfg.family in _ATTN_FAMILIES:
        return (f"k{idx}", f"v{idx}")
    return (f"conv{idx}", f"ssm{idx}")


def _is_kv(key: str) -> bool:
    """A KV entry (``k``/``v``/``ak``/``av``): stored at ``max_seq`` along
    dim 2 and handed off sliced to the live context; ``conv``/``ssm``
    entries are recurrent state, handed off whole."""
    return key[0] in ("k", "v", "a")


def _is_attn_unit(cfg: ArchConfig, unit: Tuple[str, int]) -> bool:
    return unit[0] == "app" or cfg.family in _ATTN_FAMILIES


def _fit_kv(a, cap: int):
    """(B, S, KH, hd) seq-major prefill K/V -> heads-major (B, KH, cap, hd),
    contiguous (the flash-decode kernel reads it as one block)."""
    S = a.shape[1]
    if S > cap:
        a = a[:, S - cap:]
    elif S < cap:
        a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, cap - S))
    return a.transpose(1, 2).contiguous()


def _state_specs(state: Dict[str, Any], device) -> Dict[str, TensorSpec]:
    """Whole-entry specs of state entries on ``device`` (an entry placed
    on a mesh is described by its whole shape)."""
    return {k: TensorSpec(tuple(v.shape), v.dtype, device)
            for k, v in state.items()}


def _as_tokens(tokens, device) -> torch.Tensor:
    """Token ids (tensor, numpy or nested lists) as int64 on ``device``."""
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device, torch.long)
    return torch.from_numpy(np.array(tokens, dtype=np.int64)).to(device)


# ---------------------------------------------------------------------------
# stage runner: built unit-range callables
# ---------------------------------------------------------------------------

@guarded_by("_lock", "_stage_cache", "_full_cache", rank=RANK_STATEFUL_RUNNER)
class StatefulStageRunner:
    """Builds decode/full-sequence callables over contiguous unit ranges.

    Mirrors the reference's caching contract: warm builds share one cache
    per ``(mode, range, fingerprint)``; ``fresh=True`` rebuilds and leaves
    no trace ("new container").  See the module docstring for what a
    build is in eager PyTorch.

    ``device`` defaults to the card and raises without one unless the
    caller asks for ``"cpu"``; ``params`` are placed on it.
    ``attn_impl`` is the full-sequence attention of the prefill and the
    recompute arm (``layers.attention``: ``"chunked"``, or ``"kernel"`` for
    the hand-written flash-attention kernel).  ``decode_impl`` selects
    the decode hot path: ``"kernel"`` routes decode attention through the
    hand-written flash-decode kernel and the mamba layers' one-step scans
    through the scan kernels (whose wrappers run the plain versions on a
    CPU tensor), ``"reference"`` through ``layers.decode_attention`` and
    the scans' plain versions; ``"auto"`` resolves ONCE at construction
    to kernel on CUDA and reference elsewhere.  The prefill's and the
    recompute arm's scans always take the kernel route (``models.ssm``).
    ``rolled`` is accepted for
    the reference's signature and changes nothing: the reference's
    ``lax.scan`` over stacked weights shrinks a compile that eager
    PyTorch does not have, so both settings run one Python loop over the
    layers."""

    def __init__(self, cfg: ArchConfig, params, *, max_seq: int = 128,
                 attn_impl: str = "chunked", decode_impl: str = "auto",
                 rolled: bool = True, device="cuda"):
        _check_family(cfg)
        if decode_impl not in _DECODE_IMPLS:
            raise ValueError(f"decode_impl must be one of {_DECODE_IMPLS}, "
                             f"got {decode_impl!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_seq = int(max_seq)
        self.attn_impl = attn_impl
        self.decode_impl = decode_impl
        if decode_impl == "auto":
            decode_impl = ("kernel" if self.device.type == "cuda"
                           else "reference")
        self.resolved_decode_impl = decode_impl
        self.rolled = bool(rolled)
        self.units = unit_list(cfg)
        self._stage_cache: Dict[Tuple, Any] = {}
        self._full_cache: Dict[Tuple, Any] = {}
        self._lock = make_lock("stateful-runner", RANK_STATEFUL_RUNNER)

    @property
    def _ssm_impl(self) -> str:
        """The decode steps' scan route (``models.ssm`` impl)."""
        return "kernel" if self.resolved_decode_impl == "kernel" else "plain"

    def _has_attention(self, units) -> bool:
        return any(_is_attn_unit(self.cfg, u) for u in units)

    def _attend(self, q, kc, vc, valid):
        """One-token attention vs the heads-major cache, routed per
        ``decode_impl``.  Both paths take/return (B, 1, H, hd) and accept
        a scalar or per-row ``(B,)`` count of valid entries (the cache
        already holds this token: ``pos + 1``).  Every live row is
        attended, with no window, as the reference's stateful decode does
        (its ``_attend``): the cache holds ``max_seq`` rows, and a native
        window (mixtral's 4096) would show only past ``max_seq > window``.
        The full-sequence passes apply the config's window."""
        if self.resolved_decode_impl == "kernel":
            return FD.flash_decode_attention(q, kc, vc, pos=valid)
        return Lyr.decode_attention(q, kc, vc, pos=valid)

    def _step_operands(self, pos, B: int):
        """What every attention unit of a decode step needs from ``pos``,
        computed once a step: the valid length ``pos + 1`` and the cache
        write's index (``_cache_write``), ``pos`` broadcast to the
        one-token update's (B, KH, 1, hd) for a scalar or ``(B,)`` pos."""
        cfg = self.cfg
        where = pos.reshape(-1, 1, 1, 1).long().expand(
            B, cfg.num_kv_heads, 1, cfg.head_dim)
        return pos + 1, where

    def _decode_rope(self, pos):
        """One-token rope tables with an explicit batch axis: (1, 1, hd/2)
        for a shared scalar position, (B, 1, hd/2) per row."""
        cfg = self.cfg
        if pos.dim() == 0:
            cos, sin = Lyr.rope_cos_sin(pos.reshape(1), cfg.head_dim,
                                        cfg.rope_theta)
            return cos[None], sin[None]
        return Lyr.rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta)

    @staticmethod
    def _cache_write(cache, val, where):
        """Write a one-token heads-major (B, KH, 1, hd) update at the
        decode position IN PLACE (see the module docstring): one scatter
        along the sequence, ``where`` the position of every value."""
        return cache.scatter_(2, where, val)

    @property
    def num_units(self) -> int:
        """Split domain for the pool/partitioner: one unit per LAYER."""
        return self.cfg.num_layers

    def edge_param_bytes(self, split: int) -> int:
        """Layer-proportional edge parameter bytes at ``split``."""
        frac = (split + 1) / (self.cfg.num_layers + 2)
        return int(param_bytes(self.params) * frac)

    # -- one decoder unit, one token ------------------------------------
    def _decode_unit(self, params, unit, x, cache, new, operands, rope,
                     in_place=False):
        cfg = self.cfg
        kind, idx = unit
        if not _is_attn_unit(cfg, unit):
            ck, sk = _unit_state_keys(cfg, unit)
            lp = layer_params(params, idx)
            h = T._apply_norm(cfg, lp["ln"], x)
            y, nc = SSM.ssm_block(cfg, lp["mamba"], h,
                                  {"conv": cache[ck], "ssm": cache[sk]},
                                  impl=self._ssm_impl)
            if in_place:        # the layer's new state into its entries
                cache[ck].copy_(nc["conv"])
                cache[sk].copy_(nc["ssm"])
                nc = {"conv": cache[ck], "ssm": cache[sk]}
            new[ck], new[sk] = nc["conv"], nc["ssm"]
            return x + y
        kk, vk = _unit_state_keys(cfg, unit)
        p = params["shared"] if kind == "app" else layer_params(params, idx)
        B = x.shape[0]
        h = T._apply_norm(cfg, p["ln1"], x)
        q, k, v = T._project_qkv(cfg, p["attn"], h)
        cos, sin = rope
        q = Lyr.apply_rope(q, cos, sin)
        k = Lyr.apply_rope(k, cos, sin)
        valid, where = operands
        kc = self._cache_write(
            cache[kk], k.transpose(1, 2).to(cache[kk].dtype), where)
        vc = self._cache_write(
            cache[vk], v.transpose(1, 2).to(cache[vk].dtype), where)
        new[kk], new[vk] = kc, vc
        att = self._attend(q, kc, vc, valid)
        x = x + att.reshape(B, 1, -1) @ p["attn"]["wo"]
        ff, _ = T.feed_forward(cfg, p, T._apply_norm(cfg, p["ln2"], x))
        return x + ff

    def _make_decode_fn(self, u0: int, u1: int, in_place: bool = False):
        """The decode callable over units [u0, u1): ``(x, new, bounds)``.
        ``in_place``: each mamba layer copies its new conv and SSM state
        into the cache's entries as it ends (the form a CUDA graph
        captures: the temporaries of one layer serve the next)."""
        units = self.units[u0:u1]
        attends = self._has_attention(units)

        def fn(params, x, cache, pos):
            new: Dict[str, Any] = {}
            bounds = []
            rope = self._decode_rope(pos) if attends else None
            operands = self._step_operands(pos, x.shape[0]) if attends \
                else None
            for unit in units:
                bounds.append(x)
                x = self._decode_unit(params, unit, x, cache, new, operands,
                                      rope, in_place)
            b = torch.stack(bounds) if bounds \
                else x.new_zeros((0,) + tuple(x.shape))
            return x, new, b
        return fn

    # -- one decoder unit, full sequence --------------------------------
    def _full_unit(self, params, unit, x, caches, rope_cs):
        cfg = self.cfg
        kind, idx = unit
        if not _is_attn_unit(cfg, unit):
            ck, sk = _unit_state_keys(cfg, unit)
            lp = layer_params(params, idx)
            h = T._apply_norm(cfg, lp["ln"], x)
            y, nc = SSM.ssm_block(cfg, lp["mamba"], h)
            caches[ck], caches[sk] = nc["conv"], nc["ssm"]
            return x + y
        kk, vk = _unit_state_keys(cfg, unit)
        p = params["shared"] if kind == "app" else layer_params(params, idx)
        x, (k, v), _ = T.attn_block_full(cfg, p, x, rope_cs,
                                         impl=self.attn_impl,
                                         window=cfg.sliding_window)
        caches[kk] = _fit_kv(k, self.max_seq)
        caches[vk] = _fit_kv(v, self.max_seq)
        return x

    def _make_full_fn(self, u0: int, u1: int):
        units = self.units[u0:u1]
        cfg = self.cfg
        attends = self._has_attention(units)

        def fn(params, x):
            rope_cs = T._rope_for(cfg, x.shape[1], device=x.device) \
                if attends else None
            caches: Dict[str, Any] = {}
            bounds = []
            for unit in units:
                bounds.append(x)
                x = self._full_unit(params, unit, x, caches, rope_cs)
            b = torch.stack(bounds) if bounds \
                else x.new_zeros((0,) + tuple(x.shape))
            return x, caches, b
        return fn

    # -- masked re-prefill (the recompute hand-off arm) ------------------
    # The context is zero-padded to ``max_seq`` (one shape per unit range,
    # whatever the context length) and correctness beyond the live length
    # is enforced the way bucketed prefills do it: causal attention already
    # ignores the pad for valid rows, pad rows are masked out of the
    # cache, and the recurrent state freezes at the live length because a
    # masked dt makes every padded step an identity update
    # (decay = exp(0 * A) = 1, update = 0).

    def _masked_mamba(self, lp, x, mask, length):
        """One mamba layer over the padded context: (x + out, state) with
        the SSM state of the live prefix and the conv state of the K-1 raw
        inputs trailing the live length (zeros where the context is
        shorter).  ``mask``: (B, CL) bool; ``length``: 0-d or (B,)."""
        cfg = self.cfg
        s = cfg.ssm
        di = cfg.d_inner
        B, S_len = x.shape[:2]
        h = T._apply_norm(cfg, lp["ln"], x)
        p = lp["mamba"]
        live = mask[:, :, None]
        if s.kind == "mamba1":
            xin, z = (h @ p["in_proj"]).chunk(2, dim=-1)
            xc, _ = SSM.causal_conv1d(xin, p["conv_w"], p["conv_b"])
            xc = torch.nn.functional.silu(xc)
            dt, Bc, Cc = torch.split(xc @ p["x_proj"],
                                     [s.dt_rank, s.d_state, s.d_state],
                                     dim=-1)
            dt = torch.nn.functional.softplus(
                dt.float() @ p["dt_proj"].float() + p["dt_bias"]) * live
            A = -torch.exp(p["A_log"])
            y, hs = SSM.mamba1_scan(dt.to(xc.dtype), Bc, Cc, xc, A)
            y = y.float() + xc.float() * p["D"]
            y = (y * torch.nn.functional.silu(z.float())).to(x.dtype)
            conv_src = xin
        else:
            H = di // s.head_dim
            N = s.d_state
            z, xbc, dt = torch.split(h @ p["in_proj"], [di, di + 2 * N, H],
                                     dim=-1)
            xbc_c, _ = SSM.causal_conv1d(xbc, p["conv_w"], p["conv_b"])
            xbc_c = torch.nn.functional.silu(xbc_c)
            xin, Bc, Cc = torch.split(xbc_c, [di, N, N], dim=-1)
            xh = xin.reshape(B, S_len, H, s.head_dim)
            dt = torch.nn.functional.softplus(dt.float() + p["dt_bias"]) \
                * live
            A = -torch.exp(p["A_log"])
            y, hs = SSM.mamba2_scan(dt, Bc, Cc, xh, A)
            y = y + xh.float() * p["D"][:, None]
            y = y.reshape(B, S_len, di).to(x.dtype)
            y = y * torch.nn.functional.silu(z)
            var = y.float().square().mean(-1, keepdim=True)
            y = (y * torch.rsqrt(var + 1e-5).to(y.dtype)) * p["norm"]
            conv_src = xbc
        out = y @ p["out_proj"]
        # conv state = the K-1 raw inputs trailing the LIVE length, not the
        # pad: rows [length, length + K - 1) of [zeros(K-1), conv_src]
        K = p["conv_w"].shape[0]
        cat = torch.cat([conv_src.new_zeros((B, K - 1, conv_src.shape[-1])),
                         conv_src], dim=1)
        length = length.reshape(-1).expand(B).long()
        rows = length[:, None] + torch.arange(K - 1, device=x.device)
        conv_state = cat[torch.arange(B, device=x.device)[:, None], rows]
        return x + out, {"conv": conv_state, "ssm": hs}

    def _masked_units(self, params, units, x, length, bounds=None):
        """The masked unit loop over a zero-padded ``(B, max_seq, D)``
        context: ``(x, caches, length)``, K/V caches masked beyond each
        row's live prefix.  ``length``: the live prefix, a scalar shared by
        the batch or per-row ``(B,)``.  Given a list, ``bounds`` collects
        each unit's input, masked the same way."""
        cfg = self.cfg
        B, CL = x.shape[:2]
        # nk: allow[NK03]: a hand-off's host length, once a recompute
        length = torch.as_tensor(length, device=x.device)
        ar = torch.arange(CL, device=x.device)
        if length.dim() == 0:
            mask = (ar < length)[None, :].expand(B, CL)
        else:
            mask = ar[None, :] < length[:, None]
        m = mask[:, :, None, None]
        rope_cs = T._rope_for(cfg, CL, device=x.device) \
            if self._has_attention(units) else None
        caches: Dict[str, Any] = {}
        for unit in units:
            if bounds is not None:
                bounds.append(x * mask[:, :, None])
            kind, idx = unit
            if not _is_attn_unit(cfg, unit):
                ck, sk = _unit_state_keys(cfg, unit)
                x, st = self._masked_mamba(layer_params(params, idx), x,
                                           mask, length)
                caches[ck], caches[sk] = st["conv"], st["ssm"]
                continue
            kk, vk = _unit_state_keys(cfg, unit)
            p = params["shared"] if kind == "app" \
                else layer_params(params, idx)
            x, (k, v), _ = T.attn_block_full(
                cfg, p, x, rope_cs, impl=self.attn_impl,
                window=cfg.sliding_window)
            caches[kk] = (k * m).transpose(1, 2).contiguous()
            caches[vk] = (v * m).transpose(1, 2).contiguous()
        return x, caches, length

    def _make_recompute_fn(self, u0: int, u1: int):
        units = self.units[u0:u1]

        def fn(params, x, length):
            # x: (B, max_seq, D) zero-padded context
            return self._masked_units(params, units, x, length)[1]
        return fn

    def recompute_fn(self, u0: int, u1: int):
        """Cached masked re-prefill fn for units [u0, u1), reused at every
        context length."""
        with self._lock:
            key = ("recompute", u0, u1)
            if key not in self._full_cache:
                self._full_cache[key] = self._make_recompute_fn(u0, u1)
            return self._full_cache[key]

    # -- masked admission (slot pools) -----------------------------------
    # Admitting a session into a live slot pool is a masked prefill at the
    # pool's fixed (B, max_seq) bucket: the same zero-pad + masked-dt
    # trick as the recompute arm, extended to also return the per-unit
    # boundary activations and the logits at each row's last live token.
    # One callable per runner, reused for every mid-flight join.

    def _make_admit_fn(self):
        cfg = self.cfg

        def fn(params, tokens, length):
            # tokens: (B, max_seq) zero-padded.  Boundary checkpoints are
            # stored masked so slot buffers keep the zero-beyond-live-
            # prefix invariant the sliced KV export/import path relies on
            B = tokens.shape[0]
            bounds = []
            x, caches, length = self._masked_units(
                params, self.units, params["embed"][tokens], length, bounds)
            # each row's last live token; rows with length 0 (dead slots)
            # clamp to position 0 and produce garbage logits the caller
            # masks out
            last = (length.reshape(-1).expand(B).long() - 1).clamp(min=0)
            h = x[torch.arange(B, device=x.device), last][:, None]
            h = T._apply_norm(cfg, params["final_norm"], h)
            logits = (h[:, -1] @ T.lm_head_weights(cfg, params)).float()
            b = torch.stack(bounds) if bounds \
                else x.new_zeros((0, B, x.shape[1], x.shape[-1]))
            return logits, caches, b
        return fn

    def admit_fn(self):
        """Cached masked-admission fn ``(params, tokens, length) ->
        (last_logits, caches, bounds)`` over the full unit range."""
        with self._lock:
            if ("admit",) not in self._full_cache:
                self._full_cache[("admit",)] = self._make_admit_fn()
            return self._full_cache[("admit",)]

    def _make_embed_fn(self):
        def fn(params, tokens):
            return params["embed"][tokens]
        return fn

    def _make_head_fn(self):
        cfg = self.cfg

        def fn(params, x):
            x = T._apply_norm(cfg, params["final_norm"], x)
            return (x[:, -1] @ T.lm_head_weights(cfg, params)).float()
        return fn

    # -- on a mesh (the tensor-parallel executor) --------------------------
    def _make_tp_decode_fn(self, u0: int, u1: int):
        units = [(u, _unit_state_keys(self.cfg, u))
                 for u in self.units[u0:u1]]

        def fn(tpp, x, cache, pos):
            return TP.decode_units(self.cfg, tpp, units, x, cache, pos,
                                   self._attend, ssm_impl=self._ssm_impl)
        return fn

    def _make_tp_head_fn(self):
        def fn(tpp, xs):
            if isinstance(xs, torch.Tensor):
                xs = TP.replicate(xs, tpp.devices)
            return TP.head(self.cfg, tpp, xs, last=True)
        return fn

    # -- built stages ------------------------------------------------------
    def executable(self, mode: str, u0: int, u1: int, params, *args,
                   fresh: bool = False, mesh=None):
        """Built stage callable for a unit range, for args shaped like
        ``args`` (tensors or ``TensorSpec``s; never read, only their
        shapes).

        ``mode``: ``decode`` (params, x, cache, pos), ``embed`` (params,
        tokens), ``head`` (params, x).  A miss (or
        ``fresh=True``) makes the callable and runs one synchronised
        warm-up forward on scratch state shaped like ``args``; only a warm
        (``fresh=False``) build is cached, per ``(mode, range, mesh
        identity, fingerprint)``.  With ``mesh`` the decode and head
        callables run on the tensor-parallel executor over weights placed
        on it (``tp.place_params``): the decode stage takes the boundary
        hidden and position replicated and each state entry per shard (a
        whole entry is placed first), and returns the replicated hidden
        the head takes.  The reference's ``shardings`` argument has no
        counterpart: the executor's layout places weights and state."""
        if mesh is None:
            makers = {"decode": lambda: self._make_decode_fn(u0, u1),
                      "embed": self._make_embed_fn,
                      "head": self._make_head_fn}
        else:
            makers = {"decode": lambda: self._make_tp_decode_fn(u0, u1),
                      "head": self._make_tp_head_fn}
        specs = abstractify(args)
        key = (mode, u0, u1, None if mesh is None else mesh.key()) \
            + aval_fingerprint(specs)
        if not fresh:
            with self._lock:
                hit = self._stage_cache.get(key)
            if hit is not None:
                return hit
        with timing.span("stage_build", mode=mode, units=(u0, u1)):
            timing.count("stage_builds")
            fn = makers[mode]()
            fn(params, *materialize(specs))       # warm-up on scratch state
            synchronize(self.device)
            if mesh is not None:
                TP.synchronize_mesh(mesh)
        if not fresh:
            with self._lock:
                fn = self._stage_cache.setdefault(key, fn)
        return fn

    def full_fn(self, u0: int, u1: int):
        """Full-sequence fn — the prefill path, any context length."""
        with self._lock:
            if (u0, u1) not in self._full_cache:
                self._full_cache[(u0, u1)] = self._make_full_fn(u0, u1)
            return self._full_cache[(u0, u1)]


# ---------------------------------------------------------------------------
# decode session: the stream's state
# ---------------------------------------------------------------------------

def _fits(old, shape, v) -> bool:
    """Whether ``v`` can be copied into the entry ``old`` of ``shape``."""
    return type(old) is torch.Tensor and type(v) is torch.Tensor \
        and tuple(old.shape) == tuple(shape) and old.dtype == v.dtype \
        and old.device == v.device


def write_state(cache: Dict[str, Any], entries: Dict[str, Any]) -> None:
    """Write ``entries`` into the state ``cache`` where its entries lie: a
    tensor of an entry's shape, dtype and device is copied into it (a
    captured decode stage reads and writes the entry at that address);
    anything else (a new entry, a ``tp.ShardedTensor`` on either side, a
    payload of another dtype) is bound in its place."""
    for k, v in entries.items():
        old = cache.get(k)
        if old is v:
            continue
        if _fits(old, v.shape, v):
            old.copy_(v)
        else:
            cache[k] = v


def write_imported(cache: Dict[str, Any],
                   decoded: Dict[str, torch.Tensor]) -> None:
    """Write a decoded hand-off payload into the state ``cache``: a KV
    entry as its first ``t.shape[2]`` rows ``t`` and zeros after them,
    recurrent state whole; in place where ``write_state`` would copy."""
    for k, t in decoded.items():
        if not _is_kv(k):
            write_state(cache, {k: t})
            continue
        old, n = cache[k], t.shape[2]
        if _fits(old, tuple(t.shape[:2]) + tuple(old.shape[2:]), t):
            old[:, :, :n].copy_(t)
            old[:, :, n:].zero_()
            continue
        full = torch.zeros(old.shape, dtype=t.dtype, device=t.device)
        full[:, :, :n] = t
        cache[k] = full


class RecomputeArena:
    """A private pool of PyTorch's caching allocator for the next
    recompute hand-off.  The standby's warm-up runs the hand-off's
    re-prefill in it once (``warm``) and records the layers it ran; the
    hand-off over the same layers (``use``) then draws the warm-up's
    blocks again, which no decode step or build in between can take or
    split.  In the shared cache they could: a hand-off there met a fresh
    ``cudaMalloc`` on the card (PERF.md).  Any other
    hand-off, and every one on the CPU, runs in the shared cache."""

    def __init__(self, device: torch.device):
        self.pool = self.index = None
        self.warmed: Optional[Tuple[int, int]] = None
        if device.type == "cuda":
            self.index = device.index if device.index is not None \
                else torch.cuda.current_device()
            self.pool = torch.cuda.MemPool()

    def _pool(self):
        if self.pool is None:
            return contextlib.nullcontext()
        return torch.cuda.use_mem_pool(self.pool, self.index)

    def warm(self, units: Tuple[int, int], run) -> None:
        """Call ``run()`` (the re-prefill of ``units``, its result
        dropped) in the pool, and keep the pool for the next hand-off over
        ``units``."""
        with self._pool():
            run()
        self.warmed = units

    def use(self, units: Tuple[int, int]):
        """The context a hand-off over ``units`` runs in: the pool once
        after a warm-up of the same units, else the shared cache."""
        if units != self.warmed:
            return contextlib.nullcontext()
        self.warmed = None
        return self._pool()


class DecodeSession:
    """Per-stream decode state shared by every pipeline in the pool.

    ``epoch`` is the state version: bumped on prefill and on every
    committed decode step.  A pool entry stamped with an older epoch was
    built against a stale view of the context and must be re-synced at
    activation, never trusted.  Token history and per-unit boundary
    activations live in device buffers preallocated at ``max_seq`` and
    written in place at ``pos`` (``tokens`` is a view of the live
    prefix)."""

    def __init__(self, runner: StatefulStageRunner):
        self.runner = runner
        self.cfg = runner.cfg
        self.device = runner.device
        self.cache: Dict[str, Any] = {}
        self._tokens: Optional[torch.Tensor] = None   # (B, max_seq)
        self._bounds: Optional[torch.Tensor] = None   # (U, B, max_seq, D)
        self.last_logits = None
        self.pos = 0
        self._pos_dev: Optional[torch.Tensor] = None  # int32 0-d on device
        self.epoch = 0
        self.calib_spec = CLOUD_SPEC       # refined by prefill()
        # serialization-path calibration (refined by prefill()): fixed
        # per-payload overhead and sustained throughput of the
        # export->import round trip, folded into hand-off pricing
        self._ser_overhead_s: Optional[float] = None
        self._ser_bps: Optional[float] = None
        self._lock = make_lock("session", RANK_SESSION)
        self.arena = RecomputeArena(self.device)

    @property
    def batch(self) -> int:
        return 1 if self._tokens is None else self._tokens.shape[0]

    @property
    def tokens(self) -> Optional[torch.Tensor]:
        """(B, pos) context so far (a view of the device buffer)."""
        with self._lock:
            return None if self._tokens is None \
                else self._tokens[:, :self.pos]

    # -- lifecycle -------------------------------------------------------
    def prefill(self, tokens) -> None:
        """Run the whole stack over the prompt, building every unit's
        state + boundary checkpoints, and calibrate the recompute-arm
        throughput from the measured wall."""
        r = self.runner
        tokens = _as_tokens(tokens, self.device)
        U = len(r.units)
        B, T_len = tokens.shape
        if T_len > r.max_seq:
            raise ValueError(f"prompt {T_len} > max_seq {r.max_seq}")
        x = r.params["embed"][tokens]
        x, caches, bounds = r.full_fn(0, U)(r.params, x)
        logits = (T._apply_norm(self.cfg, r.params["final_norm"], x)[:, -1]
                  @ T.lm_head_weights(self.cfg, r.params)).float()
        synchronize(self.device)
        # calibration wall from a second, warm run: the first paid one-off
        # start-up costs.  Deliberately raw wall (never stream time): this
        # prices THIS HOST's recompute throughput.
        t0 = time.perf_counter()    # nk: allow[NK02]: host calibration
        r.full_fn(0, U)(r.params, x)
        synchronize(self.device)
        wall = time.perf_counter() - t0     # nk: allow[NK02]
        D = x.shape[-1]
        with self._lock:
            self.cache = dict(caches)
            self._tokens = torch.zeros((B, r.max_seq), dtype=torch.long,
                                       device=self.device)
            self._tokens[:, :T_len] = tokens
            self._bounds = bounds.new_zeros((U, B, r.max_seq, D))
            self._bounds[:, :, :T_len] = bounds
            self.last_logits = logits
            self.pos = int(T_len)
            self._pos_dev = torch.tensor(self.pos, dtype=torch.int32,
                                         device=self.device)
            self.epoch += 1
        self._calibrate(wall)
        self._calibrate_serialization()

    def _calibrate(self, wall: float) -> None:
        """Recompute-arm pricing spec from this host's measured prefill
        throughput (flops actually achieved, mfu folded in)."""
        from repro_torch.core.profiler import _layer_flops
        toks = self.batch * self.pos
        flops = sum(_layer_flops(self.cfg, k, tokens=toks, seq=self.pos)
                    for k in self.cfg.layer_kinds())
        if wall > 0 and flops > 0:
            self.calib_spec = dataclasses.replace(
                CLOUD_SPEC, name="host-calibrated", flops=flops / wall,
                mfu=1.0)

    def _calibrate_serialization(self) -> None:
        """Measure the export->import round trip at two payload sizes and
        split it into fixed overhead + throughput (hand-off pricing)."""
        L = self.cfg.num_layers
        half = max(1, L // 2)

        def round_trip(hi):
            payload, n = self.export_layers(0, hi)
            self.import_layers(payload)
            synchronize(self.device)
            return n
        round_trip(L)                       # warm dispatch paths

        def timed(hi):
            # deliberately raw wall: calibrates THIS HOST's serialization
            # throughput for hand-off pricing, never charged to the stream
            best, n = float("inf"), 0
            for _ in range(3):              # min-of-3: robust to GC spikes
                t0 = time.perf_counter()    # nk: allow[NK02]: calibration
                n = round_trip(hi)
                best = min(best, time.perf_counter() - t0)  # nk: allow[NK02]
            return best, n
        t_full, n_full = timed(L)
        t_half, n_half = timed(half)
        if n_full > n_half and t_full > t_half:
            bps = (n_full - n_half) / (t_full - t_half)
            self._ser_bps = bps
            self._ser_overhead_s = max(0.0, t_full - n_full / bps)
        else:                               # degenerate (1-layer stacks)
            self._ser_bps = None
            self._ser_overhead_s = t_full

    def handoff_net(self, net: NetworkModel) -> NetworkModel:
        """Effective link model for hand-off pricing: the measured
        serialization overhead adds to the latency and its throughput
        composes harmonically with the wire bandwidth."""
        if self._ser_overhead_s is None:
            return net
        lat = net.latency_ms + self._ser_overhead_s * 1e3
        bw = net.bandwidth_mbps
        if self._ser_bps:
            ser_mbps = self._ser_bps * 8 / 1e6
            bw = 1.0 / (1.0 / bw + 1.0 / ser_mbps)
        return NetworkModel(bw, latency_ms=lat)

    def next_token(self):
        """Greedy next token from the last logits, (B, 1) on the device."""
        assert self.last_logits is not None, "session not prefilled"
        return self.last_logits.argmax(-1)[:, None]

    def step_pos(self):
        """Decode-position operand for the next step: an int32 0-d tensor
        on the device, shared by the batch (a copy: the session advances
        its own in place)."""
        with self._lock:
            if self._pos_dev is None:
                return torch.tensor(self.pos, dtype=torch.int32,
                                    device=self.device)
            return self._pos_dev.clone()

    def commit_step(self, token, new_state: Dict[str, Any], bounds,
                    logits) -> None:
        """Land one decode step: state updates written into the entries
        (``write_state``), token and boundary checkpoints written at
        ``pos``, epoch bump.  ``logits`` is kept as it is: pass a tensor
        the caller will not overwrite."""
        with self._lock:
            p = self.pos
            write_state(self.cache, new_state)
            self._tokens[:, p] = _as_tokens(token, self.device).reshape(-1)
            self._bounds[:, :, p] = bounds[:, :, 0]
            self.last_logits = logits
            self.pos += 1
            self._pos_dev.add_(1)
            self.epoch += 1

    def subset(self, u0: int, u1: int) -> Dict[str, Any]:
        """The state entries a stage over units [u0, u1) reads/writes."""
        with self._lock:
            out = {}
            for unit in self.runner.units[u0:u1]:
                for k in _unit_state_keys(self.cfg, unit):
                    out[k] = self.cache[k]
            return out

    # -- hand-off primitives ---------------------------------------------
    def export_layers(self, lo: int, hi: int
                      ) -> Tuple[Dict[str, tuple], int]:
        """Really serialize the state of layers [lo, hi): KV sliced to the
        live context, recurrent state whole.  Returns (payload, nbytes);
        the payload carries the ``(epoch, pos, crc32)`` envelope
        ``import_layers`` validates."""
        u0 = unit_index_of_split(self.cfg, lo)
        u1 = unit_index_of_split(self.cfg, hi)
        payload: Dict[str, tuple] = {}
        nbytes = 0
        with self._lock:
            for unit in self.runner.units[u0:u1]:
                for k in _unit_state_keys(self.cfg, unit):
                    t = TP.whole(self.cache[k], self.device)
                    cap = t.numel()
                    if _is_kv(k):                # KV: valid region only
                        t = t[:, :, :self.pos]
                    dtype, shape, buf = _payload_entry(t, cap)
                    payload[k] = (dtype, shape, buf)
                    nbytes += len(buf)
            payload[HANDOFF_META_KEY] = (self.epoch, self.pos,
                                         payload_checksum(payload))
        return payload, nbytes

    def warm_export(self, lo: int, hi: int) -> int:
        """Leave in the caching host allocator the page-locked blocks an
        export of layers [lo, hi) takes (``warm_host_blocks``); the state
        is not touched.  Returns the bytes; 0 off the card."""
        u0 = unit_index_of_split(self.cfg, lo)
        u1 = unit_index_of_split(self.cfg, hi)
        with self._lock:
            entries = [self.cache[k] for unit in self.runner.units[u0:u1]
                       for k in _unit_state_keys(self.cfg, unit)
                       if k in self.cache]
        return warm_host_blocks(entries)

    def validate_payload(self, payload: Dict[str, tuple]) -> None:
        """Raise ``HandoffCorrupted`` unless the payload's envelope
        matches its bytes and the session's current epoch.  A payload
        without an envelope passes."""
        meta = payload.get(HANDOFF_META_KEY)
        if meta is None:
            return
        epoch, _pos, crc = meta
        with self._lock:
            live_epoch = self.epoch
        if epoch != live_epoch:
            raise HandoffCorrupted(f"hand-off epoch {epoch} != session "
                                   f"epoch {live_epoch}: stale payload")
        actual = payload_checksum(payload)
        if crc != actual:
            raise HandoffCorrupted(f"hand-off checksum mismatch: envelope "
                                   f"{crc:#010x} != bytes {actual:#010x}")

    def import_layers(self, payload: Dict[str, tuple]) -> None:
        """Deserialize an ``export_layers`` payload back into the state,
        written into the entries where they lie: each sliced KV entry as
        its live rows and zeros after them, recurrent state as it is.
        Validates and decodes every entry BEFORE committing anything, so
        on corruption the session state is untouched."""
        self.validate_payload(payload)
        decoded: Dict[str, torch.Tensor] = {}
        try:
            for k, (dtype, shape, buf) in payload.items():
                if k == HANDOFF_META_KEY:
                    continue
                decoded[k] = _from_payload(dtype, shape, buf, self.device)
        except (ValueError, TypeError) as e:   # short buffer / bad dtype
            raise HandoffCorrupted(f"undecodable hand-off entry "
                                   f"{k!r}: {e}") from None
        with self._lock:
            write_imported(self.cache, decoded)

    def recompute_layers(self, lo: int, hi: int) -> None:
        """Re-prefill layers [lo, hi) over the full live context from the
        boundary checkpoint entering layer ``lo`` (measured by the
        caller), padded to ``max_seq``, into the entries where they lie."""
        u0 = unit_index_of_split(self.cfg, lo)
        u1 = unit_index_of_split(self.cfg, hi)
        if u0 >= u1:
            return
        r = self.runner
        with self.arena.use((u0, u1)), \
                timing.span("handoff.recompute") as sp:
            with self._lock:
                T_len = self.pos
                x_pad = self._bounds[u0].clone()       # (B, max_seq, D)
            sp.set(rows=self.batch * r.max_seq, live_rows=self.batch * T_len)
            x_pad[:, T_len:] = 0
            caches = r.recompute_fn(u0, u1)(r.params, x_pad, T_len)
            with self._lock:
                write_state(self.cache, caches)
            synchronize(self.device)

    def replace_state(self, entries: Dict[str, Any]) -> None:
        """Swap state buffers wholesale: the mesh-reshard path, where the
        values are the same and only their placement moved."""
        with self._lock:
            self.cache.update(entries)

    def warm_recompute(self, a: int, b: int) -> None:
        """Run the re-prefill of the layers between splits ``a`` and ``b``
        once on zeros at the live length, in the session's
        ``RecomputeArena``, and drop its result: the state is not touched.
        The hand-off over the same layers (``recompute_layers``) draws its
        working set from there."""
        u0 = unit_index_of_split(self.cfg, min(a, b))
        u1 = unit_index_of_split(self.cfg, max(a, b))
        if u0 >= u1 or self.pos == 0:
            return
        r = self.runner
        fn = r.recompute_fn(u0, u1)

        def run():
            with self._lock:
                T_len = self.pos
                x = torch.zeros_like(self._bounds[u0])
            fn(r.params, x, T_len)
            synchronize(self.device)
        self.arena.warm((u0, u1), run)

    # -- test/benchmark support ------------------------------------------
    def snapshot(self) -> dict:
        """A copy of the whole state (copies: decode writes in place)."""
        with self._lock:
            return {"cache": {k: v.clone() for k, v in self.cache.items()},
                    "tokens": self._tokens.clone(),
                    "bounds": self._bounds.clone(),
                    "logits": self.last_logits, "pos": self.pos,
                    "epoch": self.epoch}

    def restore(self, snap: dict) -> None:
        with self._lock:
            self.cache = {k: v.clone() for k, v in snap["cache"].items()}
            self._tokens = snap["tokens"].clone()
            self._bounds = snap["bounds"].clone()
            self.last_logits = snap["logits"]
            self.pos, self.epoch = snap["pos"], snap["epoch"]
            self._pos_dev = torch.tensor(self.pos, dtype=torch.int32,
                                         device=self.device)


# ---------------------------------------------------------------------------
# pipeline: one split
# ---------------------------------------------------------------------------

class StatefulEdgeCloudPipeline:
    """Two built decode stages over a shared ``DecodeSession``, or a
    slot-pool ``SessionManager`` (``repro_torch.serving.sessions``), whose
    ``(num_slots,)`` position vector makes each step decode the whole
    ragged batch.

    ``process`` runs ONE decode step: the edge stage covers the embedding
    plus layers [0, split) (measured wall, scaled by ``edge_scale``), the
    one-token hidden state crossing the link is priced with the current
    ``NetworkModel``, and the cloud stage covers layers [split, L) plus
    the LM head (measured wall).  The session advances once per served
    request.

    ``mesh_shape`` puts the cloud stage on a tensor-parallel mesh, behind
    a ``DecodeSession``'s stream or a slot pool: the weights are copied
    onto it at build (``BuildReport.t_reshard``), the cloud range's decode
    state lives per shard, and each step replicates the boundary hidden
    onto the mesh and brings the logits back to the edge's device.  A
    slot pool's state is placed by its first step on the mesh (``reshard``
    moves none of it, as the reference's moves none) and its rows are
    written per shard (``tp.ShardedTensor.write_row``).  The edge stage
    stays on one device.

    On one CUDA device (no mesh) each stage is a ``core.graphs.StageGraph``,
    captured at the stage's first step on the thread that serves and
    replayed after: the captures of a pipeline never fall inside a
    repartition (a standby's first step comes after its activation), nor
    on the build thread beside the serving thread's waits on the card.
    ``warm`` runs the eager callables on scratch state and binds no
    graph.  Every stage run is counted: ``graph_replays``,
    ``graph_captures`` (each in a ``step.capture`` span) and, for a stage
    run eagerly on the card, ``graph_eager``."""

    def __init__(self, runner: StatefulStageRunner, split: int,
                 net: NetworkModel, *,
                 session: Union[DecodeSession, "SessionManager"],
                 edge_scale: float = CLOUD_SPEC.flops / EDGE_SPEC.flops,
                 owns_weights: bool = False,
                 mesh_shape: Optional[tuple] = None):
        self.mesh_shape = tuple(int(d) for d in mesh_shape) \
            if mesh_shape else None
        self.runner = runner
        self.session = session
        self.split = min(max(int(split), 0), runner.num_units)
        self.net = net
        self.edge_scale = edge_scale
        self.owns_weights = owns_weights
        self.params = runner.params
        # the cloud stage's weights: ``params``, or their copy on the mesh
        self.cloud_params = runner.params
        self.mesh = None
        self._u_edge = unit_index_of_split(runner.cfg, self.split)
        self._u_all = len(runner.units)
        self.embed_fn = None
        self.edge_fn = None
        self.cloud_fn = None
        self.head_fn = None
        # the stages' CUDA graphs (edge, cloud); None off the card or on a
        # mesh, where every step runs the eager callables
        self.graphs: Optional[Tuple[StageGraph, StageGraph]] = None

    # -- build -----------------------------------------------------------
    def build(self, sample_inputs=None, *, cold: bool,
              reload_from: Optional[str] = None) -> BuildReport:
        rep = BuildReport()
        r = self.runner
        dev = r.device
        if reload_from is not None:
            from repro_torch.checkpoint import load_pytree
            sw = Stopwatch()
            self.params = load_pytree(reload_from, like=r.params)
            synchronize(dev)
            rep.t_weights = sw.elapsed()
        elif self.owns_weights:
            sw = Stopwatch()
            self.params = tree_map(torch.clone, r.params)
            synchronize(dev)
            rep.t_weights = sw.elapsed()
            timing.count("weight_bytes", param_bytes(self.params))
        else:
            self.params = r.params
        s = self.session
        B, D = s.batch, r.cfg.d_model
        x_spec = TensorSpec((B, 1, D), r.params["embed"].dtype, dev)
        tok_spec = TensorSpec((B, 1), torch.long, dev)
        pos_spec = abstractify(s.step_pos())
        sw_wall = Stopwatch()
        sw = Stopwatch()
        self.embed_fn = r.executable("embed", 0, 0, self.params, tok_spec,
                                     fresh=cold)
        self.edge_fn = r.executable(
            "decode", 0, self._u_edge, self.params, x_spec,
            _state_specs(s.subset(0, self._u_edge), dev), pos_spec,
            fresh=cold)
        rep.t_compile_edge = sw.restart()
        cloud_specs = _state_specs(s.subset(self._u_edge, self._u_all), dev)
        if self.mesh_shape is None:
            self.cloud_params = self.params
            self.cloud_fn = r.executable(
                "decode", self._u_edge, self._u_all, self.params, x_spec,
                cloud_specs, pos_spec, fresh=cold)
            self.head_fn = r.executable("head", 0, 0, self.params, x_spec,
                                        fresh=cold)
        else:
            from repro_torch.launch.mesh import make_cloud_mesh
            mesh = self.mesh = make_cloud_mesh(self.mesh_shape)
            # the weight copy on the mesh, placed at build time so that a
            # prebuilt standby's reshard on the stream moves state only
            swr = Stopwatch()
            self.cloud_params = TP.place_params(r.cfg, self.params, mesh)
            TP.synchronize_mesh(mesh)
            rep.t_reshard = swr.elapsed()
            self.cloud_fn = r.executable(
                "decode", self._u_edge, self._u_all, self.cloud_params,
                x_spec, cloud_specs, pos_spec, fresh=cold, mesh=mesh)
            self.head_fn = r.executable("head", 0, 0, self.cloud_params,
                                        x_spec, fresh=cold, mesh=mesh)
        rep.t_compile_cloud = sw.elapsed() - rep.t_reshard
        rep.t_wall = rep.t_weights + sw_wall.elapsed()
        if dev.type == "cuda" and self.mesh_shape is None:
            self.graphs = (StageGraph(dev), StageGraph(dev))
        return rep

    @property
    def ready(self) -> bool:
        return self.edge_fn is not None

    def close(self) -> None:
        if self.graphs is not None:
            for g in self.graphs:
                g.reset()
        self.graphs = None
        self.embed_fn = self.edge_fn = self.cloud_fn = self.head_fn = None
        self.params = self.cloud_params = self.mesh = None

    def reshard(self) -> int:
        """Place the live cloud-range decode state on this pipeline's
        placement (``PipelinePool.activate``'s mesh-transition hook): onto
        its mesh, or back to the session's device for a single-device
        pipeline taking over from a mesh.  The weights were placed at
        build, so only the state, which kept advancing on the old
        placement, moves.  Returns the logical bytes moved.  A session
        without ``replace_state`` (a slot pool) moves nothing here, as in
        the reference: its next step places the state (``_step``)."""
        s = self.session
        if not self.ready or not hasattr(s, "replace_state"):
            return 0
        placed = {}
        for k, v in s.subset(self._u_edge, self._u_all).items():
            if self.mesh is None:
                if isinstance(v, TP.ShardedTensor):
                    placed[k] = v.gather(s.device)
            else:
                t = TP.place_entry(self.cloud_params, k, v)
                if t is not v:
                    placed[k] = t
        synchronize(s.device)
        if self.mesh is not None:
            TP.synchronize_mesh(self.mesh)
        s.replace_state(placed)
        return sum(v.numel() * v.element_size() for v in placed.values())

    # -- serve -----------------------------------------------------------
    def _stage_graphs(self, token, cache_edge, cache_cloud, pos) -> tuple:
        """The step's (edge, cloud) graphs, each bound to the session's
        entries it reads and writes, or None for a stage that runs
        eagerly: off the card, on a mesh, where an entry is not a plain
        tensor on the card (state a mesh left sharded), or where the
        stage's capture raised.  A stage with no graph yet, or whose
        entries moved since its capture, is captured here."""
        if self.graphs is None:
            return None, None
        r = self.runner
        x_spec = TensorSpec((token.shape[0], 1, r.cfg.d_model),
                            self.params["embed"].dtype, r.device)
        ue, ua = self._u_edge, self._u_all

        # the stages as captured: their decode writes the new state into
        # the entries in place (``_make_decode_fn(in_place=True)``)
        def edge(i):
            decode = r._make_decode_fn(0, ue, in_place=True)
            x = self.embed_fn(self.params, i["token"])
            xe, _, b = decode(self.params, x, cache_edge, i["pos"])
            return xe, b

        def cloud(i):
            decode = r._make_decode_fn(ue, ua, in_place=True)
            xc, _, b = decode(self.cloud_params, i["x"], cache_cloud,
                              i["pos"])
            return self.head_fn(self.cloud_params, xc), b

        out = []
        for g, state, run, inputs in (
                (self.graphs[0], cache_edge, edge,
                 {"token": token, "pos": pos}),
                (self.graphs[1], cache_cloud, cloud,
                 {"x": x_spec, "pos": pos})):
            bound = addresses(state)
            usable = g.refused is None and bound is not None and (
                g.matches(bound, inputs) or g.capture(run, bound, inputs))
            out.append(g if usable else None)
        return tuple(out)

    def _step(self, token, cache_edge, cache_cloud, pos, graphs=(None, None)):
        """One decode step through both stages; returns everything the
        session needs to commit, plus the measured stage timing.  A stage
        given its graph (``_stage_graphs``) replays it, its state written
        in place; the others run their eager callables.  State left on a
        mesh that this pipeline does not run on (a slot pool's after a
        switch off the mesh) is brought back to the device first, as the
        reference pulls it back; a mesh stage places whole entries on its
        first step."""
        dev = self.runner.device
        g_edge, g_cloud = graphs
        with timing.span("step.gather"):
            cache_edge = {k: TP.whole(v, dev) for k, v in cache_edge.items()}
            if self.mesh is None:
                cache_cloud = {k: TP.whole(v, dev)
                               for k, v in cache_cloud.items()}
        with timing.timed("step.edge") as edge:
            if g_edge is not None:
                xe, b_e = g_edge.replay({"token": token, "pos": pos})
                new_e = {}
            else:
                with timing.span("step.embed"):
                    x = self.embed_fn(self.params, token)
                xe, new_e, b_e = self.edge_fn(self.params, x, cache_edge,
                                              pos)
            synchronize(dev)
        t_transfer = self.net.transfer_time(xe.numel() * xe.element_size())
        with timing.timed("step.cloud") as cloud:
            if g_cloud is not None:
                logits, b_c = g_cloud.replay({"x": xe, "pos": pos})
                logits, new_c = logits.clone(), {}
            else:
                xc, new_c, b_c = self.cloud_fn(self.cloud_params, xe,
                                               cache_cloud, pos)
                with timing.span("step.head"):
                    logits = self.head_fn(self.cloud_params, xc)
            if self.mesh is None:
                synchronize(dev)
            else:
                TP.synchronize_mesh(self.mesh)
                logits, b_c = logits.to(dev), b_c.to(dev)
        bounds = torch.cat([b_e, b_c], 0)
        return logits, {**new_e, **new_c}, bounds, \
            RequestTiming(edge.wall * self.edge_scale, t_transfer,
                          cloud.wall)

    def process(self, inputs=None, *, batch: int = 1, seq=None) -> tuple:
        """Serve one decode request: advance the session by one token."""
        assert self.ready, "pipeline not built"
        s = self.session
        if s.pos >= self.runner.max_seq:
            raise RuntimeError(f"decode context full ({s.pos} >= "
                               f"max_seq {self.runner.max_seq})")
        with timing.span("step"):
            token = None
            if isinstance(inputs, dict):
                token = inputs.get("token")
            if token is None:
                token = s.next_token()
            token = _as_tokens(token, self.runner.device)
            pos = s.step_pos()
            cache_edge = s.subset(0, self._u_edge)
            cache_cloud = s.subset(self._u_edge, self._u_all)
            graphs = self._stage_graphs(token, cache_edge, cache_cloud, pos)
            if self.runner.device.type == "cuda" and None in graphs:
                timing.count("graph_eager", graphs.count(None))
            logits, new, bounds, stage_timing = self._step(
                token, cache_edge, cache_cloud, pos, graphs)
            with timing.span("step.commit"):
                s.commit_step(token, new, bounds, logits)
        return logits, stage_timing

    def warm(self, sample_inputs=None) -> RequestTiming:
        """Throwaway forward on SCRATCH state: absorbs the first-execution
        spike without advancing (or touching) the live session.  Runs the
        eager callables: no graph is captured, none is bound to scratch
        buffers."""
        s = self.session
        dev = self.runner.device
        zeros = lambda t: {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                           for k, v in t.items()}
        tok = torch.zeros((s.batch, 1), dtype=torch.long,
                          device=self.runner.device)
        _, _, _, stage_timing = self._step(
            tok, zeros(s.subset(0, self._u_edge)),
            zeros(s.subset(self._u_edge, self._u_all)),
            torch.zeros_like(s.step_pos()))
        return stage_timing

    # -- memory accounting ------------------------------------------------
    def live_param_bytes(self) -> int:
        """The weights' bytes, and a mesh build's copy at its logical size,
        as the reference counts."""
        if not self.ready:
            return 0
        n = param_bytes(self.params)
        if self.mesh is not None:
            n += self.cloud_params.logical_bytes
        return n


# ---------------------------------------------------------------------------
# pool: hand-off executes at activation
# ---------------------------------------------------------------------------

@dataclass
class HandoffReport:
    """One executed state hand-off (what ``plan_handoff`` only priced)."""
    mode: str                 # 'transfer' | 'recompute' | 'none'
    moved_layers: int
    moved_bytes: int          # really-serialized bytes (transfer arm)
    t_wall: float             # measured on-thread seconds
    t_network: float          # priced link seconds (virtual, charged to
                              # the stream by the engine)
    plan: Optional[HandoffPlan]
    epoch: int                # session epoch the hand-off synced to
    fallback: bool = False    # transfer payload failed validation and the
                              # hand-off recovered via masked recompute

    @property
    def total(self) -> float:
        return self.t_wall + self.t_network


@guarded_by("_lock", "last_handoff", "handoffs")
class StatefulPipelinePool(PipelinePool):
    """PipelinePool over ``StatefulEdgeCloudPipeline``s.

    ``activate`` performs the state hand-off from the old active split to
    the new one before the pointer swap; the arm is the live plan's
    ``best`` unless ``force_mode`` pins it.  Entries carry the session
    epoch they were last synced at; a stale entry is re-synced at swap —
    the standby's built stages are reused, its view of the context is
    not.  ``session`` is a ``DecodeSession`` or a slot-pool
    ``SessionManager``: the whole batch hands off at once.  A pool's
    ``fault_plan`` mutates the transfer arm's payload in transit; the
    envelope check catches it and the hand-off recovers by masked
    recompute (``HandoffReport.fallback``).  The hand-off runs before the
    base activation, whose mesh transition (``reshard``) then moves the
    imported or recomputed state onto the new placement."""

    def __init__(self, runner: StatefulStageRunner, net: NetworkModel,
                 sample_inputs, *,
                 session: Union[DecodeSession, "SessionManager"],
                 force_mode: Optional[str] = None, **kwargs):
        super().__init__(runner, net, sample_inputs, **kwargs)
        self.session = session
        self.force_mode = force_mode
        self.last_handoff: Optional[HandoffReport] = None
        self.handoffs: List[HandoffReport] = []
        # a switch may move any layers: their transfer export finds its
        # page-locked blocks cached, never allocates in a downtime
        session.warm_export(0, runner.num_units)

    def _new_pipeline(self, key) -> StatefulEdgeCloudPipeline:
        return StatefulEdgeCloudPipeline(self.runner, key.split, self.net,
                                         session=self.session,
                                         owns_weights=key.owns_weights,
                                         mesh_shape=key.mesh_shape)

    # -- hand-off ---------------------------------------------------------
    def _execute_handoff(self, old_split: int, new_split: int
                         ) -> HandoffReport:
        s = self.session
        if s.pos == 0 or old_split == new_split:
            return HandoffReport("none", 0, 0, 0.0, 0.0, None, s.epoch)
        plan = plan_handoff(s.cfg, old_split=old_split, new_split=new_split,
                            seq_len=s.pos, batch=s.batch,
                            net=s.handoff_net(self.net),
                            target=s.calib_spec, act_bytes=4)
        mode = self.force_mode or plan.best
        lo, hi = min(old_split, new_split), max(old_split, new_split)
        fallback = False
        with timing.timed("handoff", mode=mode, layers=hi - lo) as sp:
            if mode == "transfer":
                with timing.span("handoff.export"):
                    payload, nbytes = s.export_layers(lo, hi)
                    timing.count("d2h_bytes", nbytes)
                fplan = self.fault_plan
                if fplan is not None:
                    # chaos valve: in-transit corruption/truncation
                    fplan.mutate_handoff(payload, epoch=s.epoch)
                # the (possibly corrupt) payload really crossed the link,
                # so its priced seconds stand even when validation
                # rejects it
                t_network = self.net.transfer_time(nbytes)
                try:
                    with timing.span("handoff.import"):
                        s.import_layers(payload)
                        timing.count("h2d_bytes", nbytes)
                except HandoffCorrupted as e:
                    warnings.warn(f"hand-off payload failed validation "
                                  f"({e}); recovering via masked recompute",
                                  HandoffIntegrityWarning)
                    s.recompute_layers(lo, hi)
                    mode, fallback = "recompute", True
                synchronize(s.device)
            else:
                s.recompute_layers(lo, hi)
                nbytes, t_network = 0, 0.0
        return HandoffReport(mode, hi - lo, nbytes, sp.wall, t_network,
                             plan, s.epoch, fallback=fallback)

    def _build_standby(self, split: int, owns_weights: bool) -> None:
        """Build the Scenario-A standby, then run the re-prefill that
        switching to it from the active split would run, once on scratch
        input (``DecodeSession.warm_recompute``), in the session's
        ``RecomputeArena``.  The hand-off then finds its temporaries there:
        in the shared cache a standby's build or a decode step can take
        them, and the fresh ``cudaMalloc``s a hand-off then made stretched
        it to twice its wall on the card (PERF.md).  The build pays for
        them instead; ``build_standby``'s time includes it."""
        super()._build_standby(split, owns_weights)
        with self._lock:
            active = self.active_key
        if active is not None:
            self.session.warm_recompute(active.split, split)

    def take_last_handoff(self) -> Optional[HandoffReport]:
        """Pop the hand-off the most recent activation executed (the
        ``SwitchReport``-stamping contract of ``strategies.apply_handoff``)."""
        with self._lock:
            h, self.last_handoff = self.last_handoff, None
        return h

    # -- overridden lifecycle ---------------------------------------------
    def activate(self, key) -> float:
        """Hand-off + pointer swap.  The returned ``t_switch`` INCLUDES
        the hand-off's measured wall, so every strategy's own downtime /
        t_blocked accounting sees it exactly once — the priced link
        seconds (virtual) are the only part left for
        ``strategies.apply_handoff`` to add."""
        key = self._coerce_key(key)
        with self._lock:
            old_key = self.active_key if self.active_key is not None \
                else self._paused_key
            old_split = old_key.split if old_key is not None else None
            entry = self._entries[key]
            handoff = None
            if old_split is not None and (
                    old_split != entry.pipeline.split
                    or entry.state_epoch != self.session.epoch):
                # moved layers change sides; a stale same-split standby is
                # re-synced (a no-move hand-off) rather than trusted
                handoff = self._execute_handoff(old_split,
                                                entry.pipeline.split)
            t_switch = super().activate(key)
            entry.state_epoch = self.session.epoch
            if handoff is not None:
                self.last_handoff = handoff
                self.handoffs.append(handoff)
                t_switch += handoff.t_wall
        return t_switch


# ---------------------------------------------------------------------------
# convenience constructor
# ---------------------------------------------------------------------------

def make_stateful_manager(cfg: ArchConfig, params=None, *, split: int,
                          net: NetworkModel, prompt_len: int = 32,
                          batch: int = 1, max_seq: int = 128, seed: int = 0,
                          standby_split: Optional[int] = None,
                          warm_standbys: bool = False,
                          force_mode: Optional[str] = None,
                          mem_budget_bytes: Optional[int] = None,
                          decode_impl: str = "auto", rolled: bool = True,
                          attn_impl: str = "chunked", device="cuda",
                          dtype: torch.dtype = torch.float32, prompt=None):
    """A ``PipelineManager`` whose pool serves a stateful decode stream.

    Prefills a prompt so the session state (and its hand-off surface)
    exists before the first pipeline builds.  Returns ``(manager,
    session)``.  Without ``params``, weights come from ``init_model``
    seeded with ``seed``, in ``dtype``; without ``prompt`` (``(batch,
    prompt_len)`` token ids), the prompt is drawn from a generator seeded
    with ``seed + 1``.  ``attn_impl`` is the runner's full-sequence
    attention (prefill and the recompute arm): ``"kernel"`` puts both on
    the flash-attention kernel.  ``device`` defaults to the card."""
    from repro_torch.core.switching import PipelineManager
    dev = resolve_device(device)
    freeze_startup_heap()       # once a process, before the first model
    if params is None:
        params = T.init_model(cfg, dtype=dtype, device=dev, seed=seed)
    runner = StatefulStageRunner(cfg, params, max_seq=max_seq,
                                 attn_impl=attn_impl,
                                 decode_impl=decode_impl, rolled=rolled,
                                 device=dev)
    session = DecodeSession(runner)
    if prompt is None:
        gen = torch.Generator().manual_seed(seed + 1)
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=gen)
    tokens = _as_tokens(prompt, dev)
    session.prefill(tokens)
    pool = StatefulPipelinePool(runner, net, {"tokens": tokens},
                                session=session, force_mode=force_mode,
                                warm_standbys=warm_standbys,
                                mem_budget_bytes=mem_budget_bytes)
    mgr = PipelineManager(runner, split, net, {"tokens": tokens},
                          pool=pool, standby_split=standby_split)
    return mgr, session
