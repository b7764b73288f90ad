"""Stateful dynamic switching: live KV state hand-off at repartition.

The PyTorch counterpart of ``repro/core/stateful.py`` for the attention
families of this slice (dense); ``ssm``/``hybrid``/``moe``/``vlm`` raise
``NotImplementedError`` naming the slice that brings them.  A decode
pipeline is stateful: every attention layer carries a per-stream KV
cache, and when the split moves from ``a`` to ``b`` the state of layers
``[min(a,b), max(a,b))`` changes sides.  ``core/state_handoff.plan_handoff``
prices the two ways of moving it; this module executes the plan:

* ``transfer``  — the moved layers' KV is really serialized (``bytes``),
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
  layer's cache at the decode position in place, and the session writes
  each step's token and boundary activations into device buffers
  preallocated at ``max_seq``: the reference concatenates its history
  on the host every step, which at full width would copy hundreds of MB
  per token.  Snapshots therefore copy.
* **The position stays on the device.**  ``step_pos`` is an int32 device
  tensor; the decode path and the flash-decode kernel read it there and
  never wait on the host.  The host keeps its own integer ``pos`` for
  bookkeeping (context full, export slicing).
* **Timing.**  Stage walls synchronise the card where JAX blocks until
  ready; otherwise they would time the launches only.
* **Payloads** keep the reference's ``(dtype str, shape, bytes)`` entries
  and ``(epoch, pos, crc32)`` envelope, so the two packages' hand-offs
  interchange; bf16 travels as its raw 16-bit pattern tagged
  ``"bfloat16"``, which is also what the reference's bytes are.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.concurrency import (RANK_SESSION, RANK_STATEFUL_RUNNER,
                                          guarded_by, make_lock)
from repro_torch.core.hardware import CLOUD_SPEC, EDGE_SPEC
from repro_torch.core.network import NetworkModel
from repro_torch.core.pipeline import BuildReport, RequestTiming
from repro_torch.core.pool import PipelinePool
from repro_torch.core.stages import (TensorSpec, abstractify,
                                     aval_fingerprint, materialize,
                                     tree_leaves, tree_map)
from repro_torch.core.state_handoff import HandoffPlan, plan_handoff
from repro_torch.core.timing import Stopwatch
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import flash_decode as FD
from repro_torch.models import layers as Lyr
from repro_torch.models import transformer as T

_ATTN_FAMILIES = ("dense",)
_LATER = {"moe": "the MoE slice (layers.moe_layer)",
          "vlm": "the remaining-families slice",
          "ssm": "the SSM/hybrid slice (mamba1_scan)",
          "hybrid": "the SSM/hybrid slice (ssd_scan)"}
_DECODE_IMPLS = ("auto", "kernel", "reference")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family in _ATTN_FAMILIES:
        return
    if cfg.family in _LATER:
        raise NotImplementedError(f"stateful serving of {cfg.family!r} "
                                  f"arrives with {_LATER[cfg.family]}")
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


def _to_payload(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """A tensor as (dtype str, host array); bf16 as its 16-bit pattern."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return str(a.dtype), a


def _from_payload(dtype: str, shape, buf: bytes) -> torch.Tensor:
    if dtype == "bfloat16":
        a = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    a = np.frombuffer(buf, dtype=dtype).reshape(shape)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# unit layout
# ---------------------------------------------------------------------------

def unit_list(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """Execution-ordered state units: ``("layer", i)`` per decoder layer."""
    _check_family(cfg)
    return [("layer", i) for i in range(cfg.num_layers)]


def unit_index_of_split(cfg: ArchConfig, split: int) -> int:
    """Units on the edge for a split of ``split`` LAYERS."""
    return min(max(split, 0), cfg.num_layers)


def _unit_state_keys(cfg: ArchConfig, unit: Tuple[str, int]) -> Tuple[str, ...]:
    _, idx = unit
    return (f"k{idx}", f"v{idx}")


def _fit_kv(a, cap: int):
    """(B, S, KH, hd) seq-major prefill K/V -> heads-major (B, KH, cap, hd),
    contiguous (the flash-decode kernel reads it as one block)."""
    S = a.shape[1]
    if S > cap:
        a = a[:, S - cap:]
    elif S < cap:
        a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, cap - S))
    return a.transpose(1, 2).contiguous()


def _as_tokens(tokens, device) -> torch.Tensor:
    """Token ids (tensor, numpy or nested lists) as int64 on ``device``."""
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device, torch.long)
    return torch.from_numpy(np.array(tokens, dtype=np.int64)).to(device)


def _layer(params, idx: int):
    """Layer ``idx``'s weights as views into the stacked tensors."""
    return tree_map(lambda a: a[idx], params["layers"])


def _param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


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
    ``decode_impl`` selects the decode attention: ``"kernel"`` routes it
    through the hand-written flash-decode kernel (whose wrapper runs the
    plain version on a CPU tensor), ``"reference"`` through
    ``layers.decode_attention``; ``"auto"`` resolves ONCE at construction
    to kernel on CUDA and reference elsewhere.  ``rolled`` is accepted for
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

    def _attend(self, q, kc, vc, pos):
        """One-token attention vs the heads-major cache, routed per
        ``decode_impl``.  Both paths take/return (B, 1, H, hd) and accept
        a scalar or per-row ``(B,)`` decode position; the cache already
        holds this token, so ``pos + 1`` entries are valid."""
        if self.resolved_decode_impl == "kernel":
            return FD.flash_decode_attention(q, kc, vc, pos=pos + 1)
        return Lyr.decode_attention(q, kc, vc, pos=pos + 1)

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
    def _cache_write(cache, val, pos):
        """Write a one-token heads-major (B, KH, 1, hd) update at the
        decode position IN PLACE (see the module docstring): one indexed
        copy for a shared scalar pos, a per-row scatter for ``(B,)``."""
        if pos.dim() == 0:
            return cache.index_copy_(2, pos.reshape(1).long(), val)
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, :, pos.long()] = val[:, :, 0]
        return cache

    @property
    def num_units(self) -> int:
        """Split domain for the pool/partitioner: one unit per LAYER."""
        return self.cfg.num_layers

    def edge_param_bytes(self, split: int) -> int:
        """Layer-proportional edge parameter bytes at ``split``."""
        frac = (split + 1) / (self.cfg.num_layers + 2)
        return int(_param_bytes(self.params) * frac)

    # -- one decoder unit, one token ------------------------------------
    def _decode_unit(self, params, unit, x, cache, new, pos, rope):
        cfg = self.cfg
        kk, vk = _unit_state_keys(cfg, unit)
        p = _layer(params, unit[1])
        B = x.shape[0]
        h = T._apply_norm(cfg, p["ln1"], x)
        q, k, v = T._project_qkv(cfg, p["attn"], h)
        cos, sin = rope
        q = Lyr.apply_rope(q, cos, sin)
        k = Lyr.apply_rope(k, cos, sin)
        kc = self._cache_write(
            cache[kk], k.transpose(1, 2).to(cache[kk].dtype), pos)
        vc = self._cache_write(
            cache[vk], v.transpose(1, 2).to(cache[vk].dtype), pos)
        new[kk], new[vk] = kc, vc
        att = self._attend(q, kc, vc, pos)
        x = x + att.reshape(B, 1, -1) @ p["attn"]["wo"]
        h2 = T._apply_norm(cfg, p["ln2"], x)
        return x + Lyr.mlp(p["mlp"], h2, gated=cfg.gated_mlp)

    def _make_decode_fn(self, u0: int, u1: int):
        units = self.units[u0:u1]

        def fn(params, x, cache, pos):
            new: Dict[str, Any] = {}
            bounds = []
            rope = self._decode_rope(pos)
            for unit in units:
                bounds.append(x)
                x = self._decode_unit(params, unit, x, cache, new, pos, rope)
            b = torch.stack(bounds) if bounds \
                else x.new_zeros((0,) + tuple(x.shape))
            return x, new, b
        return fn

    # -- one decoder unit, full sequence --------------------------------
    def _make_full_fn(self, u0: int, u1: int):
        units = self.units[u0:u1]
        cfg = self.cfg

        def fn(params, x):
            S = x.shape[1]
            rope_cs = Lyr.rope_cos_sin(torch.arange(S, device=x.device),
                                       cfg.head_dim, cfg.rope_theta)
            caches: Dict[str, Any] = {}
            bounds = []
            for unit in units:
                bounds.append(x)
                kk, vk = _unit_state_keys(cfg, unit)
                x, (k, v), _ = T.attn_block_full(
                    cfg, _layer(params, unit[1]), x, rope_cs,
                    impl=self.attn_impl, window=cfg.sliding_window)
                caches[kk] = _fit_kv(k, self.max_seq)
                caches[vk] = _fit_kv(v, self.max_seq)
            b = torch.stack(bounds) if bounds \
                else x.new_zeros((0,) + tuple(x.shape))
            return x, caches, b
        return fn

    # -- masked re-prefill (the recompute hand-off arm) ------------------
    # The context is zero-padded to ``max_seq`` (one shape per unit range,
    # whatever the context length) and correctness beyond the live length
    # is enforced the way bucketed prefills do it: causal attention already
    # ignores the pad for valid rows, and pad rows are masked out of the
    # cache.

    def _make_recompute_fn(self, u0: int, u1: int):
        units = self.units[u0:u1]
        cfg = self.cfg
        CL = self.max_seq

        def fn(params, x, length):
            # x: (B, CL, D) zero-padded context; length: live prefix — a
            # scalar shared by the batch or per-row (B,)
            length = torch.as_tensor(length, device=x.device)
            ar = torch.arange(CL, device=x.device)
            if length.dim() == 0:
                m = (ar < length)[None, :, None, None]
            else:
                m = (ar[None, :] < length[:, None])[:, :, None, None]
            rope_cs = Lyr.rope_cos_sin(ar, cfg.head_dim, cfg.rope_theta)
            caches: Dict[str, Any] = {}
            for unit in units:
                kk, vk = _unit_state_keys(cfg, unit)
                x, (k, v), _ = T.attn_block_full(
                    cfg, _layer(params, unit[1]), x, rope_cs,
                    impl=self.attn_impl, window=cfg.sliding_window)
                caches[kk] = (k * m).transpose(1, 2).contiguous()
                caches[vk] = (v * m).transpose(1, 2).contiguous()
            return caches
        return fn

    def recompute_fn(self, u0: int, u1: int):
        """Cached masked re-prefill fn for units [u0, u1), reused at every
        context length."""
        with self._lock:
            key = ("recompute", u0, u1)
            if key not in self._full_cache:
                self._full_cache[key] = self._make_recompute_fn(u0, u1)
            return self._full_cache[key]

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

    # -- built stages ------------------------------------------------------
    def executable(self, mode: str, u0: int, u1: int, params, *args,
                   fresh: bool = False):
        """Built stage callable for a unit range, for args shaped like
        ``args`` (tensors or ``TensorSpec``s; never read, only their
        shapes).

        ``mode``: ``decode`` (params, x, cache, pos), ``embed`` (params,
        tokens), ``head`` (params, x).  A miss (or
        ``fresh=True``) makes the callable and runs one synchronised
        warm-up forward on scratch state shaped like ``args``; only a warm
        (``fresh=False``) build is cached."""
        makers = {"decode": lambda: self._make_decode_fn(u0, u1),
                  "embed": self._make_embed_fn,
                  "head": self._make_head_fn}
        specs = abstractify(args)
        key = (mode, u0, u1) + aval_fingerprint(specs)
        if not fresh:
            with self._lock:
                hit = self._stage_cache.get(key)
            if hit is not None:
                return hit
        fn = makers[mode]()
        fn(params, *materialize(specs))           # warm-up on scratch state
        synchronize(self.device)
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
        """Land one decode step: state updates, token and boundary
        checkpoints written at ``pos``, epoch bump."""
        with self._lock:
            p = self.pos
            self.cache.update(new_state)
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
        live context.  Returns (payload, nbytes); the payload carries the
        ``(epoch, pos, crc32)`` envelope ``import_layers`` validates."""
        u0 = unit_index_of_split(self.cfg, lo)
        u1 = unit_index_of_split(self.cfg, hi)
        payload: Dict[str, tuple] = {}
        nbytes = 0
        with self._lock:
            for unit in self.runner.units[u0:u1]:
                for k in _unit_state_keys(self.cfg, unit):
                    dtype, arr = _to_payload(self.cache[k][:, :, :self.pos])
                    buf = arr.tobytes()
                    payload[k] = (dtype, arr.shape, buf)
                    nbytes += len(buf)
            payload[HANDOFF_META_KEY] = (self.epoch, self.pos,
                                         payload_checksum(payload))
        return payload, nbytes

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
        """Deserialize an ``export_layers`` payload back into the state:
        each sliced KV entry lands in a fresh zero buffer of the cache's
        shape (one host-to-device copy).  Validates and decodes every
        entry BEFORE committing anything, so on corruption the session
        state is untouched."""
        self.validate_payload(payload)
        decoded: Dict[str, torch.Tensor] = {}
        try:
            for k, (dtype, shape, buf) in payload.items():
                if k == HANDOFF_META_KEY:
                    continue
                decoded[k] = _from_payload(dtype, shape, buf)
        except (ValueError, TypeError) as e:   # short buffer / bad dtype
            raise HandoffCorrupted(f"undecodable hand-off entry "
                                   f"{k!r}: {e}") from None
        with self._lock:
            for k, t in decoded.items():
                full = torch.zeros(self.cache[k].shape, dtype=t.dtype,
                                   device=self.device)
                full[:, :, :t.shape[2]] = t.to(self.device)
                self.cache[k] = full

    def recompute_layers(self, lo: int, hi: int) -> None:
        """Re-prefill layers [lo, hi) over the full live context from the
        boundary checkpoint entering layer ``lo`` (measured by the
        caller), padded to ``max_seq``."""
        u0 = unit_index_of_split(self.cfg, lo)
        u1 = unit_index_of_split(self.cfg, hi)
        if u0 >= u1:
            return
        r = self.runner
        with self._lock:
            T_len = self.pos
            x_pad = self._bounds[u0].clone()           # (B, max_seq, D)
        x_pad[:, T_len:] = 0
        caches = r.recompute_fn(u0, u1)(r.params, x_pad, T_len)
        synchronize(self.device)
        with self._lock:
            self.cache.update(caches)

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
    """Two built decode stages over a shared ``DecodeSession``.

    ``process`` runs ONE decode step: the edge stage covers the embedding
    plus layers [0, split) (measured wall, scaled by ``edge_scale``), the
    one-token hidden state crossing the link is priced with the current
    ``NetworkModel``, and the cloud stage covers layers [split, L) plus
    the LM head (measured wall).  The session advances once per served
    request."""

    def __init__(self, runner: StatefulStageRunner, split: int,
                 net: NetworkModel, *, session: DecodeSession,
                 edge_scale: float = CLOUD_SPEC.flops / EDGE_SPEC.flops,
                 owns_weights: bool = False):
        self.runner = runner
        self.session = session
        self.split = min(max(int(split), 0), runner.num_units)
        self.net = net
        self.edge_scale = edge_scale
        self.owns_weights = owns_weights
        self.params = runner.params
        self._u_edge = unit_index_of_split(runner.cfg, self.split)
        self._u_all = len(runner.units)
        self.embed_fn = None
        self.edge_fn = None
        self.cloud_fn = None
        self.head_fn = None

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
            abstractify(s.subset(0, self._u_edge)), pos_spec, fresh=cold)
        rep.t_compile_edge = sw.restart()
        self.cloud_fn = r.executable(
            "decode", self._u_edge, self._u_all, self.params, x_spec,
            abstractify(s.subset(self._u_edge, self._u_all)), pos_spec,
            fresh=cold)
        self.head_fn = r.executable("head", 0, 0, self.params, x_spec,
                                    fresh=cold)
        rep.t_compile_cloud = sw.elapsed()
        rep.t_wall = rep.t_weights + sw_wall.elapsed()
        return rep

    @property
    def ready(self) -> bool:
        return self.edge_fn is not None

    def close(self) -> None:
        self.embed_fn = self.edge_fn = self.cloud_fn = self.head_fn = None
        self.params = None

    # -- serve -----------------------------------------------------------
    def _step(self, token, cache_edge, cache_cloud, pos):
        """One decode step through both stages; returns everything the
        session needs to commit, plus the measured stage timing."""
        dev = self.runner.device
        sw = Stopwatch()
        x = self.embed_fn(self.params, token)
        xe, new_e, b_e = self.edge_fn(self.params, x, cache_edge, pos)
        synchronize(dev)
        t_edge = sw.elapsed() * self.edge_scale
        t_transfer = self.net.transfer_time(xe.numel() * xe.element_size())
        sw = Stopwatch()
        xc, new_c, b_c = self.cloud_fn(self.params, xe, cache_cloud, pos)
        logits = self.head_fn(self.params, xc)
        synchronize(dev)
        t_cloud = sw.elapsed()
        bounds = torch.cat([b_e, b_c], 0)
        return logits, {**new_e, **new_c}, bounds, \
            RequestTiming(t_edge, t_transfer, t_cloud)

    def process(self, inputs=None, *, batch: int = 1, seq=None) -> tuple:
        """Serve one decode request: advance the session by one token."""
        assert self.ready, "pipeline not built"
        s = self.session
        if s.pos >= self.runner.max_seq:
            raise RuntimeError(f"decode context full ({s.pos} >= "
                               f"max_seq {self.runner.max_seq})")
        token = None
        if isinstance(inputs, dict):
            token = inputs.get("token")
        if token is None:
            token = s.next_token()
        token = _as_tokens(token, self.runner.device)
        pos = s.step_pos()
        logits, new, bounds, timing = self._step(
            token, s.subset(0, self._u_edge),
            s.subset(self._u_edge, self._u_all), pos)
        s.commit_step(token, new, bounds, logits)
        return logits, timing

    def warm(self, sample_inputs=None) -> RequestTiming:
        """Throwaway forward on SCRATCH state: absorbs the first-execution
        spike without advancing (or touching) the live session."""
        s = self.session
        zeros = lambda t: {k: torch.zeros_like(v) for k, v in t.items()}
        tok = torch.zeros((s.batch, 1), dtype=torch.long,
                          device=self.runner.device)
        _, _, _, timing = self._step(
            tok, zeros(s.subset(0, self._u_edge)),
            zeros(s.subset(self._u_edge, self._u_all)),
            torch.zeros_like(s.step_pos()))
        return timing

    # -- memory accounting ------------------------------------------------
    def live_param_bytes(self) -> int:
        return _param_bytes(self.params) if self.ready else 0


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
    not."""

    def __init__(self, runner: StatefulStageRunner, net: NetworkModel,
                 sample_inputs, *, session: DecodeSession,
                 force_mode: Optional[str] = None, **kwargs):
        super().__init__(runner, net, sample_inputs, **kwargs)
        self.session = session
        self.force_mode = force_mode
        self.last_handoff: Optional[HandoffReport] = None
        self.handoffs: List[HandoffReport] = []

    def _new_pipeline(self, key) -> StatefulEdgeCloudPipeline:
        return StatefulEdgeCloudPipeline(self.runner, key.split, self.net,
                                         session=self.session,
                                         owns_weights=key.owns_weights)

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
        sw = Stopwatch()
        if mode == "transfer":
            payload, nbytes = s.export_layers(lo, hi)
            # the payload really crossed the link, so its priced seconds
            # stand even when validation rejects it
            t_network = self.net.transfer_time(nbytes)
            try:
                s.import_layers(payload)
            except HandoffCorrupted as e:
                warnings.warn(f"hand-off payload failed validation ({e}); "
                              f"recovering via masked recompute",
                              HandoffIntegrityWarning)
                s.recompute_layers(lo, hi)
                mode, fallback = "recompute", True
            synchronize(s.device)
        else:
            s.recompute_layers(lo, hi)
            nbytes, t_network = 0, 0.0
        t_wall = sw.elapsed()
        return HandoffReport(mode, hi - lo, nbytes, t_wall, t_network,
                             plan, s.epoch, fallback=fallback)

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
                          device="cuda", dtype: torch.dtype = torch.float32,
                          prompt=None):
    """A ``PipelineManager`` whose pool serves a stateful decode stream.

    Prefills a prompt so the session state (and its hand-off surface)
    exists before the first pipeline builds.  Returns ``(manager,
    session)``.  Without ``params``, weights come from ``init_model``
    seeded with ``seed``, in ``dtype``; without ``prompt`` (``(batch,
    prompt_len)`` token ids), the prompt is drawn from a generator seeded
    with ``seed + 1``.  ``device`` defaults to the card."""
    from repro_torch.core.switching import PipelineManager
    dev = resolve_device(device)
    if params is None:
        params = T.init_model(cfg, dtype=dtype, device=dev, seed=seed)
    runner = StatefulStageRunner(cfg, params, max_seq=max_seq,
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
