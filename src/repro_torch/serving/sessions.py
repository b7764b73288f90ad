"""Slot-indexed multi-session decode serving.

The PyTorch counterpart of ``repro/serving/sessions.py``.
``DecodeSession`` serves ONE stream; production edge-cloud decode means
many concurrent sessions with ragged context lengths sharing one
pipeline, all of whose state must survive a repartition together.  The
``SessionManager`` here generalises the session's per-unit KV/conv/SSM
entries into a **slot pool**:

* **Fixed bucket shapes** — every state buffer carries a leading
  ``(num_slots,)`` axis padded to the runner's ``max_seq`` (the boundary
  checkpoints ``(U, num_slots, max_seq, D)``, unit-major as the recompute
  arm reads them), all on ``runner.device``.  Empty ("dead") slots ride
  along in the batch and are masked: every decode op is row-independent
  (causal attention, per-row rope/KV writes, per-row SSM updates), so a
  dead or newly-admitted slot can NEVER perturb a live slot's logits —
  the row-coupled MoE family is excluded for exactly this reason.
* **Mid-flight admission** — ``admit`` runs the runner's masked-prefill
  admission fn at a fixed ``(1, max_seq)`` bucket and writes the
  resulting row state into a free slot while the other slots keep
  decoding.
* **LRU / preemption eviction** — live per-slot state is priced with
  ``state_handoff.per_layer_state_bytes`` against ``mem_budget_bytes``;
  over-budget admission parks the least-recently-used slot's state as a
  serialized payload that ``readmit`` restores bit-exactly later.
* **Batch hand-off** — the manager speaks ``DecodeSession``'s hand-off
  interface (``step_pos``/``subset``/``commit_step``/``export_layers``/
  ``import_layers``/``recompute_layers``), so ``StatefulPipelinePool``
  hands off the ENTIRE batch's state before the pointer swap: transfer
  serializes every slot's sliced KV in one payload, and the recompute arm
  replays the masked fixed-shape pass with a per-slot ``(num_slots,)``
  length vector.

Where the port differs from the reference, and why: the position vector
``step_pos`` is an int32 ``(num_slots,)`` tensor on the device (dead slots
at 0), advanced on the device by each committed step, and a step's token,
boundary activations and logits are written into the device buffers in
place for every live slot at once — the reference commits them slot by
slot into host arrays.  The host keeps each slot's integer ``pos`` for
bookkeeping.  Parked sessions and hand-off payloads use the port's
``(dtype str, shape, buffer)`` entries, so bf16 state travels as its
16-bit pattern: a hand-off's buffer is the page-locked host copy itself
(``core.stateful.HostBuffer``, read-only, alive until the import has
consumed it), a parked session's is ``bytes`` of its own, which outlive
the pool's host blocks.

On a tensor-parallel mesh (``StatefulEdgeCloudPipeline(mesh_shape=)``)
the cloud range's entries become ``tp.ShardedTensor``s at the first step
there; every row operation takes them as they lie.  Admission and
readmission write the row into each shard's slice
(``ShardedTensor.write_row``), parking reads it gathered and zeroes it
per shard, and an export gathers whole entries into the same wire format.
Imports and recomputes land whole entries on ``runner.device``, which the
next step places.  The reference raises on every row write into its
mesh-placed cache (``tools/probe_reference_slot_mesh_ops.py``); the port
serves them.

Locking: slot metadata (``_slots``/``_parked``) is guarded by a rank-47
lock — above the stateful runner's rank-42 lock, so the manager must
NEVER call into the runner's caches while holding its own lock
(admission and recompute resolve their fns first, then take the lock to
commit).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import timing
from repro_torch.core.concurrency import (RANK_SESSION_MANAGER, guarded_by,
                                          make_lock)
from repro_torch.core.hardware import CLOUD_SPEC
from repro_torch.core.heap import freeze_startup_heap
from repro_torch.core.network import NetworkModel
from repro_torch.core.state_handoff import per_layer_state_bytes
from repro_torch.core.stateful import (HANDOFF_META_KEY, HandoffCorrupted,
                                       RecomputeArena, StatefulStageRunner,
                                       _as_tokens,
                                       _from_payload, _is_kv,
                                       _payload_entry, _unit_state_keys,
                                       payload_checksum,
                                       unit_index_of_split, warm_host_blocks,
                                       write_imported, write_state)
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed import tp as TP
from repro_torch.models import transformer as T


def _read_row(t, j: int, device) -> torch.Tensor:
    """Row ``j`` of a state entry, whole (gathered if on a mesh)."""
    return t.read_row(j, device) if isinstance(t, TP.ShardedTensor) \
        else t[j]


def _write_row(t, j: int, row: torch.Tensor) -> None:
    """Write the whole row ``row`` into row ``j`` of a state entry."""
    if isinstance(t, TP.ShardedTensor):
        t.write_row(j, row)
    else:
        t[j] = row


def _zero_row(t, j: int) -> None:
    if isinstance(t, TP.ShardedTensor):
        t.zero_row(j)
    else:
        t[j] = 0


def _parked_bytes(parked: dict) -> int:
    """Host bytes a parked session's copies hold."""
    n = sum(len(buf) for _, _, buf in parked["state"].values())
    return n + sum(parked[k].numel() * parked[k].element_size()
                   for k in ("tokens", "bounds", "logits"))


class SlotPoolFull(RuntimeError):
    """No free slot and preemption is disabled (or nothing is evictable)."""


@dataclass
class Slot:
    """One session's seat in the pool.  ``epoch`` is the manager epoch
    that last mutated this slot — the per-slot version a post-handoff
    consistency check compares against."""
    index: int
    sid: Optional[str] = None
    pos: int = 0
    live: bool = False
    last_used: int = 0
    epoch: int = -1


@guarded_by("_lock", "_slots", "_parked", rank=RANK_SESSION_MANAGER)
class SessionManager:
    """Slot-indexed state pool speaking ``DecodeSession``'s interface.

    Drop-in for the ``session=`` seat of ``StatefulPipelinePool`` /
    ``StatefulEdgeCloudPipeline``: ``step_pos()`` returns a
    ``(num_slots,)`` position vector (dead slots at 0), so the built
    stages decode the whole ragged batch per step, and the hand-off
    primitives move/rebuild every slot's state at once.
    """

    def __init__(self, runner: StatefulStageRunner, *, num_slots: int,
                 mem_budget_bytes: Optional[int] = None,
                 allow_preempt: bool = True):
        if runner.cfg.family == "moe":
            raise ValueError(
                "slot pools require row-independent decode ops; the MoE "
                "family's capacity-factor routing couples batch rows, so "
                "a dead slot could perturb live logits")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.runner = runner
        self.cfg: ArchConfig = runner.cfg
        self.device = runner.device
        self.num_slots = int(num_slots)
        self.max_seq = runner.max_seq
        self.mem_budget_bytes = mem_budget_bytes
        self.allow_preempt = allow_preempt
        self.epoch = 0
        self.calib_spec = CLOUD_SPEC        # refined by the first admit()
        self._calibrated = False
        self._next_sid = 0
        self._clock = 0
        self._step_fn = None                # lazy local-decode fn
        self._lock = make_lock("session-manager", RANK_SESSION_MANAGER)
        self.arena = RecomputeArena(self.device)
        self._slots: List[Slot] = [Slot(j) for j in range(self.num_slots)]
        self._parked: Dict[str, dict] = {}
        # fixed-bucket state buffers.  Shapes/dtypes come from one zero
        # pass of the admission fn.
        dev = self.device
        logits0, caches0, bounds0 = runner.admit_fn()(
            runner.params,
            torch.zeros((1, self.max_seq), dtype=torch.long, device=dev), 1)
        B = self.num_slots
        self.cache: Dict[str, Any] = {
            k: v.new_zeros((B,) + tuple(v.shape[1:]))
            for k, v in caches0.items()}
        self._bounds = bounds0.new_zeros(
            (bounds0.shape[0], B) + tuple(bounds0.shape[2:]))  # (U, B, S, D)
        self._tokens = torch.zeros((B, self.max_seq), dtype=torch.long,
                                   device=dev)
        self.last_logits = torch.zeros((B, logits0.shape[-1]),
                                       dtype=torch.float32, device=dev)
        # per-slot decode positions and the live mask, on the device; the
        # host's slot records are the truth they are rebuilt from
        self._pos_dev = torch.zeros(B, dtype=torch.int32, device=dev)
        self._live_dev = torch.zeros(B, dtype=torch.int32, device=dev)
        self._live_idx = torch.zeros(0, dtype=torch.long, device=dev)

    def _sync_slots(self) -> None:    # holds: _lock
        """Rebuild the device position vector and live mask from the
        slot records (after any admission, eviction or restore)."""
        dev = self.device
        self._pos_dev = torch.tensor([s.pos for s in self._slots],
                                     dtype=torch.int32, device=dev)
        self._live_dev = torch.tensor([int(s.live) for s in self._slots],
                                      dtype=torch.int32, device=dev)
        self._live_idx = torch.tensor(
            [s.index for s in self._slots if s.live], dtype=torch.long,
            device=dev)

    # -- DecodeSession-compatible surface --------------------------------
    @property
    def batch(self) -> int:
        """The pipeline's batch axis IS the slot count."""
        return self.num_slots

    @property
    def pos(self) -> int:
        """Max live decode position: the bucket length hand-off pricing
        uses and KV exports slice to (every row is zero beyond its own
        prefix, so the shared slice loses nothing)."""
        with self._lock:
            return max((s.pos for s in self._slots if s.live), default=0)

    def step_pos(self):
        """Per-slot decode positions, ``(num_slots,)`` int32 on the device
        — dead slots sit at 0 and decode into their own (masked) row only
        (a copy: commits advance the manager's own in place)."""
        with self._lock:
            return self._pos_dev.clone()

    def next_token(self):
        """Greedy next token per slot, ``(num_slots, 1)`` on the device
        (dead rows produce garbage tokens that only ever land in their own
        masked row)."""
        return self.last_logits.argmax(-1)[:, None]

    def handoff_net(self, net: NetworkModel) -> NetworkModel:
        """Slot pools skip the single-stream serialization calibration
        (payloads are batch-sized; the wire model dominates)."""
        return net

    def subset(self, u0: int, u1: int) -> Dict[str, Any]:
        """The slot-pool state entries a stage over units [u0, u1) sees."""
        with self._lock:
            out = {}
            for unit in self.runner.units[u0:u1]:
                for k in _unit_state_keys(self.cfg, unit):
                    out[k] = self.cache[k]
            return out

    def commit_step(self, token, new_state: Dict[str, Any], bounds,
                    logits) -> None:
        """Land one whole-batch decode step: the new batch's state is
        written into the state buffers where they lie (``write_state``),
        but tokens/bounds/logits commit per LIVE slot only — dead rows'
        garbage never reaches the bookkeeping buffers, so the
        zero-beyond-prefix invariant survives."""
        with self._lock:
            live = [s for s in self._slots if s.live]
            for slot in live:
                if slot.pos >= self.max_seq:
                    raise RuntimeError(
                        f"slot {slot.sid!r} context full ({slot.pos} >= "
                        f"max_seq {self.max_seq})")
            write_state(self.cache, new_state)
            self.epoch += 1
            if live:
                idx = self._live_idx
                p = self._pos_dev[idx].long()
                tok = _as_tokens(token, self.device).reshape(
                    self.num_slots, -1)
                self._tokens[idx, p] = tok[idx, 0]
                self._bounds[:, idx, p] = bounds[:, idx, 0].to(
                    self._bounds.dtype)
                self.last_logits[idx] = logits[idx].float()
                self._pos_dev += self._live_dev
            for slot in live:
                slot.pos += 1
                slot.epoch = self.epoch

    # -- admission --------------------------------------------------------
    def admit(self, prompt, sid: Optional[str] = None) -> str:
        """Prefill ``prompt`` into a free slot (mid-flight: the other
        slots' state is untouched).  With no free slot, preempts the LRU
        live slot (parking its state) when ``allow_preempt``; over-budget
        admission parks LRU slots until the pool fits.  Returns the
        session id."""
        prompt = _as_tokens(prompt, self.device).reshape(-1)
        L = int(prompt.shape[0])
        if not 0 < L <= self.max_seq:
            raise ValueError(f"prompt length {L} not in [1, {self.max_seq}]")
        r = self.runner
        with timing.span("admit"):
            # resolve the admission fn BEFORE taking our lock: the
            # runner's cache lock ranks below ours (42 < 47)
            admit_f = r.admit_fn()
            with timing.span("admit.prefill", rows=self.max_seq, prompt=L):
                tok = torch.zeros((1, self.max_seq), dtype=torch.long,
                                  device=self.device)
                tok[0, :L] = prompt
                logits, caches, bounds = admit_f(r.params, tok, L)
            synchronize(self.device)
            if not self._calibrated:
                # warm second run prices THIS HOST's recompute throughput
                # for the hand-off planner, exactly like
                # DecodeSession.prefill
                with timing.timed("admit.calibrate") as cal:
                    admit_f(r.params, tok, L)
                    synchronize(self.device)
                self._calibrate(cal.wall, L)
            with timing.span("admit.rows"):
                return self._admit_rows(tok, L, logits, caches, bounds, sid)

    def _admit_rows(self, tok, L: int, logits, caches, bounds,
                    sid: Optional[str]) -> str:
        """Write an admitted prompt's prefill into a free slot."""
        with self._lock:
            j = self._find_slot()
            slot = self._slots[j]
            for k, v in caches.items():
                _write_row(self.cache[k], j, v[0])
            self._bounds[:, j] = bounds[:, 0]
            self._tokens[j] = tok[0]
            self.last_logits[j] = logits[0]
            if sid is None:
                sid = f"s{self._next_sid}"
                self._next_sid += 1
            self.epoch += 1
            slot.sid, slot.live, slot.pos, slot.epoch = sid, True, L, \
                self.epoch
            self._touch(slot)
            self._evict_to_budget(keep=j)
            self._sync_slots()
        return sid

    def _calibrate(self, wall: float, toks: int) -> None:
        from repro_torch.core.profiler import _layer_flops
        flops = sum(_layer_flops(self.cfg, k, tokens=toks, seq=toks)
                    for k in self.cfg.layer_kinds())
        if wall > 0 and flops > 0:
            self.calib_spec = dataclasses.replace(
                CLOUD_SPEC, name="host-calibrated", flops=flops / wall,
                mfu=1.0)
        self._calibrated = True

    def _touch(self, slot: Slot) -> None:    # holds: _lock
        self._clock += 1
        slot.last_used = self._clock

    def _find_slot(self) -> int:    # holds: _lock
        for slot in self._slots:
            if not slot.live:
                return slot.index
        if not self.allow_preempt:
            raise SlotPoolFull(f"all {self.num_slots} slots live and "
                               f"preemption is disabled")
        victim = min((s for s in self._slots if s.live),
                     key=lambda s: s.last_used)
        self._park(victim.index)
        return victim.index

    # -- memory accounting / eviction -------------------------------------
    def slot_state_bytes(self, pos: int) -> int:
        """Priced bytes of one slot's live state at context length
        ``pos`` — the same ``per_layer_state_bytes`` pricing the hand-off
        planner uses (f32 state, one batch row, every unit)."""
        return per_layer_state_bytes(
            self.cfg, seq_len=max(int(pos), 1), batch=1, act_bytes=4) \
            * len(self.runner.units)

    def state_bytes(self) -> int:
        """Priced bytes of all live slots' state."""
        with self._lock:
            return sum(self.slot_state_bytes(s.pos)
                       for s in self._slots if s.live)

    def _evict_to_budget(self, keep: Optional[int] = None) -> None:  # holds: _lock
        if self.mem_budget_bytes is None:
            return
        while sum(self.slot_state_bytes(s.pos)
                  for s in self._slots if s.live) > self.mem_budget_bytes:
            victims = sorted((s for s in self._slots
                              if s.live and s.index != keep),
                             key=lambda s: s.last_used)
            if not victims:
                warnings.warn("session slot pool over memory budget but "
                              "nothing evictable", RuntimeWarning)
                break
            self._park(victims[0].index)

    def evict(self, sid: str) -> None:
        """Park ``sid``'s state (freeing its slot) for a later
        ``readmit``.  The parked payload uses the same serialized
        ``(dtype, shape, buffer)`` entries as ``export_layers``, so the
        round trip exercises the hand-off representation; its buffers are
        ``bytes`` of its own (a parked session outlives the host blocks
        a hand-off's buffers hold)."""
        with timing.span("evict"):
            with self._lock:
                self._park(self._slot_index(sid))
                self._sync_slots()

    def _slot_index(self, sid: str) -> int:    # holds: _lock
        for slot in self._slots:
            if slot.live and slot.sid == sid:
                return slot.index
        raise KeyError(f"no live session {sid!r}")

    def _park_copy(self, j: int, pos: int) -> dict:    # holds: _lock
        """Slot ``j``'s state, tokens, boundary checkpoints and logits at
        context ``pos``, copied to the host."""
        state: Dict[str, tuple] = {}
        for unit in self.runner.units:
            for k in _unit_state_keys(self.cfg, unit):
                t = _read_row(self.cache[k], j, self.device)
                if _is_kv(k):                    # row KV: (KH, S, hd)
                    t = t[:, :pos]
                dtype, shape, buf = _payload_entry(t)
                state[k] = (dtype, shape, bytes(buf))
        return {
            "state": state,
            # host copies (on a CPU pool ``.cpu()`` alone would alias the
            # slot buffers this method zeroes next)
            "tokens": self._tokens[j, :pos].to("cpu", copy=True),
            "bounds": self._bounds[:, j, :pos].to("cpu", copy=True),
            "logits": self.last_logits[j].to("cpu", copy=True),
            "pos": pos,
        }

    def _park(self, j: int) -> None:    # holds: _lock
        slot = self._slots[j]
        with timing.span("park", pos=slot.pos):
            with timing.span("park.copy"):
                parked = self._park_copy(j, slot.pos)
                timing.count("d2h_bytes", _parked_bytes(parked))
            self._parked[slot.sid] = parked
            with timing.span("park.zero"):
                for v in self.cache.values():
                    _zero_row(v, j)
                self._tokens[j] = 0
                self._bounds[:, j] = 0
                self.last_logits[j] = 0
        self.epoch += 1
        slot.sid, slot.live, slot.pos, slot.epoch = None, False, 0, -1

    def readmit(self, sid: str) -> str:
        """Restore a parked session into a free slot, bit-exactly."""
        with self._lock:
            if sid not in self._parked:
                raise KeyError(f"no parked session {sid!r}")
            j = self._find_slot()
            parked = self._parked.pop(sid)
            slot = self._slots[j]
            pos = parked["pos"]
            dev = self.device
            for k, (dtype, shape, buf) in parked["state"].items():
                t = _from_payload(dtype, shape, buf, dev)
                if _is_kv(k):
                    row = t.new_zeros(self.cache[k].shape[1:])
                    row[:, :t.shape[1]] = t
                    t = row
                _write_row(self.cache[k], j, t)
            self._tokens[j, :pos] = parked["tokens"].to(dev)
            self._bounds[:, j, :pos] = parked["bounds"].to(dev)
            self.last_logits[j] = parked["logits"].to(dev)
            self.epoch += 1
            slot.sid, slot.live, slot.pos, slot.epoch = sid, True, pos, \
                self.epoch
            self._touch(slot)
            self._sync_slots()
        return sid

    # -- introspection -----------------------------------------------------
    def session_ids(self) -> List[str]:
        with self._lock:
            return [s.sid for s in self._slots if s.live]

    def parked_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._parked)

    def slot_info(self, sid: str) -> Slot:
        """A COPY of the session's slot record (pos, epoch, lru stamp)."""
        with self._lock:
            return dataclasses.replace(self._slots[self._slot_index(sid)])

    def logits_for(self, sid: str) -> torch.Tensor:
        with self._lock:
            return self.last_logits[self._slot_index(sid)].clone()

    def tokens_for(self, sid: str) -> torch.Tensor:
        with self._lock:
            j = self._slot_index(sid)
            return self._tokens[j, :self._slots[j].pos].clone()

    # -- batch hand-off primitives ----------------------------------------
    def export_layers(self, lo: int, hi: int) -> Tuple[Dict[str, tuple], int]:
        """Serialize layers [lo, hi) of the WHOLE slot pool: one payload,
        batch axis intact, KV sliced to the max live prefix (rows are
        zero beyond their own pos, so nothing is lost).  Same envelope
        (epoch, pos, crc) and wire format as ``DecodeSession``; entries on
        a mesh are gathered whole first."""
        u0 = unit_index_of_split(self.cfg, lo)
        u1 = unit_index_of_split(self.cfg, hi)
        payload: Dict[str, tuple] = {}
        nbytes = 0
        with self._lock:
            pos = max((s.pos for s in self._slots if s.live), default=0)
            for unit in self.runner.units[u0:u1]:
                for k in _unit_state_keys(self.cfg, unit):
                    t = TP.whole(self.cache[k], self.device)
                    cap = t.numel()
                    if _is_kv(k):
                        t = t[:, :, :pos]
                    dtype, shape, buf = _payload_entry(t, cap)
                    payload[k] = (dtype, shape, buf)
                    nbytes += len(buf)
            payload[HANDOFF_META_KEY] = (self.epoch, pos,
                                         payload_checksum(payload))
        return payload, nbytes

    def warm_export(self, lo: int, hi: int) -> int:
        """As ``DecodeSession.warm_export``: the page-locked blocks of an
        export of layers [lo, hi) of the whole pool, taken and cached."""
        u0 = unit_index_of_split(self.cfg, lo)
        u1 = unit_index_of_split(self.cfg, hi)
        with self._lock:
            entries = [self.cache[k] for unit in self.runner.units[u0:u1]
                       for k in _unit_state_keys(self.cfg, unit)]
        return warm_host_blocks(entries)

    def validate_payload(self, payload: Dict[str, tuple]) -> None:
        """Same integrity contract as ``DecodeSession.validate_payload``."""
        meta = payload.get(HANDOFF_META_KEY)
        if meta is None:
            return
        epoch, _pos, crc = meta
        live_epoch = self.epoch
        if epoch != live_epoch:
            raise HandoffCorrupted(f"hand-off epoch {epoch} != manager "
                                   f"epoch {live_epoch}: stale payload")
        actual = payload_checksum(payload)
        if crc != actual:
            raise HandoffCorrupted(f"hand-off checksum mismatch: envelope "
                                   f"{crc:#010x} != bytes {actual:#010x}")

    def import_layers(self, payload: Dict[str, tuple]) -> None:
        """Deserialize a batch export back into the pool, written into
        the state buffers where they lie; validates and fully decodes
        BEFORE committing (corruption leaves the pool pristine for the
        recompute fallback)."""
        self.validate_payload(payload)
        decoded: Dict[str, torch.Tensor] = {}
        try:
            for k, (dtype, shape, buf) in payload.items():
                if k == HANDOFF_META_KEY:
                    continue
                decoded[k] = _from_payload(dtype, shape, buf, self.device)
        except (ValueError, TypeError) as e:
            raise HandoffCorrupted(f"undecodable hand-off entry "
                                   f"{k!r}: {e}") from None
        with self._lock:
            write_imported(self.cache, decoded)

    def recompute_layers(self, lo: int, hi: int) -> None:
        """Rebuild layers [lo, hi) for EVERY slot from the per-slot
        boundary checkpoints: one masked fixed-shape pass with a
        ``(num_slots,)`` length vector — dead slots (length 0) rebuild to
        zero state, live slots to their pre-handoff state."""
        u0 = unit_index_of_split(self.cfg, lo)
        u1 = unit_index_of_split(self.cfg, hi)
        if u0 >= u1:
            return
        r = self.runner
        fn = r.recompute_fn(u0, u1)          # runner lock first (42 < 47)
        with self.arena.use((u0, u1)), \
                timing.span("handoff.recompute") as sp:
            with self._lock:
                x0 = self._bounds[u0]                    # (B, max_seq, D)
                lengths = self._pos_dev.clone()
                sp.set(rows=self.num_slots * self.max_seq,
                       live_rows=sum(s.pos for s in self._slots if s.live))
            caches = fn(r.params, x0, lengths)
            with self._lock:
                write_state(self.cache, caches)
            synchronize(self.device)

    def warm_recompute(self, a: int, b: int) -> None:
        """Run the re-prefill of the layers between splits ``a`` and ``b``
        once on zeros at the live lengths in the manager's
        ``RecomputeArena`` and drop its result (the state is not touched),
        as ``DecodeSession.warm_recompute`` does for a standby build.  The
        zero input is taken outside the arena: the hand-off reads the
        boundary buffer in place, so the arena sees the same allocations
        in both."""
        u0 = unit_index_of_split(self.cfg, min(a, b))
        u1 = unit_index_of_split(self.cfg, max(a, b))
        if u0 >= u1 or self.pos == 0:
            return
        r = self.runner
        fn = r.recompute_fn(u0, u1)
        with self._lock:
            x = torch.zeros_like(self._bounds[u0])

        def run():
            with self._lock:
                lengths = self._pos_dev.clone()
            fn(r.params, x, lengths)
            synchronize(self.device)
        self.arena.warm((u0, u1), run)

    # -- local decode (no edge/cloud split) -------------------------------
    def decode_step(self) -> torch.Tensor:
        """One full-range decode step advancing every live slot — the
        ``BatchingServer`` path, no pipeline split.  Returns the
        ``(num_slots, 1)`` committed tokens."""
        r = self.runner
        U = len(r.units)
        if self.pos >= self.max_seq:
            raise RuntimeError(f"decode context full ({self.pos} >= "
                               f"max_seq {self.max_seq})")
        if self._step_fn is None:
            cfg = self.cfg
            decode = r._make_decode_fn(0, U)

            def step(params, tok, cache, pos):
                x = params["embed"][tok]
                x, new, b = decode(params, x, cache, pos)
                h = T._apply_norm(cfg, params["final_norm"], x)
                logits = (h[:, -1] @ T.lm_head_weights(cfg, params)).float()
                return logits, new, b

            self._step_fn = step
        token = self.next_token()
        cache = {k: TP.whole(v, self.device)
                 for k, v in self.subset(0, U).items()}
        logits, new, b = self._step_fn(r.params, token, cache,
                                       self.step_pos())
        self.commit_step(token, new, b, logits)
        return token

    # -- test/benchmark support -------------------------------------------
    def snapshot(self) -> dict:
        """A copy of the whole pool (copies: decode writes in place; an
        entry on a mesh is copied shard by shard, and restored so)."""
        with self._lock:
            return {"cache": {k: v.clone() for k, v in self.cache.items()},
                    "tokens": self._tokens.clone(),
                    "bounds": self._bounds.clone(),
                    "logits": self.last_logits.clone(),
                    "slots": [dataclasses.replace(s) for s in self._slots],
                    "parked": dict(self._parked),
                    "epoch": self.epoch, "clock": self._clock}

    def restore(self, snap: dict) -> None:
        dev = self.device
        with self._lock:
            self.cache = {k: v.clone() if isinstance(v, TP.ShardedTensor)
                          else v.to(dev).clone()
                          for k, v in snap["cache"].items()}
            self._tokens = snap["tokens"].to(dev).clone()
            self._bounds = snap["bounds"].to(dev).clone()
            self.last_logits = snap["logits"].to(dev).clone()
            self._slots = [dataclasses.replace(s) for s in snap["slots"]]
            self._parked = dict(snap["parked"])
            self.epoch, self._clock = snap["epoch"], snap["clock"]
            self._sync_slots()


def make_session_manager(cfg: ArchConfig, params=None, *, split: int,
                         net: NetworkModel, num_slots: int,
                         max_seq: int = 128, seed: int = 0,
                         standby_split: Optional[int] = None,
                         warm_standbys: bool = False,
                         force_mode: Optional[str] = None,
                         mem_budget_bytes: Optional[int] = None,
                         session_budget_bytes: Optional[int] = None,
                         decode_impl: str = "auto", rolled: bool = True,
                         attn_impl: str = "chunked", device="cuda",
                         dtype: torch.dtype = torch.float32,
                         checkpoint_path: Optional[str] = None):
    """A ``PipelineManager`` whose pool serves a SLOT POOL of decode
    sessions.  Mirrors ``make_stateful_manager`` but seats a
    ``SessionManager`` (initially empty — ``admit`` sessions, then
    ``repartition``).  Returns ``(manager, session_manager)``.

    Without ``params``, weights come from ``init_model`` seeded with
    ``seed``, in ``dtype``.  ``attn_impl`` is the runner's full-sequence
    attention (the admission prefill and the recompute arm: ``"kernel"``
    puts both on the flash-attention kernel); ``checkpoint_path`` is the
    checkpoint pause_resume reloads (written lazily when not given).
    ``device`` defaults to the card."""
    from repro_torch.core.stateful import StatefulPipelinePool
    from repro_torch.core.switching import PipelineManager
    dev = resolve_device(device)
    freeze_startup_heap()       # once a process, before the first model
    if params is None:
        params = T.init_model(cfg, dtype=dtype, device=dev, seed=seed)
    runner = StatefulStageRunner(cfg, params, max_seq=max_seq,
                                 attn_impl=attn_impl,
                                 decode_impl=decode_impl, rolled=rolled,
                                 device=dev)
    sm = SessionManager(runner, num_slots=num_slots,
                        mem_budget_bytes=session_budget_bytes)
    pool = StatefulPipelinePool(runner, net, {"tokens": None},
                                session=sm, force_mode=force_mode,
                                warm_standbys=warm_standbys,
                                mem_budget_bytes=mem_budget_bytes,
                                checkpoint_path=checkpoint_path)
    mgr = PipelineManager(runner, split, net, {"tokens": None},
                          pool=pool, standby_split=standby_split)
    return mgr, sm
