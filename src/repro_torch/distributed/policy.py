"""Activation-sharding policy: the process-global state and the choices
made from it.

The counterpart of ``repro/distributed/policy.py``.  The reference
applies its policy through ``constrain_qkv``, ``constrain_attn_out``,
``constrain_hidden`` and ``constrain_moe``: ``with_sharding_constraint``
hints that steer GSPMD's partitioner while it traces.  Eager PyTorch
has no partitioner to hint, so those functions have no counterpart here.
The tensor-parallel executor (``repro_torch.distributed.tp``) takes
their place: it places every shard's tensors itself and issues the
all-reduces explicitly.

What carries over is the policy's state (``set_policy``,
``clear_policy``, the ``policy`` context, ``attn_mode``) and the choices
read from a config: ``choose_attn_mode`` and ``moe_groups``.
"""
from __future__ import annotations

from contextlib import contextmanager

_STATE = {"active": False, "dp": None, "tp": None, "attn": "heads",
          "tp_size": 1, "seq_shard_hidden": True}


def set_policy(*, dp=None, tp=None, attn="heads", active=True, tp_size=1,
               dp_size=1, seq_shard_hidden=True):
    _STATE.update(active=active, dp=dp, tp=tp, attn=attn, tp_size=tp_size,
                  dp_size=dp_size, seq_shard_hidden=seq_shard_hidden)


def clear_policy():
    _STATE.update(active=False, dp=None, tp=None, attn="heads")


@contextmanager
def policy(**kw):
    old = dict(_STATE)
    set_policy(**kw)
    try:
        yield
    finally:
        _STATE.clear()
        _STATE.update(old)


def attn_mode() -> str:
    return _STATE["attn"]


def moe_groups() -> int:
    """Number of local-dispatch groups = data-parallel degree (1 when no
    policy is active)."""
    return max(_STATE.get("dp_size", 1), 1) if _STATE["active"] else 1


def choose_attn_mode(cfg, tp_size: int, kind: str = "train",
                     windowed: bool = False) -> str:
    """``"heads"`` when the kv heads divide tp; otherwise ``"heads"`` for
    WINDOWED inference whose query heads divide tp, and ``"sequence"``
    (context parallelism) for everything else, training included."""
    if cfg.num_kv_heads and cfg.num_kv_heads % tp_size == 0:
        return "heads"
    if kind != "train" and windowed \
            and cfg.num_heads and cfg.num_heads % tp_size == 0:
        return "heads"
    return "sequence"
