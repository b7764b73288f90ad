"""The dry run: every (arch x input-shape) pair counted against the
production mesh with meta-tensor stand-ins (no storage, no card), one
three-term roofline record per pair, priced on the H100.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each pair's step for a 256- or 512-chip TPU mesh and reads the compiled
HLO.  Eager PyTorch has neither a partitioner nor HLO, so each pair's
step (``training.steps``' train, prefill or serve step, at the global
batch) runs once on the meta device under ``distributed.op_analysis``'s
counter, and the mesh enters through the port's sharding rules:

* flops: the counted step (global, as the reference's per-device count
  times the chips), counted at two or three shallow depths and extended
  layer by layer (``counted_totals``: the layers dispatch alike, as the
  reference multiplies a loop body by its trip count);
* bytes: the counted step, plus the weights every further data-parallel
  replica reads (the step on one device reads each weight once; on the
  mesh each replica reads its own);
* per-device bytes: each argument leaf (params, the optimizer's moments
  in train, inputs, the decode cache) over the product of the mesh axes
  its spec names, the step's new outputs over the data axes, and the
  counted peak of live temporaries over the chips (an estimate);
* collectives, derived from the layout because no partitioner reports
  them: the tensor-parallel executor's all-reduces a layer
  (``distributed.tp``: 2 a dense, MoE or shared-attention layer, 3 a
  whisper decoder layer, Mamba's own two) at the per-device batch, the
  FSDP weight all-gathers a forward (again for remat and the backward),
  and in train the gradients' reduce-scatter (all-reduce for replicated
  leaves) over the data axes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Runs on the CPU; nothing is allocated.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, InputShape,
                                 get_config, get_shape, pair_is_runnable)
from repro_torch.core.timing import Stopwatch
from repro_torch.distributed import policy as pol
from repro_torch.distributed import tp as TP
from repro_torch.distributed.op_analysis import COLLECTIVE_OPS, OpCounter
from repro_torch.distributed.roofline import Roofline, model_flops_estimate
from repro_torch.distributed.sharding import (cache_shardings,
                                              input_shardings,
                                              map_with_path,
                                              param_shardings,
                                              should_shard_fsdp_serving)
from repro_torch.launch.mesh import CloudMesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.specs import input_specs
from repro_torch.training.steps import (make_prefill_step, make_serve_step,
                                        make_train_step)

DTYPE = torch.bfloat16
DEFAULT_OUT = "experiments/dryrun_torch"


# ---------------------------------------------------------------------------
# the mesh's share of a tree
# ---------------------------------------------------------------------------

def _spec_axes(spec) -> set:
    out = set()
    for ax in spec:
        if isinstance(ax, tuple):
            out.update(ax)
        elif ax is not None:
            out.add(ax)
    return out


def per_device_bytes(tree, specs, mesh: CloudMesh,
                     itemsize: Optional[int] = None) -> int:
    """Bytes of ``tree`` on one device: each leaf over the product of the
    mesh axes its spec names (``itemsize`` in place of the leaves' own
    element size, e.g. 4 for f32 moments of bf16 weights)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    by_path = _by_path(specs)
    total = 0

    def leaf(path, t):
        nonlocal total
        n = t.numel() * (itemsize or t.element_size())
        total += n // math.prod(sizes[a] for a in _spec_axes(by_path[path]))
        return t
    map_with_path(leaf, tree)
    return total


def _by_path(specs) -> dict:
    out = {}
    map_with_path(lambda path, s: out.__setitem__(path, s), specs)
    return out


# ---------------------------------------------------------------------------
# derived collectives
# ---------------------------------------------------------------------------

def layer_all_reduces(cfg, tp: int, rows: int, *, itemsize: int = 2,
                      layers=None, encoder_rows: int = 0) -> Tuple[int, int]:
    """``(count, bytes)`` of the all-reduces ``distributed.tp``'s executor
    issues for decoder layers ``layers`` (all by default; a hybrid's
    shared block with the layer it follows) over ``rows`` hidden rows of
    ``itemsize`` bytes, and whisper's encoder layers over
    ``encoder_rows`` (the executor keeps the encoder on the edge; a
    sharded step runs it on the mesh).  Each all-reduce's bytes are one
    copy of the reduced tensor; a block its layout replicates issues
    none."""
    lay = TP.tp_layout(cfg, tp)
    hidden = rows * cfg.d_model * itemsize
    count = nbytes = 0

    def add(n_bytes: int) -> None:
        nonlocal count, nbytes
        count += 1
        nbytes += n_bytes
    mlp_sharded = (lay.experts is not None or lay.expert_ff is not None
                   or lay.shared_ff is not None) if cfg.family == "moe" \
        else lay.ff is not None
    for li in (range(cfg.num_layers) if layers is None else layers):
        if cfg.ssm is not None:
            if lay.mamba is not None:
                s = cfg.ssm
                if s.kind == "mamba1":       # x_proj's outputs
                    add(rows * (s.dt_rank + 2 * s.d_state) * itemsize)
                else:                        # the gated norm's f32 sums
                    add(rows * 4)
                add(hidden)                  # out_proj
            if cfg.family == "hybrid" and cfg.hybrid_period \
                    and (li + 1) % cfg.hybrid_period == 0:
                if lay.heads is not None:
                    add(hidden)
                if lay.ff is not None:
                    add(hidden)
            continue
        if lay.heads is not None:
            add(hidden)
        if mlp_sharded:
            add(hidden)
        if cfg.family == "audio" and lay.heads is not None:
            add(hidden)                      # cross attention
    if cfg.family == "audio" and encoder_rows:
        enc = encoder_rows * cfg.d_model * itemsize
        for _ in range(cfg.encoder.num_layers):
            if lay.heads is not None:
                add(enc)
            if lay.ff is not None:
                add(enc)
    return count, nbytes


def derived_collectives(cfg, shape, mesh: CloudMesh, params, p_specs, *,
                        shard_fsdp: bool, remat: bool) -> Dict[str, dict]:
    """Per-device ``{"by_kind", "counts"}`` of one step on ``mesh``
    (module docstring); multiply the bytes by the chips for the global
    figure."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    tp = sizes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = math.prod(sizes[a] for a in dp_axes)
    B = shape.global_batch
    b_dev = B // dp if B >= dp and B % dp == 0 else B
    passes = 1
    if shape.kind == "train":
        passes = 3 if remat else 2           # forward, remat, backward
    by_kind = {k: 0 for k in COLLECTIVE_OPS}
    counts = {k: 0 for k in COLLECTIVE_OPS}
    if tp > 1:
        if shape.kind == "decode":
            n, b = layer_all_reduces(cfg, tp, b_dev)
        else:
            enc = b_dev * cfg.encoder.context_len \
                if cfg.family == "audio" else 0
            n, b = layer_all_reduces(cfg, tp, b_dev * shape.seq_len,
                                     encoder_rows=enc)
        by_kind["all-reduce"] += passes * b
        counts["all-reduce"] += passes * n
    specs = _by_path(p_specs)
    gathered = scattered = replicated = 0
    n_sharded = n_replicated = 0

    def leaf(path, t):
        nonlocal gathered, scattered, replicated, n_sharded, n_replicated
        axes = _spec_axes(specs[path])
        size = t.numel() * t.element_size()
        fsdp = axes & set(dp_axes)
        if fsdp:
            # gathered over the data axes, still cut over the rest
            gathered += size // math.prod(sizes[a] for a in axes - fsdp)
            scattered += size // math.prod(sizes[a] for a in axes)
            n_sharded += 1
        else:
            replicated += size // math.prod(sizes[a] for a in axes)
            n_replicated += 1
        return t
    map_with_path(leaf, params)
    if shard_fsdp and dp > 1:
        by_kind["all-gather"] += passes * gathered
        counts["all-gather"] += passes * n_sharded
    if shape.kind == "train" and dp > 1:
        by_kind["reduce-scatter"] += scattered
        counts["reduce-scatter"] += n_sharded
        by_kind["all-reduce"] += replicated
        counts["all-reduce"] += n_replicated
    return {"by_kind": by_kind, "counts": counts}


# ---------------------------------------------------------------------------
# one pair
# ---------------------------------------------------------------------------

def _leaves(tree):
    out = []
    map_with_path(lambda _, t: out.append(t), tree)
    return out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


# the counter's readings that grow with the depth
LINEAR = ("flops", "bytes", "ops", "kernel_flops", "kernel_bytes",
          "peak_live_bytes")


def count_step(cfg, shape, *, remat: bool = True) -> dict:
    """``OpCounter.totals()`` of one step of ``cfg`` at ``shape``'s global
    batch on the meta device: train (with AdamW's update), prefill, or
    one decode token against a full cache."""
    params = T.init_model(cfg, dtype=DTYPE, device="meta")
    specs, cache = input_specs(cfg, shape, dtype=DTYPE)
    if shape.kind == "train":
        step, init_opt = make_train_step(cfg, remat=remat)
        opt = init_opt(params)
        with OpCounter() as c:
            step(params, opt, specs)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, shape, remat=remat)
        with OpCounter() as c:
            step(params, specs)
    else:
        step = make_serve_step(cfg, shape)
        with OpCounter() as c:
            step(params, specs["token"], cache)
    return c.totals()


def _at_depth(cfg, layers: int, encoder_layers: Optional[int] = None,
              period: Optional[int] = None):
    kw = {"num_layers": layers}
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(
            cfg.encoder, num_layers=encoder_layers or 1)
    if period is not None:
        kw["hybrid_period"] = period
    return dataclasses.replace(cfg, **kw)


def counted_totals(cfg, shape, *, remat: bool = True) -> dict:
    """``count_step``'s readings at the config's full depth, counted at
    shallow depths and extended layer by layer: the stacked layers
    dispatch the same operators at the same shapes, so a step's count is
    linear in its depth (the loop-aware count; the reference multiplies a
    while body by its trip count).  A hybrid's Mamba-2 layers and its
    shared-block applications (``num_layers // hybrid_period`` of them)
    extend separately, read at one and two layers with the block after
    every layer and at two layers with it after the second; whisper's
    encoder layers extend separately too.  The peak of live temporaries
    is extended the same way, an estimate."""
    def diff(a, b):
        return {k: a[k] - b[k] for k in LINEAR} | {"kernel_calls": {
            n: a["kernel_calls"].get(n, 0) - b["kernel_calls"].get(n, 0)
            for n in set(a["kernel_calls"]) | set(b["kernel_calls"])}}

    def add(a, d, n):
        for k in LINEAR:
            a[k] += n * d[k]
        for name, v in d["kernel_calls"].items():
            a["kernel_calls"][name] = a["kernel_calls"].get(name, 0) + n * v

    def at(*depth, **kw):
        return count_step(_at_depth(cfg, *depth, **kw), shape, remat=remat)
    L = cfg.num_layers
    if cfg.family == "hybrid" and cfg.hybrid_period:
        base = at(1, period=1)              # 1 layer, 1 application
        both = diff(at(2, period=1), base)  # + 1 layer, + 1 application
        layer = diff(at(2, period=2), base)     # + 1 layer
        steps = [(layer, L - 1),
                 (diff(both, layer), L // cfg.hybrid_period - 1)]
    else:
        base = at(1, 1)
        steps = [(diff(at(2, 1), base), L - 1)]
        if cfg.encoder is not None:
            steps.append((diff(at(1, 2), base),
                          cfg.encoder.num_layers - 1))
    out = dict(base, kernel_calls=dict(base["kernel_calls"]))
    for d, n in steps:
        add(out, d, n)
    return out


def count_pair(arch: str, shape_name, *, multi_pod: bool,
               policy: Optional[dict] = None, cfg=None,
               mesh: Optional[CloudMesh] = None) -> dict:
    """Count one pair's step and lay it on the production mesh; the
    readings ``analyse`` prices (the counterpart of the reference's
    ``lower_pair``).  ``shape_name`` names an input shape or is an
    ``InputShape``; ``cfg`` and ``mesh`` replace the arch's config and
    the production mesh (a reduced pair on a small mesh)."""
    policy = policy or {}
    cfg = cfg or get_config(arch)
    if policy.get("moe_cf") is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=policy["moe_cf"]))
    shape = shape_name if isinstance(shape_name, InputShape) \
        else get_shape(shape_name)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    dp_size = math.prod(sizes[a] for a in dp_axes)
    window = T.effective_window(cfg, shape.seq_len)
    attn_mode = policy.get("attn", pol.choose_attn_mode(
        cfg, sizes["model"], kind=shape.kind, windowed=window is not None))
    remat = policy.get("remat", True)
    pol.set_policy(dp=dp, tp="model", attn=attn_mode, tp_size=sizes["model"],
                   dp_size=dp_size,
                   seq_shard_hidden=policy.get("seq_shard_hidden", True))
    try:
        sw = Stopwatch()
        totals = counted_totals(cfg, shape, remat=remat)
        t_count = sw.elapsed()
        params = T.init_model(cfg, dtype=DTYPE, device="meta")
        specs, cache = input_specs(cfg, shape, dtype=DTYPE)
        if shape.kind == "train":
            shard_fsdp = policy.get("train_fsdp", True)
        else:
            shard_fsdp = policy.get("serve_fsdp",
                                    should_shard_fsdp_serving(cfg, mesh))
        p_sh = param_shardings(cfg, mesh, params, shard_fsdp=shard_fsdp)
        per_dev = {"params": per_device_bytes(params, p_sh, mesh),
                   "inputs": per_device_bytes(
                       specs, input_shardings(cfg, mesh, specs, shape), mesh)}
        b_ok = shape.global_batch >= dp_size
        logits = shape.global_batch * cfg.vocab_size * 4 \
            // (dp_size if b_ok else 1)
        if shape.kind == "train":
            # params and moments are written in place; the metrics are
            # scalars
            per_dev["opt_state"] = 2 * per_device_bytes(params, p_sh, mesh,
                                                        itemsize=4)
            per_dev["outputs"] = 0
        else:
            if shape.kind == "prefill":     # the cache it returns
                cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     dtype=DTYPE, window=window,
                                     device="meta")
            cl = min(shape.seq_len, window or shape.seq_len)
            seq_axis = sizes["model"] if b_ok else sizes["model"] * dp_size
            kv_default = "seq" if (cfg.num_kv_heads
                                   and cfg.num_kv_heads % sizes["model"]
                                   and cl >= 128 * seq_axis) else "heads"
            c_bytes = per_device_bytes(cache, cache_shardings(
                cfg, mesh, cache, shape,
                kv_layout=policy.get("kv_layout", kv_default)), mesh)
            if shape.kind == "prefill":
                per_dev["outputs"] = logits + c_bytes
            else:                           # the cache is updated in place
                per_dev["cache"] = c_bytes
                per_dev["outputs"] = logits
        per_dev["temp_estimate"] = totals["peak_live_bytes"] // chips
        coll = derived_collectives(cfg, shape, mesh, params, p_sh,
                                   shard_fsdp=shard_fsdp, remat=remat)
        weights = _tree_bytes(params)
    finally:
        pol.clear_policy()
    return {"cfg": cfg, "shape": shape, "chips": chips, "mesh": mesh,
            "attn_mode": attn_mode, "counter": totals,
            "count_s": t_count, "per_device": per_dev, "coll": coll,
            "weight_bytes": weights, "dp_size": dp_size}


def analyse(arch: str, shape_name: str, meta: dict) -> Roofline:
    """The roofline of one counted pair, priced on the H100."""
    cfg, shape, chips = meta["cfg"], meta["shape"], meta["chips"]
    c, coll = meta["counter"], meta["coll"]
    replicas = meta["dp_size"] - 1
    coll_bytes = sum(coll["by_kind"].values()) * chips
    per_dev = sum(meta["per_device"].values())
    return Roofline(
        arch=arch, shape=shape_name,
        mesh="x".join(str(d) for d in meta["mesh"].shape), chips=chips,
        hlo_flops=float(c["flops"]),
        hlo_bytes=float(c["bytes"] + replicas * meta["weight_bytes"]),
        coll_bytes=float(coll_bytes),
        coll_breakdown={
            "by_kind": {k: v * chips for k, v in coll["by_kind"].items()},
            "counts": coll["counts"], "derived": True,
            "counted_on_one_device": {"by_kind": c["coll_by_kind"],
                                      "counts": c["coll_counts"]}},
        model_flops=model_flops_estimate(cfg, shape),
        per_device_bytes=int(per_dev)).finish()


def run_pair(arch: str, shape_name, *, multi_pod: bool, out_dir: str,
             policy: Optional[dict] = None, tag: str = "", cfg=None,
             mesh: Optional[CloudMesh] = None) -> dict:
    """Count, price and write one pair's record (``count_pair``'s
    overrides pass through); returns the record."""
    meta = count_pair(arch, shape_name, multi_pod=multi_pod, policy=policy,
                      cfg=cfg, mesh=mesh)
    shape_name = meta["shape"].name
    rl = analyse(arch, shape_name, meta)
    rec = rl.to_dict()
    c = meta["counter"]
    rec.update({
        "compile_s": meta["count_s"], "policy": policy or {}, "tag": tag,
        "attn_mode": meta["attn_mode"], "counted": {
            "flops": c["flops"], "bytes": c["bytes"], "ops": c["ops"],
            "kernel_calls": c["kernel_calls"],
            "kernel_flops": c["kernel_flops"],
            "kernel_bytes": c["kernel_bytes"],
            "peak_live_bytes": c["peak_live_bytes"],
            "extended_from_shallow_depths": True,
            "weight_bytes_a_replica": meta["weight_bytes"],
            "data_parallel_replicas": meta["dp_size"]},
        "per_device": meta["per_device"],
        "notes": ["compile_s: seconds the counted step took to dispatch "
                  "on the meta device",
                  "collectives derived from the layout, not counted",
                  "counted at two or three shallow depths and extended "
                  "layer by layer to the full depth",
                  "per_device temp_estimate: the counted peak of live "
                  "temporaries over the chips",
                  "hlo_bytes: eager, unfused operators (an upper bound) "
                  "plus each further data-parallel replica's weight "
                  "reads"]})
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = "multipod" if multi_pod else "pod"
    suffix = f"-{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}--{shape_name}--{mesh_tag}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"OK  {arch:22s} {shape_name:12s} {rec['mesh']:8s} "
          f"count {meta['count_s']:6.1f}s  "
          f"Tc {rl.t_compute * 1e3:8.2f}ms Tm {rl.t_memory * 1e3:8.2f}ms "
          f"Tx {rl.t_collective * 1e3:8.2f}ms  [{rl.bottleneck}] "
          f"useful {rl.useful_flops_frac:.2f} "
          f"mem/dev {(rl.per_device_bytes or 0) / 2**30:.2f}GiB "
          f"({rl.device_spec})", flush=True)
    return rec


def pairs(select_all: bool, arch: Optional[str], shape: Optional[str]):
    """The pairs to run, and the SKIP line of each left out."""
    if not select_all:
        return [(arch, shape)], []
    run, skipped = [], []
    for a in ASSIGNED_ARCHS:
        for s in INPUT_SHAPES:
            ok, note = pair_is_runnable(a, s)
            if ok:
                run.append((a, s))
            else:
                skipped.append(f"SKIP {a:22s} {s:12s} {note}")
    return run, skipped


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--policy-json", default="",
                    help='e.g. {"kv_layout": "seq"}: a variant policy')
    ap.add_argument("--tag", default="", help="suffix for variant records")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    policy = json.loads(args.policy_json) if args.policy_json else None
    todo, skipped = pairs(args.all, args.arch, args.shape)
    for line in skipped:
        print(line, flush=True)
    failures = []
    sw = Stopwatch()
    for a, s in todo:
        mesh_tag = "multipod" if args.multi_pod else "pod"
        path = os.path.join(args.out, f"{a}--{s}--{mesh_tag}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"CACHED {a} {s} {mesh_tag}", flush=True)
            continue
        try:
            run_pair(a, s, multi_pod=args.multi_pod, out_dir=args.out,
                     policy=policy, tag=args.tag)
        except Exception as e:          # report every pair, then fail
            failures.append((a, s, repr(e)))
            print(f"FAIL {a} {s}: {e}", flush=True)
            traceback.print_exc()
    print(f"DONE {len(todo) - len(failures)} of {len(todo)} pairs in "
          f"{sw.elapsed():.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
