"""Driver of ``requests`` mixes: an open loop of stateless requests through
the port's edge-cloud pipeline, with scripted live repartitions.

Set-up builds a ``StageRunner`` (the flash-attention kernel on) and a
``PipelineManager`` at the first split, and serves one request of every
prompt length the traffic holds, so nothing is first run inside the
window.  The window is one serving loop: each request is served when it
is due, or as soon as the loop is free after that (``PipelineManager.
serve``, the active ``EdgeCloudPipeline.process``), and each scripted
repartition runs on the loop when it is due (``set_network`` to the
target's link, then ``PipelineManager.repartition``); requests that come
due meanwhile wait.  A request's latency is its completion less its due
time.  Requests still waiting when the window closes are served after it,
up to ``drain_s`` later; one never served is failed.

The link is priced by the program (``NetworkModel``) and never slept: the
pipeline's stage walls are what the card does.  Splits and links come
from the mix, so the controller and partitioner are bypassed.
"""
from __future__ import annotations

import torch

from bench.traffic import generator as G


def schedule(mix: dict, seconds: float, num_layers: int) -> list:
    """The scripted repartitions: ``(due, split, link_mbps)``, alternating
    from the first split to the next."""
    splits = [int(num_layers * f) for f in mix["splits"]]
    links = mix["links_mbps"]
    out, k = [], 0
    t = mix["switch_first_s"]
    while t < seconds:
        j = (k + 1) % len(splits)
        out.append((t, splits[j], links[j]))
        t += mix["switch_every_s"]
        k += 1
    return out


def trace_from(mix: dict, seconds: float) -> float:
    """When the traced stretch starts (``trace_seconds`` long, and never
    past the window's close)."""
    return min(mix["trace_from_s"], seconds / 2)


def run(ctx):
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stages import StageRunner
    from repro_torch.core.switching import PipelineManager

    mix, cfg, dev, rec = ctx.mix, ctx.cfg, ctx.device, ctx.run
    reqs = G.requests(mix, ctx.seed, ctx.seconds, cfg.vocab_size,
                      rate=ctx.rate)
    L = cfg.num_layers
    first = int(L * mix["splits"][0])
    toks = [torch.as_tensor(r.tokens, device=dev)[None] for r in reqs]
    longest = max(range(len(reqs)), key=lambda i: len(reqs[i].tokens))
    sample = set(G.sample_indices(ctx.seed, len(reqs), mix["check_sample"],
                                  [longest]))

    runner = StageRunner(cfg, ctx.params, attn_impl="kernel", device=dev)
    top = torch.zeros((1, mix["prompt"]["high"]), dtype=torch.long,
                      device=dev)
    mgr = PipelineManager(runner, split=first,
                          net=NetworkModel(mix["links_mbps"][0]),
                          sample_inputs={"tokens": top})
    scale = mgr.active.edge_scale
    for n in sorted({len(r.tokens) for r in reqs}):
        mgr.serve({"tokens": torch.zeros((1, n), dtype=torch.long,
                                         device=dev)})
    ctx.sync()

    switches = schedule(mix, ctx.seconds, L)
    t_from = trace_from(mix, ctx.seconds)
    tracer = ctx.tracer
    clock = ctx.start_window()
    served = {}
    i = k = 0
    deadline = ctx.seconds + mix["drain_s"]
    while i < len(reqs) or k < len(switches):
        now = clock()
        tracer.due(now, t_from, mix["trace_seconds"], ctx.seconds)
        if k < len(switches) and now >= switches[k][0]:
            _, split, link = switches[k]
            start = clock()
            mgr.set_network(NetworkModel(link))
            rep = mgr.repartition(mix["strategy"], split)
            ctx.sync()
            end = clock()
            rec.switches.append({
                "kind": "switch", "start": start, "end": end,
                "blocked_s": end - start, "t_build": rep.t_build,
                "moved_bytes": rep.handoff_bytes, "link_mbps": link,
                "old_split": rep.old_split, "new_split": rep.new_split})
            k += 1
            continue
        if i < len(reqs) and reqs[i].due <= now:
            if now > deadline:
                break
            start = clock()
            logits, timing = mgr.serve({"tokens": toks[i]})
            end = clock()
            if i in sample:
                served[i] = logits[0].argmax(-1)
            del logits
            rec.requests.append({
                "kind": "request", "index": i, "due": reqs[i].due,
                "start": start, "end": end, "length": len(reqs[i].tokens),
                "t_edge": timing.t_edge / scale, "t_cloud": timing.t_cloud})
            i += 1
            continue
        nxt = min(reqs[i].due if i < len(reqs) else float("inf"),
                  switches[k][0] if k < len(switches) else float("inf"))
        if tracer.enabled and tracer.host_t0 is None:
            nxt = min(nxt, t_from)
        elif tracer.active:
            nxt = min(nxt, tracer.host_t0 + mix["trace_seconds"],
                      ctx.seconds)
        ctx.sleep_until(nxt)
    if tracer.active:
        tracer.stop()
    ctx.end_window()
    tracer.end()
    rec.attempted = len(reqs)
    rec.failed = len(reqs) - len(rec.requests)
    ctx.note(late_at_close=sum(r["end"] > ctx.seconds
                               for r in rec.requests))
    rec.outputs = {"tokens": {i: toks[i][0] for i in served},
                   "served": {i: v for i, v in served.items()}}
    mgr.close()
    del mgr, runner


def check(ctx, control: bool) -> dict:
    """The widest gap by which the token the program puts first at a
    position lies below the reference's best there, over the sampled
    requests (the longest among them) and every position.  With
    ``control``, the tokens the reference in fp8 puts first are judged in
    the program's place (the program's own reading kept beside)."""
    from bench.reference import control as C
    from bench.reference import ssm as R

    out = ctx.run.outputs
    gaps, cgaps, n = [], [], 0
    for i, toks in out["tokens"].items():
        ref = R.forward_logits(ctx.port, ctx.params, toks)
        gaps.append(C.widest_gap(ref, out["served"][i]))
        n += int(toks.numel())
        if control:
            low = R.forward_logits(ctx.port, ctx.params, toks,
                                   weight=C.low_precision)
            cgaps.append(C.widest_gap(ref, low.argmax(-1)))
            del low
        del ref
    readings = {"widest_gap": max(gaps) if gaps else float("inf"),
                "positions": n,
                "unserved": ctx.run.failed}
    if control:                 # the control in the program's place
        readings["program_gap"] = readings["widest_gap"]
        readings["widest_gap"] = max(cgaps) if cgaps else float("inf")
    return readings
