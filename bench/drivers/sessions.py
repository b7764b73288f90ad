"""Driver of ``sessions`` mixes: a closed loop of users on a slot pool of
decode sessions, its state handed across every moved split.

Set-up builds the port's slot pool (``make_session_manager``: a
``SessionManager`` of ``slots`` slots at ``max_seq`` behind a stateful
``PipelineManager``, the flash-attention kernel on for admissions and the
recompute arm, ``warm_standbys``), admits every user's first session,
builds the standby the first repartition swaps to (its re-prefill run
once in the pool's recompute arena) and warms the decode step on scratch
state.

The window is one serving loop.  A scripted repartition runs when due
(``set_network`` to the target's link, ``PipelineManager.repartition``;
the hand-off arm is the program's plan's choice).  Otherwise, a session
that has decoded its output is evicted (``SessionManager.evict``);
otherwise a user waiting for its next session is admitted (``admit``),
but only once no standby build is in flight; otherwise the pool takes one
decode step of every slot (``PipelineManager.serve``).  Tokens count when
their step ends inside the window.

A switch_a repartition re-arms its standby on the program's build thread,
which copies the weights while the loop serves.  An admission's prefill
landing beside that copy raised the window's allocation peak by about
0.6-0.9 GiB on a 7B model, in some runs and not others of one seed:
a race of two host threads, not a property of the traffic.  Admissions
therefore wait for the re-arm to land, and the window's peak is the
re-arm's own, every run.  The wait of each admission is recorded.
"""
from __future__ import annotations

import torch

from bench.drivers.requests import schedule, trace_from
from bench.traffic import generator as G


def run(ctx):
    from repro_torch.core.network import NetworkModel
    from repro_torch.serving.sessions import make_session_manager

    mix, cfg, dev, rec = ctx.mix, ctx.cfg, ctx.device, ctx.run
    users, slots, max_seq = mix["users"], mix["slots"], mix["max_seq"]
    if slots < users:
        raise ValueError(f"{users} users need {users} slots, not {slots}")
    plan = G.sessions(mix, ctx.seed, cfg.vocab_size, max_seq, mix["rounds"])
    L = cfg.num_layers
    splits = [int(L * f) for f in mix["splits"]]
    mgr, sm = make_session_manager(
        cfg, ctx.params, split=splits[0],
        net=NetworkModel(mix["links_mbps"][0]), num_slots=slots,
        max_seq=max_seq, warm_standbys=True, attn_impl="kernel",
        device=dev, dtype=ctx.params["embed"].dtype)

    def prompt(s):
        return torch.as_tensor(s.tokens, device=dev)

    live = {}                   # user -> [sid, session, served, switches]
    for u in range(users):
        live[u] = [sm.admit(prompt(plan[u][0])), plan[u][0], 0, 0]
    ctx.note(state_bytes=sm.state_bytes())
    mgr.build_standby(splits[1 % len(splits)])
    mgr.active.warm()
    ctx.sync()

    switches = schedule(mix, ctx.seconds, L)
    t_from = trace_from(mix, ctx.seconds)
    tracer = ctx.tracer
    finished, waiting = [], []      # waiting: (user, session, since)
    rises, hi = [], [0]

    def peak_rise(kind, start, pending):
        """Which event raised the window's allocation peak (host-side
        bookkeeping, no sync), and the builds in flight as it began."""
        if ctx.cuda:
            p = torch.cuda.max_memory_allocated(dev)
            if p > hi[0] + 2 ** 26:
                hi[0] = p
                rises.append([kind, round(start, 3), round(p / 2 ** 30, 4),
                              pending])

    clock = ctx.start_window()
    k = 0
    while True:
        now = clock()
        if now >= ctx.seconds:
            break
        tracer.due(now, t_from, mix["trace_seconds"], ctx.seconds)
        pending = mgr.pool.pending_builds()
        if k < len(switches) and now >= switches[k][0]:
            _, split, link = switches[k]
            lengths = [len(v[1].tokens) + v[2] for v in live.values()]
            n_before = len(mgr.pool.handoffs)
            start = clock()
            mgr.set_network(NetworkModel(link))
            rep = mgr.repartition(mix["strategy"], split)
            ctx.sync()
            end = clock()
            hand = mgr.pool.handoffs[n_before:]
            rec.switches.append({
                "kind": "switch", "start": start, "end": end,
                "blocked_s": end - start,
                "link_s": rep.handoff_bytes * 8 / (link * 1e6),
                "handoff_wall_s": sum(h.t_wall for h in hand),
                "mode": rep.handoff_mode, "moved_bytes": rep.handoff_bytes,
                "old_split": rep.old_split, "new_split": rep.new_split})
            if rep.handoff_mode == "recompute":
                rec.recomputes.append({
                    "kind": "recompute", "start": start, "end": end,
                    "lo": min(rep.old_split, rep.new_split),
                    "hi": max(rep.old_split, rep.new_split),
                    "lengths": lengths})
            peak_rise("switch", start, pending)
            for v in live.values():
                v[3] += 1
            k += 1
            continue
        done = [u for u, v in live.items() if v[2] >= v[1].n_out]
        if done:
            u = done[0]
            sid, sess, served, moved = live.pop(u)
            start = clock()
            toks = sm.tokens_for(sid)
            sm.evict(sid)
            ctx.sync()
            end = clock()
            rec.evicts.append({"kind": "evict", "start": start, "end": end})
            peak_rise("evict", start, pending)
            finished.append({"user": u, "prompt": len(sess.tokens),
                             "tokens": toks, "served": served,
                             "switches": moved})
            waiting.append((u, plan[u][(sess.round + 1) % len(plan[u])],
                            end))
            continue
        if waiting and (not pending or not live):
            if pending:         # nothing left to decode: wait for the build
                mgr.drain()
            u, nxt, since = waiting.pop(0)
            start = clock()
            live[u] = [sm.admit(prompt(nxt)), nxt, 0, 0]
            end = clock()
            rec.admits.append({"kind": "admit", "start": start, "end": end,
                               "length": len(nxt.tokens),
                               "waited_s": start - since})
            peak_rise("admit", start, pending)
            continue
        positions = [len(v[1].tokens) + v[2] for v in live.values()]
        start = clock()
        mgr.serve(None)
        end = clock()
        rec.steps.append({"kind": "step", "start": start, "end": end,
                          "positions": positions})
        peak_rise("step", start, pending)
        if end <= ctx.seconds:
            rec.tokens += len(positions)
        for v in live.values():
            v[2] += 1
    if tracer.active:
        tracer.stop()
    ctx.end_window()
    waits = [a["waited_s"] for a in rec.admits]
    ctx.note(peak_rises=rises[-4:],
             admit_wait_max_s=max(waits, default=0.0))
    tracer.end()
    for u, (sid, sess, served, moved) in live.items():
        if served:
            finished.append({"user": u, "prompt": len(sess.tokens),
                             "tokens": sm.tokens_for(sid), "served": served,
                             "switches": moved})
    rec.attempted = len(finished)
    rec.failed = 0
    longest = max(range(len(finished)), key=lambda i: finished[i]["served"])
    pick = G.sample_indices(ctx.seed, len(finished), mix["check_sample"],
                            [longest], [f["user"] for f in finished])
    rec.outputs = {"sessions": [finished[i] for i in pick]}
    mgr.close()
    del mgr, sm


def check(ctx, control: bool) -> dict:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position, over the sampled sessions (the
    one that served most among them, the others of distinct users, so of
    distinct slots), each run once over its prompt and served tokens.
    With ``control``, the tokens the reference in fp8 puts first are
    judged in the program's place (the program's own reading kept
    beside)."""
    from bench.reference import control as C
    R = ctx.family("reference")

    gaps, cgaps, n = [], [], 0
    for s in ctx.run.outputs["sessions"]:
        seq, P = s["tokens"], s["prompt"]
        ref = R.forward_logits(ctx.port, ctx.params, seq[:-1])[P - 1:]
        gaps.append(C.widest_gap(ref, seq[P:]))
        n += int(seq.numel()) - P
        if control:
            low = R.forward_logits(ctx.port, ctx.params, seq[:-1],
                                   weight=C.low_precision)[P - 1:]
            cgaps.append(C.widest_gap(ref, low.argmax(-1)))
            del low
        del ref
    readings = {"widest_gap": max(gaps) if gaps else float("inf"),
                "served_tokens": n,
                "handoffs_spanned": max((s["switches"] for s in
                                         ctx.run.outputs["sessions"]),
                                        default=0)}
    if control:                 # the control in the program's place
        readings["program_gap"] = readings["widest_gap"]
        readings["widest_gap"] = max(cgaps) if cgaps else float("inf")
    return readings
