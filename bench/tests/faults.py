"""Faults planted underneath the timed path, each by pytest's
``monkeypatch``: an answer altered where it is produced, a decode step
that returns its state unchanged, half of the batch's state left out of
a step, a token altered where it is produced."""


def answer_altered(monkeypatch):
    from repro_torch.core.stages import StageRunner
    apply_unit = StageRunner._apply_unit

    def altered(self, params, state, i):
        out = apply_unit(self, params, state, i)
        if "logits" in out:
            out["logits"] = out["logits"].roll(1, -1)
        return out
    monkeypatch.setattr(StageRunner, "_apply_unit", altered)


def _break_step(monkeypatch, keep):
    """Each decode step's state becomes ``keep(before, after)``: in the
    state buffers, where a graph replay or an in-place cache write put
    it, and in the entries the step hands to ``commit_step``.  Of a KV
    entry (``max_seq`` rows along dim 2) only the row each slot's step
    writes, at its position, is kept aside: a copy of the whole cache
    would not fit beside a pool at its cells' size."""
    from repro_torch.core.stateful import StatefulEdgeCloudPipeline, _is_kv
    step = StatefulEdgeCloudPipeline._step

    def rows(v, pos):
        idx = pos.reshape(-1, 1, 1, 1).long()
        return idx.expand(v.shape[0], v.shape[1], 1, v.shape[3])

    def broken(self, token, cache_edge, cache_cloud, pos, *args, **kw):
        cache = {**cache_edge, **cache_cloud}
        before = {k: v.gather(2, rows(v, pos)) if _is_kv(k) else v.clone()
                  for k, v in cache.items()}
        logits, new, bounds, t = step(self, token, cache_edge, cache_cloud,
                                      pos, *args, **kw)
        for k, v in cache.items():
            if _is_kv(k):
                idx = rows(v, pos)
                v.scatter_(2, idx, keep(before[k], v.gather(2, idx)))
                kept = v
            else:
                kept = keep(before[k], new.get(k, v))
                v.copy_(kept)
            if k in new:
                new[k] = kept
        return logits, new, bounds, t
    monkeypatch.setattr(StatefulEdgeCloudPipeline, "_step", broken)


def state_unchanged(monkeypatch):
    _break_step(monkeypatch, lambda old, new: old.clone())


def half_the_batch(monkeypatch):
    def half(old, new):
        out = new.clone()
        out[out.shape[0] // 2:] = old[out.shape[0] // 2:]
        return out
    _break_step(monkeypatch, half)


def token_altered(monkeypatch):
    from repro_torch.serving.sessions import SessionManager
    nxt = SessionManager.next_token
    monkeypatch.setattr(
        SessionManager, "next_token",
        lambda self: (nxt(self) + 1) % self.last_logits.shape[-1])
