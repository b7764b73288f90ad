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


def _break_commit(monkeypatch, keep):
    from repro_torch.serving.sessions import SessionManager
    commit = SessionManager.commit_step

    def broken(self, token, new_state, bounds, logits):
        new_state = {k: keep(self.cache[k], v) for k, v in new_state.items()}
        return commit(self, token, new_state, bounds, logits)
    monkeypatch.setattr(SessionManager, "commit_step", broken)


def state_unchanged(monkeypatch):
    _break_commit(monkeypatch, lambda old, new: old.clone())


def half_the_batch(monkeypatch):
    def half(old, new):
        out = new.clone()
        out[out.shape[0] // 2:] = old[out.shape[0] // 2:]
        return out
    _break_commit(monkeypatch, half)


def token_altered(monkeypatch):
    from repro_torch.serving.sessions import SessionManager
    nxt = SessionManager.next_token
    monkeypatch.setattr(
        SessionManager, "next_token",
        lambda self: (nxt(self) + 1) % self.last_logits.shape[-1])
