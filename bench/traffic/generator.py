"""The one generator of the benchmark's traffic: a mix file's parameters
and the run's seed in, the run's requests or sessions out.

A mix (``bench/traffic/<mix>.json``) is data only.  Its ``kind`` says
what it makes:

* ``requests``: an open loop of stateless requests.  ``arrivals`` names
  a process of ``arrivals.py`` with its parameters; ``prompt`` gives
  ``{"low", "high", "step"}``, lengths log-uniform between ``low`` and
  ``high``, rounded to a multiple of ``step``.
* ``sessions``: a closed loop of ``users`` decode sessions.  ``prompt``
  and ``output`` give log-uniform lengths as above; a prompt and its
  output together fit ``max_seq``.

Gaps and lengths are stratified: every draw takes the same set (the
distribution's quantiles at ``(i + 0.5) / n``) in a random order, so two
draws do the same work, and a random order keeps the bunching of a
random process (exponential gaps in a random order are Poisson arrivals
but for the set's fixed sum).  A ``requests`` mix fixes that order with
its ``schedule_seed``: every run replays the one draw of arrivals and
lengths it gives (in an order of each run's own, the queue's tail swings
from seed to seed with where the bunches fall).  A ``sessions`` mix's
order is the run's.  Token ids, and the requests the check takes, are
drawn from the run's seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from bench.traffic import arrivals as A

# independent draw streams of one seed
_ORDER, _LENGTHS, _TOKENS, _OUTPUTS, _SAMPLE = range(5)


def _log_uniform_quantiles(n: int, low: int, high: int, step: int) -> list:
    a, b = math.log(low), math.log(high)
    out = []
    for i in range(n):
        v = math.exp(a + (i + 0.5) / n * (b - a))
        out.append(int(min(high, max(low, round(v / step) * step))))
    return out


def lengths(spec: dict, n: int, rng) -> list:
    """``n`` log-uniform lengths of ``spec``, in an order ``rng`` draws."""
    vals = _log_uniform_quantiles(n, spec["low"], spec["high"],
                                  spec.get("step", 1))
    return [vals[i] for i in rng.permutation(n)]


@dataclass
class Request:
    index: int
    due: float                 # seconds into the window
    tokens: np.ndarray         # (length,) int64


def requests(mix: dict, seed: int, seconds: float, vocab: int,
             rate: float = None) -> List[Request]:
    """The open loop's requests due in ``[0, seconds)``; ``rate``
    overrides the mix's (the knee sweep)."""
    spec = dict(mix["arrivals"])
    if rate is not None:
        spec["rate"] = rate
    proc = A.make(spec)
    order_seed = mix["schedule_seed"]
    n = max(1, int(proc.mean_rate() * seconds))
    gaps = np.array([proc.gap_quantile((i + 0.5) / n) for i in range(n)])
    gaps = gaps[A.rng_for(order_seed, _ORDER).permutation(n)]
    # the set of gaps fills the window: n arrivals before its close
    due = np.cumsum(gaps * (seconds * n / (n + 1) / gaps.sum()))
    lens = lengths(mix["prompt"], n, A.rng_for(order_seed, _LENGTHS))
    tok = A.rng_for(seed, _TOKENS)
    return [Request(i, float(due[i]),
                    tok.integers(0, vocab, size=lens[i], dtype=np.int64))
            for i in range(n)]


@dataclass
class Session:
    user: int
    round: int
    tokens: np.ndarray         # the prompt, (length,) int64
    n_out: int                 # tokens to decode before it ends


def sessions(mix: dict, seed: int, vocab: int, max_seq: int,
             rounds: int) -> List[List[Session]]:
    """``users`` lists of ``rounds`` sessions, a user's in the order it
    sends them.  Each round's prompts and outputs are the same quantiles,
    dealt to the users in an order the seed draws."""
    users = mix["users"]
    rng_p = A.rng_for(seed, _LENGTHS)
    rng_o = A.rng_for(seed, _OUTPUTS)
    tok = A.rng_for(seed, _TOKENS)
    out: List[List[Session]] = [[] for _ in range(users)]
    for r in range(rounds):
        prompts = lengths(mix["prompt"], users, rng_p)
        outs = lengths(mix["output"], users, rng_o)
        for u in range(users):
            n_out = min(outs[u], max_seq - prompts[u])
            out[u].append(Session(u, r, tok.integers(
                0, vocab, size=prompts[u], dtype=np.int64), n_out))
    return out


def sample_indices(seed: int, n: int, k: int, must: list,
                   groups=None) -> list:
    """``k`` of ``range(n)`` drawn from the seed, ``must`` among them.
    With ``groups`` (a key of each index, a session's user), the draw
    takes one index of each group before a second of any."""
    rng = A.rng_for(seed, _SAMPLE)
    order = [i for i in rng.permutation(n).tolist() if i not in must]
    if groups is not None:
        seen, first, later = {groups[i] for i in must}, [], []
        for i in order:
            (later if groups[i] in seen else first).append(i)
            seen.add(groups[i])
        order = first + later
    return sorted(set(must) | set(order[:max(0, k - len(set(must)))]))
