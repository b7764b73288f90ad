"""The port's request-stream engine, timeline, clocks and workload
generators (``repro_torch.serving``) against the JAX package's: seeded
multi-client runs on ``SimPool``s and a ``VirtualClock`` serialise
byte-identically, with scripted switches and a slow-cloud fault plan too;
every arrival process draws the same times; the port's ``_smoke`` and
``examples/serve_sessions_torch.py --smoke`` run on the CPU."""
import importlib
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.core.network import NetworkModel as JNet  # noqa: E402
from repro.core.switching import PipelineManager as JManager  # noqa: E402
from repro.serving import clock as JK  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sim as JS  # noqa: E402
from repro.serving import timeline as JTL  # noqa: E402
from repro.serving import workload as JW  # noqa: E402
from repro_torch.core import faults as F  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.switching import PipelineManager  # noqa: E402
from repro_torch.serving import clock as K  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving import sim as S  # noqa: E402
from repro_torch.serving import timeline as TL  # noqa: E402
from repro_torch.serving import workload as W  # noqa: E402

# ``repro.core`` re-exports the function ``faults`` under the module's name
JF = importlib.import_module("repro.core.faults")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = dict(N=NetworkModel, M=PipelineManager, K=K, E=E, S=S, W=W, F=F)
REF = dict(N=JNet, M=JManager, K=JK, E=JE, S=JS, W=JW, F=JF)
ARRIVALS = ["uniform", "poisson", "bursty", "diurnal", "poisson(rate=9.0)",
            "bursty(rate_on=30.0,rate_off=1.0)"]


@pytest.mark.parametrize("spec", ARRIVALS)
@pytest.mark.parametrize("seed", [0, 3, 41])
def test_arrival_processes_equal_reference(spec, seed):
    a = W.get_arrival(spec)
    b = JW.get_arrival(spec)
    assert a.spec == b.spec and a.mean_rate() == b.mean_rate()
    assert list(a.times(12.0, seed=seed, start=0.5)) == \
        list(b.times(12.0, seed=seed, start=0.5))
    assert [W.client_seed(seed, i) for i in range(6)] == \
        [JW.client_seed(seed, i) for i in range(6)]


def test_arrival_registry_and_request_stream_equal_reference():
    assert W.available_arrivals() == JW.available_arrivals()
    assert list(E.request_stream({"x": 1}, fps=3.0, duration=4.0,
                                 start=0.25)) == \
        list(JE.request_stream({"x": 1}, fps=3.0, duration=4.0, start=0.25))


def _sim_run(m, *, arrival, seed, fairness, switches, fault_spec):
    clock = m["K"].VirtualClock(quantum=0.5)
    runner = m["S"].SimRunner(6)
    net = m["N"](20.0)
    plan = m["F"].faults(fault_spec, seed=seed).arm() if fault_spec \
        else None
    pool = m["S"].SimPool(runner, net, build_cost_s=0.25, fault_plan=plan)
    mgr = m["M"](runner, 2, net, None, pool=pool, standby_split=4)
    pool.sim_clock = clock
    eng = m["E"].ServingEngine(mgr, clock=clock, fairness=fairness,
                               fault_plan=plan)
    for t, strategy, split in switches:
        eng.schedule_switch(t, strategy, split)
    weights = [1.0, 2.0, 3.0] if fairness == "weighted" else None
    clients = m["W"].make_clients(3, arrival, {"x": 1}, queue_depth=2,
                                  seed=seed, weights=weights)
    tl = eng.run(clients=clients, duration=10.0)
    mgr.close()
    return tl


@pytest.mark.parametrize("arrival", ["poisson", "bursty", "diurnal"])
@pytest.mark.parametrize("fairness", ["round_robin", "weighted"])
def test_multi_client_timeline_byte_identical_to_reference(arrival,
                                                           fairness):
    kw = dict(arrival=arrival, seed=11, fairness=fairness,
              switches=[(3.0, "switch_a", 4), (6.0, "pause_resume", 1)],
              fault_spec="slow_cloud(factor=3.0,p=0.3)")
    a = _sim_run(PORT, **kw)
    b = _sim_run(REF, **kw)
    assert a.serialize() == b.serialize()
    assert a.summary() == b.summary()
    assert a.client_summary() == b.client_summary()
    assert len(a.windows) == 2 and a.served_count > 0


def test_multi_client_timeline_seed_sensitive():
    kw = dict(arrival="poisson", fairness="round_robin", switches=[],
              fault_spec="")
    assert _sim_run(PORT, seed=1, **kw).serialize() != \
        _sim_run(PORT, seed=2, **kw).serialize()


def test_timeline_metrics_equal_reference():
    """The same records through both packages' ServiceTimeline."""
    out = []
    for mod in (TL, JTL):
        tl = mod.ServiceTimeline()
        for rid in range(12):
            t = 0.25 * rid
            rec = tl.admit(rid, t, client="c" + str(rid % 2))
            if rid in (3, 4):
                tl.drop(rec, "outage")
            else:
                tl.serve(rec, t_start=t + 0.01, t_done=t + 0.05 + 0.01 * rid,
                         split=2, sessions=("s0",) if rid < 6 else
                         ("s0", "s1"))
        tl.record_switch(mod.SwitchWindow(
            t_start=0.7, t_end=1.2, strategy="pause_resume",
            full_outage=True, old_split=2, new_split=1))
        tl.finish(3.0)
        out.append((tl.serialize(), tl.summary(), tl.session_summary(),
                    tl.client_summary(), tl.downtime(),
                    tl.switch_drops(wake=1.0), tl.outage_bounds(),
                    tl.rolling_p99(2.0, 1.0)))
    assert out[0] == out[1]


def _run(args):
    """A CPU child process of the port, two threads (the suite's budget)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable] + args + ["--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_smoke_runs_on_cpu():
    """``python -m repro_torch.serving --smoke``: the measured-stream
    ordering and switch_a's zero drops (``engine._smoke``)."""
    assert "engine-smoke OK" in _run(["-m", "repro_torch.serving",
                                      "--smoke"])


def test_session_example_runs_on_cpu():
    out = _run([os.path.join(ROOT, "examples", "serve_sessions_torch.py"),
                "--smoke"])
    assert "serve_sessions_torch: OK" in out
