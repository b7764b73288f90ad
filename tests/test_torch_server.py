"""The port's ``BatchingServer`` (``repro_torch.serving.server``): it
decodes a ragged batch to the same tokens as the JAX package's server on
the same weights, stops decoding once every request is done, and a batch
exported mid-stream resumes on another server to the same tokens as an
uninterrupted run."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import BatchingServer as JServer  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import BatchingServer, Request, state_nbytes  # noqa: E402


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=2)
    tcfg = dataclasses.replace(tget("qwen2.5-3b").reduced(), num_layers=2)
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, from_numpy(jax.tree.map(np.asarray, params))


def _prompts(vocab, n=3):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (6 + i,)).astype(np.int32)
            for i in range(n)]


def test_batching_server_decodes_like_reference(weights):
    cfg, tcfg, params, tparams = weights
    prompts = _prompts(cfg.vocab_size)
    out = BatchingServer(tcfg, tparams, max_seq=64, device="cpu").run_batch(
        [Request(rid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])
    ref = JServer(cfg, params, max_seq=64).run_batch(
        [JRequest(rid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])
    assert set(out) == {0, 1, 2}
    assert all(len(v) == 5 for v in out.values())
    assert all(0 <= t < tcfg.vocab_size for v in out.values() for t in v)
    assert out == {k: [int(t) for t in v] for k, v in ref.items()}


def test_batching_server_breaks_decode_loop_when_all_done(weights):
    """Resumed requests arriving with partial output must not burn the
    full ``steps - 1`` decode iterations once every request is done."""
    _, tcfg, _, tparams = weights
    srv = BatchingServer(tcfg, tparams, max_seq=64, device="cpu")
    calls = {"n": 0}
    real_decode = srv._decode

    def counting_decode(*a, **kw):
        calls["n"] += 1
        return real_decode(*a, **kw)

    srv._decode = counting_decode
    p0, p1 = _prompts(tcfg.vocab_size, 2)
    reqs = [Request(rid=0, prompt=p0, max_new_tokens=8, output=[1] * 7),
            Request(rid=1, prompt=p1, max_new_tokens=8, output=[2] * 8)]
    out = srv.run_batch(reqs)
    assert calls["n"] == 0          # prefill finished both; loop broke out
    assert len(out[0]) == 8 and out[1] == [2] * 8


def test_export_import_state_resumes_mid_stream(weights):
    _, tcfg, _, tparams = weights
    prompts = _prompts(tcfg.vocab_size)

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=7)
                for i, p in enumerate(prompts)]

    whole = BatchingServer(tcfg, tparams, max_seq=64,
                           device="cpu").run_batch(reqs())
    first = BatchingServer(tcfg, tparams, max_seq=64, device="cpu")
    batch = reqs()
    partial = first.run_batch(batch, max_steps=2)
    assert all(len(v) == 3 for v in partial.values())
    state = first.export_state(batch)
    assert all(t.device.type == "cpu" for t in state["cache"].values())
    assert state_nbytes(state) > 0
    second = BatchingServer(tcfg, tparams, max_seq=64, device="cpu")
    resumed = second.import_state(state)
    assert second.run_batch(resumed, resume=True) == whole


def test_server_rejects_encoder_frontends(weights):
    _, tcfg, _, tparams = weights
    with pytest.raises(NotImplementedError):
        BatchingServer(dataclasses.replace(tcfg, frontend="vision"), tparams,
                       device="cpu")
