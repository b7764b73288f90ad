"""Hand-off payloads of the port's slot pool and decode session: an
export's buffers are its host copy itself (``HostBuffer``, read-only, no
copy into fresh pageable pages), the envelope stays the reference's
``(dtype, shape, buffer)`` + ``(epoch, pos, crc32)``, so the JAX package's
``payload_checksum``, ``validate_payload`` and ``import_layers`` take a
port payload, and a parked session keeps ``bytes`` of its own."""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.network import NetworkModel as JNet  # noqa: E402
from repro.core.stateful import payload_checksum as jax_checksum  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.sessions import \
    make_session_manager as jax_session_manager  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.faults import faults  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.stateful import (HANDOFF_META_KEY,  # noqa: E402
                                       HandoffCorrupted, HostBuffer,
                                       make_stateful_manager,
                                       payload_checksum)
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import make_session_manager  # noqa: E402

MAX_SEQ = 32
KW = dict(split=1, num_slots=4, max_seq=MAX_SEQ, force_mode="transfer")


@pytest.fixture(scope="module")
def pools():
    """Both packages' 4-slot pools on the same weights (reduced
    qwen2.5-3b, 2 layers, f32), the same three sessions admitted and two
    decode steps taken on the JAX pool's tokens."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=2)
    tcfg = dataclasses.replace(tget("qwen2.5-3b").reduced(), num_layers=2)
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    jm, jsm = jax_session_manager(cfg, params, net=JNet(1000.0), **KW)
    tm, tsm = make_session_manager(
        tcfg, from_numpy(jax.tree.map(np.asarray, params)),
        net=NetworkModel(1000.0), device="cpu", **KW)
    rng = np.random.default_rng(1)
    for i, n in enumerate((7, 3, 12)):
        p = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        jsm.admit(p, sid=f"s{i}")
        tsm.admit(p, sid=f"s{i}")
    for _ in range(2):
        tok = np.asarray(jsm.next_token())
        jm.active.process({"token": tok})
        tm.active.process({"token": tok})
    yield (jm, jsm), (tm, tsm)
    jm.close()
    tm.close()


def test_slot_pool_payload_round_trips_bit_exactly(pools):
    _, (_, tsm) = pools
    L = tsm.cfg.num_layers
    before = {k: v.clone() for k, v in tsm.cache.items()}
    payload, nbytes = tsm.export_layers(0, L)
    entries = {k: v for k, v in payload.items() if k != HANDOFF_META_KEY}
    assert entries and all(isinstance(buf, HostBuffer)
                           for _, _, buf in entries.values())
    assert nbytes == sum(len(buf) for _, _, buf in entries.values())
    for dtype, shape, buf in entries.values():
        view = memoryview(buf)
        assert view.readonly and view.nbytes == len(buf)
        assert np.frombuffer(buf, dtype).size == int(np.prod(shape))
    tsm.import_layers(payload)
    for k, v in tsm.cache.items():
        assert torch.equal(v, before[k]), k


def test_payload_checksum_and_reference_validation(pools):
    """The port's envelope is the reference's: its ``payload_checksum``
    over the same entries, its slot pool's ``validate_payload`` and
    ``import_layers`` accept the payload, and the bytes it imports are
    the port's state."""
    (_, jsm), (_, tsm) = pools
    L = tsm.cfg.num_layers
    payload, _ = tsm.export_layers(0, L)
    crc = payload[HANDOFF_META_KEY][2]
    assert crc == payload_checksum(payload) == jax_checksum(payload)
    assert crc == jax_checksum({k: (d, s, bytes(b)) for k, (d, s, b) in
                                payload.items() if k != HANDOFF_META_KEY})
    assert jsm.epoch == tsm.epoch
    jsm.validate_payload(payload)
    jsm.import_layers(payload)
    for k, v in tsm.cache.items():
        np.testing.assert_array_equal(np.asarray(jsm.cache[k]), v.numpy(),
                                      err_msg=k)


def test_payload_owns_its_host_memory_and_detects_corruption(pools):
    """The export copies: a decode step after it leaves the payload's
    bytes (and its checksum) as exported; a corrupted or truncated
    buffer is still refused."""
    (jm, jsm), (tm, tsm) = pools
    L = tsm.cfg.num_layers
    payload, _ = tsm.export_layers(0, L)
    snap = {k: bytes(b) for k, (_, _, b) in payload.items()
            if k != HANDOFF_META_KEY}
    tok = np.asarray(jsm.next_token())
    jm.active.process({"token": tok})
    tm.active.process({"token": tok})
    assert all(bytes(payload[k][2]) == b for k, b in snap.items())
    assert payload[HANDOFF_META_KEY][2] == payload_checksum(payload)
    for mode in ("flip", "truncate"):
        bad, _ = tsm.export_layers(0, L)
        plan = faults(f"handoff_corrupt(p=1.0,mode='{mode}')", seed=0).arm()
        plan.mutate_handoff(bad, epoch=tsm.epoch)
        with pytest.raises(HandoffCorrupted):
            tsm.import_layers(bad)


def test_parked_session_owns_its_bytes(pools):
    """A parked session keeps ``bytes`` of its own: hand-offs, steps and
    an admission that reuse the pool's buffers and host blocks after the
    eviction leave it intact, and it readmits bit-exactly."""
    (jm, jsm), (tm, tsm) = pools
    L = tsm.cfg.num_layers
    sid = "s1"
    want_logits = tsm.logits_for(sid)
    want_tokens = tsm.tokens_for(sid)
    tsm.evict(sid)
    parked = tsm._parked[sid]["state"]
    assert all(isinstance(buf, bytes) for _, _, buf in parked.values())
    snap = {k: bytes(buf) for k, (_, _, buf) in parked.items()}
    for _ in range(2):
        payload, _ = tsm.export_layers(0, L)
        tsm.import_layers(payload)
        tm.active.process({"token": tsm.next_token()})
    tsm.admit(np.arange(5, dtype=np.int32), sid="other")
    assert {k: bytes(buf) for k, (_, _, buf) in parked.items()} == snap
    tsm.evict("other")
    tsm.readmit(sid)
    assert torch.equal(tsm.logits_for(sid), want_logits)
    assert torch.equal(tsm.tokens_for(sid), want_tokens)


def test_decode_session_export_shares_the_host_buffers():
    cfg = dataclasses.replace(tget("qwen2.5-3b").reduced(), num_layers=2)
    mgr, s = make_stateful_manager(cfg, split=1, net=NetworkModel(20.0),
                                   prompt_len=6, max_seq=MAX_SEQ,
                                   device="cpu")
    mgr.active.process()
    before = {k: v.clone() for k, v in s.cache.items()}
    payload, nbytes = s.export_layers(0, 2)
    bufs = [b for k, (_, _, b) in payload.items() if k != HANDOFF_META_KEY]
    assert bufs and all(isinstance(b, HostBuffer) for b in bufs)
    assert nbytes == sum(len(b) for b in bufs)
    crc = 0
    for k in sorted((k for k in payload if k != HANDOFF_META_KEY), key=repr):
        dtype, shape, buf = payload[k]
        crc = zlib.crc32(repr((k, dtype, tuple(shape))).encode(), crc)
        crc = zlib.crc32(bytes(buf), crc)
    assert crc == payload[HANDOFF_META_KEY][2]
    s.import_layers(payload)
    for k, v in s.cache.items():
        assert torch.equal(v, before[k]), k
    mgr.close()
