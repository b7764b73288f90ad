"""What the port leaves to Python's cyclic garbage collector: the first
stateful manager moves the imported modules' objects out of its walk,
once a process; a model built after that is still freed whole when its
manager closes; and a checkpoint reload leaves no host copy of the
weights in a reference cycle."""
import dataclasses
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import heap  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.stages import StageRunner  # noqa: E402
from repro_torch.core.stateful import make_stateful_manager  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402

CFG = dataclasses.replace(get_config("qwen2.5-3b").reduced(), num_layers=3)


@pytest.fixture
def thawed():
    """The process as before its first manager: nothing frozen."""
    gc.unfreeze()
    heap._frozen = False
    yield
    heap.freeze_startup_heap()


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _tensors():
    """Every tensor the collector can reach from what it tracks."""
    return [o for o in gc.get_referents(*gc.get_objects())
            if issubclass(type(o), torch.Tensor)]


def _manager(params, **kw):
    return make_stateful_manager(CFG, params, split=1,
                                 net=NetworkModel(20.0), prompt_len=8,
                                 max_seq=32, device="cpu", **kw)


def test_first_manager_freezes_the_heap_once(thawed):
    marker = type("Marker", (), {})()
    assert gc.get_freeze_count() == 0
    params = init_model(CFG, device="cpu", seed=0)
    StageRunner(CFG, params, device="cpu")      # a runner alone: no freeze
    assert gc.get_freeze_count() == 0
    mgr, _ = _manager(params)
    frozen = gc.get_freeze_count()
    assert frozen > 0
    assert not any(o is marker for o in gc.get_objects())   # frozen too
    assert any(o is mgr.runner for o in gc.get_objects())   # not frozen
    mgr.close()
    _manager(params)[0].close()                 # a second manager: no-op
    assert gc.get_freeze_count() == frozen
    # a full collection now walks only what was made after the freeze
    assert len(gc.get_objects()) < frozen


def test_closed_manager_is_freed_after_the_freeze(thawed):
    """The weights made before the first manager are frozen with the
    modules; its runner, pipelines and session are not: closing the
    manager after three switches and dropping the weights frees every
    tensor of the model, those only the cyclic collector reaches
    included."""
    before = {id(t) for t in _tensors()}
    params = init_model(CFG, device="cpu", seed=0)
    mgr, session = _manager(params, standby_split=2,
                            force_mode="recompute")
    for strategy, split in (("switch_a", 2), ("switch_b2", 0),
                            ("pause_resume", 2)):
        mgr.repartition(strategy, split)
        mgr.serve(None)
    assert heap._frozen and gc.get_freeze_count() > 0
    refs = [weakref.ref(t) for t in _tensors() if id(t) not in before]
    refs += [weakref.ref(t) for t in _leaves(params)]
    assert len(refs) > 20
    mgr.close()
    del mgr, session, params
    gc.collect()
    assert [r for r in refs if r() is not None] == []


@pytest.mark.parametrize("like", [True, False])
def test_checkpoint_reload_leaves_no_tensor_in_a_cycle(tmp_path, like):
    """pause_resume reloads its weights through ``load_pytree``: the host
    copy it reads must be freed when the call returns, not kept by a
    reference cycle until a full collection frees gigabytes on the
    serving thread."""
    params = init_model(CFG, dtype=torch.bfloat16, device="cpu", seed=0)
    path = str(tmp_path / "ckpt.npz")
    save_pytree(params, path)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        out = load_pytree(path, like=params if like else None)
        gc.collect()
        held = [o for o in gc.garbage if issubclass(type(o), torch.Tensor)
                or isinstance(o, dict) and any(
                    issubclass(type(v), torch.Tensor) for v in o.values())]
    finally:
        gc.garbage.clear()
        gc.set_debug(0)
        gc.enable()
    assert held == []
    got = _leaves(out) if like else list(out.values())
    assert len(got) == len(_leaves(params))
