"""A decode stage captured once as a CUDA graph and replayed every step.

An eager decode step of a 7B SSM or hybrid model is thousands of small
launches, each ~25 us of host dispatch: the card idles while the host
launches.  A ``StageGraph`` captures one stage's launches once and
replays them with one call.  What makes the replay the same work:

* **Inputs go through static buffers.**  ``replay`` copies each input
  (the token, the position, the hidden crossing the split) into the
  graph's own buffer first; the outputs are the graph's static tensors,
  overwritten by the next replay.
* **State keeps its address.**  The captured stage reads and writes the
  session's state entries where they lie (``bound``: each entry's
  address at capture).  ``matches`` compares them with the session's
  entries before each replay; the caller recaptures on any difference.
* **Nothing waits on the host inside a stage** (NK03): a capture that
  meets a sync or a pageable copy raises, and ``capture`` leaves the
  allocator as it found it; the caller then runs the stage eagerly.
* **Launch counters stay truthful.**  The kernel wrappers' calls inside a
  capture are tallied (``kernels.tallied``), not counted; each replay adds
  the tally to their ``.launches``.

A capture runs on one side stream per device, created non-blocking, in
``thread_local`` mode: another thread may allocate and synchronise its own
stream meanwhile (a standby build), but nothing may wait on the whole
device.  Captures and replays of one graph run on one thread.  Each graph
draws its temporaries from a private pool of the caching allocator,
reused within the capture and kept across recaptures; ``reset`` frees
them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.core import timing
from repro_torch.core.stages import abstractify, materialize

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's capture stream (a pool stream: non-blocking, so the
    legacy default stream stays usable by other threads meanwhile)."""
    s = _streams.get(device)
    if s is None:
        s = _streams.setdefault(device, torch.cuda.Stream(device))
    return s


def _abandon(device: torch.device, pool) -> None:
    """Undo what a capture that failed to end left in the caching
    allocator: its pool's routing and the pool's use count."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    for name in ("_cuda_endAllocateToPool", "_cuda_releasePool"):
        fn = getattr(torch._C, name, None)
        if fn is not None:
            try:
                fn(index, pool)
            except RuntimeError:
                pass


def addresses(state: Dict[str, torch.Tensor]) -> Optional[Dict[str, int]]:
    """Each entry's device address, or None where an entry is not a plain
    CUDA tensor (a mesh's ``ShardedTensor``), which no graph binds."""
    out = {}
    for k, v in state.items():
        if type(v) is not torch.Tensor or v.device.type != "cuda":
            return None
        out[k] = v.data_ptr()
    return out


class StageGraph:
    """One stage's CUDA graph, its static inputs and outputs, the state
    addresses it binds, and its kernels' launches a replay.  ``refused``
    names the error of a capture that failed: the stage then stays
    eager."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.pool = None
        self.inputs: Dict[str, torch.Tensor] = {}
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.bound: Dict[str, int] = {}
        self.launches: Dict[object, int] = {}
        self.refused: Optional[str] = None

    def matches(self, bound: Dict[str, int], inputs: dict) -> bool:
        """Whether a replay reads and writes the state at ``bound`` and
        takes inputs of these shapes and dtypes (tensors or
        ``TensorSpec``s)."""
        if self.graph is None or bound != self.bound \
                or inputs.keys() != self.inputs.keys():
            return False
        return all(tuple(v.shape) == tuple(self.inputs[k].shape)
                   and v.dtype == self.inputs[k].dtype
                   for k, v in inputs.items())

    def capture(self, run: Callable[[Dict[str, torch.Tensor]], tuple],
                bound: Dict[str, int], inputs: dict) -> bool:
        """Capture ``run(static_inputs)`` (a tuple of tensors) over static
        buffers shaped like ``inputs`` (tensors or ``TensorSpec``s), the
        state it touches lying at ``bound``.  Returns False, the stage
        refused, where the capture raises."""
        dev = self.device
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        static = materialize(abstractify(inputs))
        graph = torch.cuda.CUDAGraph()
        stream = _capture_stream(dev)
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with timing.span("step.capture", entries=len(bound)), \
                kernels.tallied() as tally:
            timing.count("graph_captures")
            try:
                with torch.cuda.stream(stream):
                    graph.capture_begin(pool=self.pool,
                                        capture_error_mode="thread_local")
                    try:
                        outputs = tuple(run(static))
                    except BaseException:
                        try:
                            graph.capture_end()
                        except RuntimeError:
                            _abandon(dev, self.pool)
                        raise
                    graph.capture_end()
            except RuntimeError as e:
                self.refused = f"{type(e).__name__}: {e}"
                self.reset()
                return False
            finally:
                current.wait_stream(stream)
        old = self.graph
        self.graph, self.inputs, self.outputs = graph, static, outputs
        self.bound, self.launches = dict(bound), dict(tally)
        if old is not None:
            old.reset()         # after the new capture: the pool stays held
        return True

    def replay(self, inputs: Dict[str, torch.Tensor]) -> tuple:
        """Copy ``inputs`` into the static buffers and replay; returns the
        static outputs."""
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        timing.count("graph_replays")
        return self.outputs

    def reset(self) -> None:
        """Drop the graph and its buffers; its pool's blocks go back."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.inputs, self.outputs, self.bound, self.launches = {}, (), {}, {}
