"""Serving layer of the port: the request-stream ServingEngine (measured
downtime on a live stream — see ``engine``), the workload subsystem
(seeded arrival processes + multi-client streams — see ``workload``), the
slot-indexed multi-session decode pool (``sessions``) and the
conventional KV-cache batching server built on it (``server``).  The
counterpart of ``repro/serving``; ``sessions`` and ``server`` hold the
tensor code, the other modules are the reference's logic unchanged."""
from repro_torch.serving.clock import Clock, VirtualClock, WallClock, quantize
from repro_torch.serving.engine import (ServingEngine, StageWorker,
                                        request_stream)
from repro_torch.serving.server import BatchingServer, Request, state_nbytes
from repro_torch.serving.sessions import (SessionManager, SlotPoolFull,
                                          make_session_manager)
from repro_torch.serving.sim import SimPipeline, SimPool, SimRunner
from repro_torch.serving.timeline import (DegradedWindow, RequestRecord,
                                          ServiceTimeline, SwitchWindow)
from repro_torch.serving.workload import (ARRIVALS, ArrivalProcess,
                                          BurstyArrivals, ClientStream,
                                          DiurnalArrivals, PoissonArrivals,
                                          UniformArrivals,
                                          available_arrivals, get_arrival,
                                          make_clients, register_arrival)
