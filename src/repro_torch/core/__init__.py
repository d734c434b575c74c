"""repro_torch.core — the Akita simulation engine in PyTorch, the sharded
conservative PDES (submodule ``pdes``: ``ShardedSim``, ``lane_mesh``,
``add_gateway``), and the host-side task tracing, tracers, monitor and
Daisen export (submodules ``tracing``, ``tracers``, ``monitor``,
``daisen``).  Counterpart of ``repro.core``."""
from .component import ComponentKind, KindHandle, TickResult
from .engine import (SimBuilder, SimParams, SimState, Simulation, Stats,
                     check_not_consumed)
from .message import (MSG_WORDS, f2i, i2f, msg_new, msg_reply, opcode,
                      payload, ready_time)
from .ports import Ports, oh_set, take

__all__ = [
    "ComponentKind", "KindHandle", "TickResult", "SimBuilder", "SimParams",
    "SimState", "Simulation", "Stats", "check_not_consumed", "Ports",
    "MSG_WORDS", "msg_new",
    "msg_reply", "opcode", "payload", "ready_time", "f2i", "i2f", "oh_set",
    "take",
]
