"""Design-space exploration on the engine.  Counterpart of ``repro.dse``;
so far only :class:`TopologyFamily`, the contract of family-aware builders
such as ``repro_torch.sims.memsys.build_family``."""
from .family import TopologyFamily

__all__ = ["TopologyFamily"]
