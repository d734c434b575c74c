"""Simulators built on the engine.  Counterpart of ``repro.sims``."""
