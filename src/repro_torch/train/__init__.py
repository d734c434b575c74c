"""Training: the train step and the fault-tolerant loop.  Counterpart of
``repro.train``."""
