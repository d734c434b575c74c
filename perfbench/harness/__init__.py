"""The general harness: specs, seeded inputs, the train and serve
drivers, the profiler's reduction and the correctness comparison.  What
belongs to one configuration, traffic mix, cell or per-layer metric lives
in the data files and readers beside it, found by name."""
