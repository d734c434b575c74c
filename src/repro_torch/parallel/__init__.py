from .sharding import (batch_pspec, data_axes, make_rules,  # noqa: F401
                       make_rules_for_mesh)
