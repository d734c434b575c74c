"""Model library of the port: configs, layers, attention, SSM, assembly."""
