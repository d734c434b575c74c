"""Hand-written CUDA kernels for the framework's hot spots, one per Pallas
kernel of ``repro.kernels``.

Each kernel ships as ``csrc/<name>.cu`` (the CUDA source, built by
``_build`` at first use), ``kernel.py`` (the ctypes launcher with its
``launches`` counter), ``ops.py`` (the model-side entry: the kernel for a
tensor on the card, the plain version for one on the CPU) and ``ref.py``
(the plain PyTorch version of the same function).
"""
