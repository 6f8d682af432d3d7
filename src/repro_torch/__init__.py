"""PyTorch / CUDA port of the QSketch system for NVIDIA Hopper (H100).

The package mirrors ``src/repro`` module by module. Plain tensor code is
PyTorch; every Pallas TPU kernel on the ported path is a CUDA C++ kernel
written for ``sm_90a`` (``csrc/``), built at first use by
``kernels/_build.py`` and bound with ``ctypes``.

Device rule: entry points that create state take ``device`` and default to
``"cuda"``; without a GPU they raise unless the caller passes
``device="cpu"``. Every kernel wrapper dispatches on the device of the
tensors it is given: a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the hand-written kernel (or raises). Nothing falls back.
"""
