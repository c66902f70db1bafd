"""PyTorch/CUDA port of ``pcrlv2_tpu`` for NVIDIA Hopper (H100).

Layout conventions follow the JAX package so the two can be held against
each other: activations are channels-last NDHWC, parameters use the
reference PyTorch layout and key names (``PCRLv23d.state_dict()`` is the
reference ``.pt`` schema).  The four Pallas kernels on the 3D pretraining
path are hand-written CUDA C++ (``csrc/``), built with ``nvcc`` on first use.

Importing this package imports ``torch`` and numpy only.
"""
