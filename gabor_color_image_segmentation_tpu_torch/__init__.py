"""gabor_color_image_segmentation_tpu_torch — the PyTorch / CUDA port.

A second package beside the JAX reference ``gabor_color_image_segmentation_tpu``
with the same layout (``ops/``, ``models/``): each port module pairs with
one reference module. It imports torch and numpy, never JAX; of the
reference package it imports only the JAX-free ``config``, ``data`` and
``utils.labels``.

Every Pallas kernel the port's path runs has a counterpart written by hand
in CUDA C++ for Hopper (``csrc/``, built by ``_kernels.py``), and beside it
a plain PyTorch version of the same math that serves CPU tensors.

Covered so far: the labels-only k-means path of ``config0`` and ``config1``
(``models/pipeline.py::segment_batch``).
"""
