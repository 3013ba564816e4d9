"""peleanalysis-tpu-torch: the PyTorch + CUDA port of ``peleanalysis_tpu``.

Runs the ``grad``, ``curvature``, ``stream`` and ``sampleStreamlines``
tools on an NVIDIA H100 (or, with
``device=cpu``, on the CPU through the kernels' plain PyTorch versions):
``python -m peleanalysis_tpu_torch <tool> key=value ...`` with the
JAX package's ParmParse keys.  This package never imports JAX or
``peleanalysis_tpu``; it carries its own copies of the numpy-only host
modules (ParmParse, boxes, geometry, plotfile I/O).
"""

__version__ = "0.1.0"
