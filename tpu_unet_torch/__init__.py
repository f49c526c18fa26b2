"""tpu-unet in PyTorch for NVIDIA GPUs: the port of ``tpu_unet`` (JAX on a
TPU), slice by slice, with hand-written CUDA kernels in place of the Pallas
ones. It keeps the JAX package's module names, NHWC activations and HWIO
weights, and its checkpoint format; it never imports ``jax``.

This slice is the folded-BN serving path: ``models.infer``, ``predict`` and
``serve`` with ``--kernels {torch,cuda}``.
"""
