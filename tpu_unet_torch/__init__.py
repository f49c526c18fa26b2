"""tpu-unet in PyTorch for NVIDIA GPUs: the port of ``tpu_unet`` (JAX on a
TPU), slice by slice, with hand-written CUDA kernels in place of the Pallas
ones. It keeps the JAX package's module names, NHWC activations and HWIO
weights, and its checkpoint format; it never imports ``jax``.

Ported so far: the folded-BN serving path (``models.infer``, ``predict``,
``serve``), the train step (``train.make_train_step``) and the train entry
point around it (``train_cli``, ``train.train_model``, ``evaluate``, the
datasets and loader, full-state checkpoints), with ``--kernels {torch,cuda}``;
and the single-device predict surface: batched predict, flip TTA, tiled
inference, CRF refinement and ``.pth`` checkpoints both ways.
"""
