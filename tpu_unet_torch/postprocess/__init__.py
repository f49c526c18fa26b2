"""Mask post-processing (``tpu_unet/postprocess``)."""

from tpu_unet_torch.postprocess.crf import crf_refine, crf_refine_binary

__all__ = ["crf_refine", "crf_refine_binary"]
