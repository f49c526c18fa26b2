"""Utilities (``tpu_unet/utils``)."""
