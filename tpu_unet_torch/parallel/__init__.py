"""Spatial tiling of large images (``tpu_unet/parallel``), on one device."""
