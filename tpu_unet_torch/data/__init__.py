"""Image preprocessing and the synthetic Carvana-like data generator."""

from tpu_unet_torch.data.loading import preprocess
from tpu_unet_torch.data.synthetic import make_synthetic_carvana, synth_batch, synth_sample

__all__ = ["make_synthetic_carvana", "preprocess", "synth_batch", "synth_sample"]
