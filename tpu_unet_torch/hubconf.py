"""torch.hub entry file of the PyTorch port (the JAX package's is the
repository's root ``hubconf.py``):

    torch.hub.load("<repo>/tpu_unet_torch", "unet_carvana", source="local",
                   pretrained=True, weights_path="unet_carvana_scale0.5_epoch2.pth")

returns ``(params, state, config, mask_values)`` (``hub.py``). torch.hub puts
only this directory on ``sys.path``; the repository root, which holds the
package, is added when ``tpu_unet_torch`` is not importable otherwise.
"""

import importlib.util
import os
import sys

dependencies = ["torch", "numpy"]

if importlib.util.find_spec("tpu_unet_torch") is None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_unet_torch.hub import unet, unet_carvana  # noqa: E402,F401
