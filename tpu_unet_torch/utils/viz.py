"""``plot_img_and_mask`` (``tpu_unet/utils/viz.py``, the reference's
``utils/utils.py``): the input image and one subplot per class. matplotlib
is imported when it is called."""

from __future__ import annotations

import numpy as np


def plot_img_and_mask(img, mask) -> None:
    import matplotlib.pyplot as plt

    mask = np.asarray(mask)
    classes = int(mask.max()) + 1 if mask.dtype != bool else 2
    _, ax = plt.subplots(1, classes + 1)
    ax[0].set_title("Input image")
    ax[0].imshow(img)
    for i in range(classes):
        ax[i + 1].set_title(f"Mask (class {i + 1})")
        ax[i + 1].imshow(mask == i)
    plt.xticks([]), plt.yticks([])
    plt.show()
