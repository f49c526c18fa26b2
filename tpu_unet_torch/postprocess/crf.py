"""Mean-field CRF refinement of mask probabilities
(``tpu_unet/postprocess/crf.py``), on the device.

The JAX package's approximation of the legacy reference's dense CRF
(``utils/crf.py``, pydensecrf): a separable Gaussian spatial kernel for the
smoothness term, and an appearance term approximated by scaling messages
with a local colour-affinity map (labels spread inside regions of similar
colour and stop at strong edges). A fixed number of iterations, no host
sync.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur over H, then W, of [N,H,W,C]: a depthwise
    conv with zero padding of the kernel's radius, channel by channel."""
    c = x.shape[-1]
    r = kernel.shape[0] // 2
    k = kernel.to(x.device, x.dtype)
    h = x.permute(0, 3, 1, 2)
    h = F.conv2d(h, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(r, 0), groups=c)
    h = F.conv2d(h, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, r), groups=c)
    return h.permute(0, 2, 3, 1)


def _diff_prepend_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    """|x - x shifted by one along ``dim``|, zero at the first index
    (``jnp.diff(x, axis=dim, prepend=x[first])``)."""
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)
    return (x - prev).abs()


def crf_refine(image: torch.Tensor, probs: torch.Tensor, *, iters: int = 5,
               spatial_sigma: float = 3.0, compat: float = 3.0,
               edge_sigma: float = 0.1) -> torch.Tensor:
    """Refine class probabilities with mean-field smoothing.

    image: [N,H,W,3] in [0,1]; probs: [N,H,W,C] probabilities. Returns the
    refined probabilities, same shape."""
    unary = -torch.log(probs.clamp(1e-8, 1.0))
    grad = (_diff_prepend_first(image, 1) + _diff_prepend_first(image, 2)).sum(-1, keepdim=True)
    affinity = torch.exp(-grad / edge_sigma)  # ~1 inside regions, ~0 at edges
    kernel = _gaussian_kernel1d(spatial_sigma, int(2 * spatial_sigma))
    q = torch.softmax(-unary, dim=-1)
    for _ in range(iters):
        qa = q * affinity
        msg = _blur(qa, kernel) - qa  # neighbours only
        # Potts compatibility: penalise disagreement with the neighbours.
        energy = unary + compat * (msg.sum(-1, keepdim=True) - msg)
        q = torch.softmax(-energy, dim=-1)
    return q


def crf_refine_binary(image: torch.Tensor, fg_probs: torch.Tensor, **kwargs) -> torch.Tensor:
    """[N,H,W] foreground probabilities -> refined foreground probabilities."""
    probs = torch.stack([1.0 - fg_probs, fg_probs], dim=-1)
    return crf_refine(image, probs, **kwargs)[..., 1]
