"""Image KernelSHAP: superpixel masking.

A copy of ``distributedkernelshap_tpu/ops/image.py`` (host numpy, no
framework), kept in the port so it imports nothing of the JAX package.

The reference is tabular-only; the image configuration (BASELINE.json:
"MNIST CNN, 10k instances, image KernelSHAP with superpixel masking") maps
onto the same engine because grouping IS masking: each superpixel (patch of
pixels) is one feature group, the coalition mask selects patches from the
explained image, and the "background" rows provide the masked-out pixel
values (a blurred copy, a constant fill, or dataset means).  No new kernel is
needed — ``groups_to_matrix`` turns patches into the ``(M, D)`` mask basis
and the standard pipeline runs, with one SHAP value per superpixel.
"""

from typing import List, Sequence, Tuple

import numpy as np


def superpixel_groups(height: int, width: int, patch: int,
                      channels: int = 1) -> Tuple[List[List[int]], List[str]]:
    """Partition an ``(H, W, C)`` image (flattened row-major) into square
    ``patch x patch`` superpixels spanning all channels.

    Returns ``(groups, group_names)`` in the engine's grouping format; ragged
    edge patches are smaller when ``patch`` does not divide H or W.
    """

    groups: List[List[int]] = []
    names: List[str] = []
    for py in range(0, height, patch):
        for px in range(0, width, patch):
            cols = [
                (y * width + x) * channels + c
                for y in range(py, min(py + patch, height))
                for x in range(px, min(px + patch, width))
                for c in range(channels)
            ]
            groups.append(cols)
            names.append(f"patch_{py // patch}_{px // patch}")
    return groups, names


def image_background(images: np.ndarray, mode: str = "mean",
                     fill_value: float = 0.0, blur_radius: int = 2,
                     n_rows: int = 1) -> np.ndarray:
    """Build background rows for image explanations.

    ``mode``:
      * ``'mean'`` — per-pixel dataset mean (one row);
      * ``'fill'`` — constant ``fill_value`` (one row);
      * ``'blur'`` — box-blurred copies of ``n_rows`` sample images (the
        classic "hide a superpixel by blurring it" scheme);
      * ``'sample'`` — ``n_rows`` images drawn from the dataset.

    ``images``: ``(n, H, W, C)`` or ``(n, D)`` flattened; output is flattened
    ``(rows, D)`` float32.
    """

    flat = images.reshape(images.shape[0], -1).astype(np.float32)
    if mode == "mean":
        return flat.mean(0, keepdims=True)
    if mode == "fill":
        return np.full((1, flat.shape[1]), fill_value, dtype=np.float32)
    if mode == "sample":
        return flat[:n_rows]
    if mode == "blur":
        if images.ndim == 2:
            raise ValueError("blur mode needs (n, H, W[, C]) images, got flattened input")
        imgs = images[:n_rows].astype(np.float32)
        if imgs.ndim == 3:
            imgs = imgs[..., None]
        blurred = _box_blur(imgs, blur_radius)
        return blurred.reshape(blurred.shape[0], -1)
    raise ValueError(f"Unknown background mode: {mode!r}")


def _box_blur(imgs: np.ndarray, radius: int) -> np.ndarray:
    """Separable box blur over the spatial axes of ``(n, H, W, C)``."""

    if radius <= 0:
        return imgs
    k = 2 * radius + 1
    pad = np.pad(imgs, ((0, 0), (radius, radius), (0, 0), (0, 0)), mode="edge")
    csum = np.cumsum(pad, axis=1)
    out = (np.concatenate([csum[:, k - 1:k], csum[:, k:] - csum[:, :-k]], axis=1)) / k
    pad = np.pad(out, ((0, 0), (0, 0), (radius, radius), (0, 0)), mode="edge")
    csum = np.cumsum(pad, axis=2)
    out = (np.concatenate([csum[:, :, k - 1:k], csum[:, :, k:] - csum[:, :, :-k]], axis=2)) / k
    return out
