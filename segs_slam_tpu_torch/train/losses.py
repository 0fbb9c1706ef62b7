"""Photometric and frequency-domain losses.

Port of segs_slam_tpu/train/losses.py (reference: include/loss_utils.h:
29-237). All functions take images as (3, H, W) float32 in [0, 1].

Parity note on the frequency losses, as in the JAX module: the reference
builds its high/low-pass masks with index_put_ on the CHANNEL and HEIGHT
dims of a (3, H, W) tensor, so the slices are empty and the masks are
no-ops. freq_mode="reference" (default) reproduces that: high_frequency_loss
compares FULL amplitude spectra and low_freq_loss is identically zero;
freq_mode="ideal" implements the intended radial masks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """reference: loss_utils.h:29-32"""
    return (pred - gt).abs().mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """reference: loss_utils.h:39-43"""
    mse = ((pred - gt) ** 2).mean()
    return 10.0 * torch.log10(1.0 / mse)


def psnr_gaussian_splatting(pred: torch.Tensor,
                            gt: torch.Tensor) -> torch.Tensor:
    """Per-channel-mean variant (reference: loss_utils.h:45-49)."""
    mse = ((pred - gt).reshape(pred.shape[0], -1) ** 2).mean(dim=1)
    return (20.0 * torch.log10(1.0 / torch.sqrt(mse))).mean()


@functools.lru_cache(maxsize=16)
def _blur_band_matrix(n: int, window_size: int, sigma: float,
                      device: torch.device) -> torch.Tensor:
    """(n, n) banded matrix applying the 1D Gaussian window with zero 'same'
    padding: out[a] = sum_b M[a, b] x[b]. Cached per device; never written
    to."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    g = (g / g.sum()).astype(np.float32)
    pad = window_size // 2
    m = np.zeros((n, n), np.float32)
    for k, w in zip(range(-pad, pad + 1), g):
        m += np.diag(np.full(n - abs(k), w, np.float32), k)
    with torch.inference_mode(False):  # cached: usable with autograd later
        return torch.as_tensor(m, device=device)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM with an 11x11 Gaussian window and zero 'same' padding (the
    reference's formula, loss_utils.h:78-124), the separable blur as two
    banded-matrix products. They must run in full f32: the E[x^2] - mu^2
    cancellation below breaks under TF32, so on a card this needs
    torch.backends.cuda.matmul.allow_tf32 = False (PyTorch's default)."""
    _, h, w = img1.shape
    mh = _blur_band_matrix(h, window_size, sigma, img1.device)
    mw = _blur_band_matrix(w, window_size, sigma, img1.device)

    def conv(x):
        y = torch.einsum("ab,cbw->caw", mh, x)
        return torch.einsum("ab,chb->cha", mw, y)

    mu1 = conv(img1)
    mu2 = conv(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2

    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def _fft2_shifted(img: torch.Tensor) -> torch.Tensor:
    """fft2 over the last two dims + fftshift over ALL dims (the reference
    calls fftshift without dim, which shifts the channel dim too)."""
    return torch.fft.fftshift(torch.fft.fft2(img))


def _safe_abs(z: torch.Tensor) -> torch.Tensor:
    """|z| with a finite gradient at z == 0 (exactly-zero spectrum bins do
    occur on masked images)."""
    return torch.sqrt(z.real**2 + z.imag**2 + 1e-20)


def _centre_mask(h, w, r, inside: float, device) -> torch.Tensor:
    mask = np.full((h, w), 1.0 - inside, np.float32)
    mask[h // 2 - r:h // 2 + r, w // 2 - r:w // 2 + r] = inside
    return torch.as_tensor(mask, device=device)


def high_frequency_loss(img1: torch.Tensor, img2: torch.Tensor,
                        cutoff_ratio: float = 0.4,
                        freq_mode: str = "reference") -> torch.Tensor:
    """reference: loss_utils.h:147-165 (see the module docstring)."""
    f1 = _fft2_shifted(img1)
    f2 = _fft2_shifted(img2)
    if freq_mode == "ideal":
        _, h, w = img1.shape
        m = _centre_mask(h, w, int(cutoff_ratio * min(h, w) / 2), 0.0,
                         img1.device)
        f1 = f1 * m
        f2 = f2 * m
    return (_safe_abs(f1) - _safe_abs(f2)).abs().mean()


def low_freq_loss(img1: torch.Tensor, img2: torch.Tensor,
                  cutoff_ratio: float = 0.2,
                  freq_mode: str = "reference") -> torch.Tensor:
    """reference: loss_utils.h:187-205. As built this is identically zero
    (see the module docstring); "reference" mode returns 0 without FFTs."""
    if freq_mode == "reference":
        return torch.zeros((), dtype=img1.dtype, device=img1.device)
    c, h, w = img1.shape
    m = _centre_mask(h, w, int(cutoff_ratio * min(h, w) / 2), 1.0,
                     img1.device)
    f1 = _fft2_shifted(img1) * m
    f2 = _fft2_shifted(img2) * m
    norm = float(h * w * c)
    loss_la = (_safe_abs(f1) - _safe_abs(f2)).abs().sum() / norm
    loss_lp = (torch.angle(f1) - torch.angle(f2)).abs().sum() / norm
    return loss_la + loss_lp


def masked_image_metrics(img: torch.Tensor, gt: torch.Tensor):
    """(masked image, psnr, ssim, psnr_gs) of an eval render against its
    ground truth, both masked to the pixels where gt is not black (the
    JAX Trainer's `_eval_metrics`)."""
    mask = (gt != 0.0).any(dim=0, keepdim=True).float()
    img_m, gt_m = img * mask, gt * mask
    return (img_m, psnr(img_m, gt_m), ssim(img_m, gt_m),
            psnr_gaussian_splatting(img_m, gt_m))


def resize_bilinear(img: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """(C, H, W) -> (C, height, width) with the JAX version's
    jax.image.resize(..., "bilinear") semantics, which anti-alias when they
    downscale: F.interpolate needs antialias=True to match (without it the
    two differ by more than 0.1 at scales 0.5 and 0.25)."""
    return F.interpolate(img[None], size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True)[0]


def _bilinear_resize(img: torch.Tensor, scale: float) -> torch.Tensor:
    """Bilinear resize by `scale` (see resize_bilinear)."""
    _, h, w = img.shape
    return resize_bilinear(img, int(round(h * scale)), int(round(w * scale)))


def multi_scale_loss(pred: torch.Tensor, gt: torch.Tensor,
                     scales: tuple = (1.0, 0.5, 0.25),
                     freq_mode: str = "reference") -> torch.Tensor:
    """Pyramid of (scaled) high-frequency losses, weighted by the scale
    (reference: loss_utils.h:208-237; scales = 1/2^i per
    src/gaussian_mapper.cpp:514-518)."""
    loss = torch.zeros((), dtype=pred.dtype, device=pred.device)
    for s in scales:
        p = _bilinear_resize(pred, s)
        g = _bilinear_resize(gt, s)
        loss = loss + s * high_frequency_loss(p, g, freq_mode=freq_mode)
    return loss
