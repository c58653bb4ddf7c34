"""Linear sRGB working space -> display sRGB (counterpart of
raytracer_tpu/utils/color.py; the reference's `palette` use,
src/image.rs:50-88)."""

from __future__ import annotations

import functools

import torch

# Luminance weights of linear sRGB primaries (D65), as palette's
# LinSrgb::into_luma() (src/main.rs:748-762).
LUMA_WEIGHTS = (0.212656, 0.715158, 0.072186)

# Named colours, linear sRGB (src/consts.rs:2-22).
BLACK = (0.0, 0.0, 0.0)
WHITE = (1.0, 1.0, 1.0)
RED = (1.0, 0.0, 0.0)
GREEN = (0.0, 1.0, 0.0)
BLUE = (0.0, 0.0, 1.0)
YELLOW = (1.0, 1.0, 0.0)
CYAN = (0.0, 1.0, 1.0)
MAGENTA = (1.0, 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def _luma_weights(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """LUMA_WEIGHTS on `device`, made once: a copy from the host to a card
    waits for the card's queue to drain."""
    return torch.tensor(LUMA_WEIGHTS, dtype=dtype, device=device)


def luma(rgb):
    return torch.sum(rgb * _luma_weights(rgb.device, rgb.dtype), dim=-1)


def srgb_encode(linear):
    """Linear -> sRGB transfer function, clamped to [0, 1]."""
    x = torch.clamp(linear, 0.0, 1.0)
    lo = 12.92 * x
    hi = 1.055 * torch.pow(x, 1.0 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, lo, hi)


def srgb_decode(encoded):
    """sRGB -> linear transfer function, clamped to [0, 1] (for loading
    golden images)."""
    x = torch.clamp(encoded, 0.0, 1.0)
    lo = x / 12.92
    hi = torch.pow((x + 0.055) / 1.055, 2.4)
    return torch.where(x <= 0.04045, lo, hi)


def linear_to_u8(linear):
    """Linear [..., 3] f32 -> display sRGB u8, round half to even."""
    return torch.round(srgb_encode(linear) * 255.0).to(torch.uint8)


def srgb_u8_to_linear(u8):
    """Display sRGB u8 -> linear f32 (the inverse of linear_to_u8)."""
    return srgb_decode(u8.to(torch.float32) / 255.0)
