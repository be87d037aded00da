"""Host-side PIL helpers for single-image prediction (the port's own copy of
transparent_object_detection_tpu/utils/image.py's cvt_color/resize_image)."""
from __future__ import annotations

from typing import Tuple

from PIL import Image


def cvt_color(image: Image.Image) -> Image.Image:
    """Ensure 3-channel RGB."""
    if image.mode == "RGB":
        return image
    return image.convert("RGB")


def resize_image(image: Image.Image, size: Tuple[int, int],
                 letterbox_image: bool = False) -> Image.Image:
    """Resize to (w, h) with BICUBIC resampling, optionally letterboxed onto
    a (128, 128, 128) canvas with floor-divided centring offsets."""
    iw, ih = image.size
    w, h = size
    if letterbox_image:
        scale = min(w / iw, h / ih)
        nw, nh = int(iw * scale), int(ih * scale)
        image = image.resize((nw, nh), Image.BICUBIC)
        canvas = Image.new("RGB", size, (128, 128, 128))
        canvas.paste(image, ((w - nw) // 2, (h - nh) // 2))
        return canvas
    return image.resize((w, h), Image.BICUBIC)
