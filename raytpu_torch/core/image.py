"""Image IO and quantization — the framebuffer layer (a numpy copy of
raytpu/core/image.py, which cannot be imported without jax).

Replaces the reference's SDL 1.2 platform shim
(`raytracer/Source/SDLauxiliary.h:31-81`): ``PutPixelSDL`` clamps
``255*color`` to [0, 255] and truncates to Uint8 (`SDLauxiliary.h:75-77`);
``SDL_SaveBMP`` writes the surface as a bottom-up 24-bpp BMP on exit
(`raytracer.cpp:175`, `rasteriser.cpp:147`). raytpu renders to float arrays
and converts at the edge with the same quantization.

Pure-numpy BMP codec (no SDL, no PIL).
"""

from __future__ import annotations

import struct

import numpy as np


def quantize_u8(image: np.ndarray) -> np.ndarray:
    """float image (H, W, 3) -> uint8 with PutPixelSDL semantics.

    ``Uint8(clamp(255*c, 0, 255))`` — C++ float->integer conversion truncates
    toward zero (`SDLauxiliary.h:75-77`).
    """
    img = np.asarray(image, dtype=np.float32)
    return np.clip(255.0 * img, 0.0, 255.0).astype(np.uint8)


def encode_bmp(image: np.ndarray) -> bytes:
    """Encode an (H, W, 3) image as 24-bpp bottom-up BMP bytes.

    Accepts float (quantized via :func:`quantize_u8`) or uint8 RGB.
    """
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = quantize_u8(img)
    h, w, _ = img.shape
    row_size = (3 * w + 3) & ~3  # rows padded to 4 bytes
    pixel_bytes = row_size * h
    # BGR, bottom-up
    bgr = img[::-1, :, ::-1]
    rows = np.zeros((h, row_size), dtype=np.uint8)
    rows[:, : 3 * w] = bgr.reshape(h, 3 * w)

    file_size = 14 + 40 + pixel_bytes
    header = struct.pack("<2sIHHI", b"BM", file_size, 0, 0, 54)
    info = struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, 24, 0, pixel_bytes, 2835, 2835, 0, 0
    )
    return header + info + rows.tobytes()


def write_bmp(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) image as a 24-bpp bottom-up BMP
    (:func:`encode_bmp`)."""
    with open(path, "wb") as f:
        f.write(encode_bmp(image))


def read_bmp(path: str) -> np.ndarray:
    """Read an uncompressed 24/32-bpp BMP into an (H, W, 3) uint8 RGB array.

    Handles the committed reference renders (500x500 24-bpp,
    `rasteriser/screenshot.bmp`).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (pixel_offset,) = struct.unpack_from("<I", data, 10)
    (header_size,) = struct.unpack_from("<I", data, 14)
    w, h = struct.unpack_from("<ii", data, 18)
    (bpp,) = struct.unpack_from("<H", data, 28)
    (compression,) = struct.unpack_from("<I", data, 30)
    if compression not in (0, 3):
        raise ValueError(f"{path}: compressed BMP not supported")
    flip = h > 0
    h = abs(h)
    if bpp == 24:
        row_size = (3 * w + 3) & ~3
        rows = np.frombuffer(
            data, dtype=np.uint8, count=row_size * h, offset=pixel_offset
        ).reshape(h, row_size)
        bgr = rows[:, : 3 * w].reshape(h, w, 3)
        rgb = bgr[:, :, ::-1]
    elif bpp == 32:
        rows = np.frombuffer(
            data, dtype=np.uint8, count=4 * w * h, offset=pixel_offset
        ).reshape(h, w, 4)
        rgb = rows[:, :, 2::-1]  # BGRA -> RGB
    else:
        raise ValueError(f"{path}: {bpp}-bpp BMP not supported")
    if flip:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)
