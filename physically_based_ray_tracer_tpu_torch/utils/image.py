"""Image IO and pixel conversion; counterpart of ``physically_based_ray_tracer_tpu/utils/image.py``.

A line-for-line numpy copy (importing the JAX package's module would load
the JAX package). PNG writing and LDR reading use PIL where it is
installed, as the JAX package does; without PIL, ``write_png`` writes an
uncompressed PPM under the ``.png`` name, and ``read_image`` (hence a
textured asset) cannot load. The Radiance ``.hdr`` reader and writer are
pure numpy.
"""

from __future__ import annotations

import os
import time

import numpy as np


def rgbf32_to_rgb8(img: np.ndarray) -> np.ndarray:
    """float RGB in [0,1] -> uint8, replicating RGBF32_to_RGB8 semantics
    (template/precomp.h:300-316: scale by 255, clamp)."""
    return np.clip(np.asarray(img) * 255.0, 0.0, 255.0).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> str:
    """Write an (H, W, 3) float [0,1] or uint8 image as PNG.

    Mirrors ``Renderer::Capture`` (Core/Renderer.cpp:437-465) minus the ARGB
    repacking (our framebuffer is float RGB throughout).
    """
    arr = img if img.dtype == np.uint8 else rgbf32_to_rgb8(img)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        from PIL import Image
        Image.fromarray(arr, mode="RGB").save(path)
    except ImportError:  # minimal fallback: uncompressed PPM with .png name
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            f.write(arr.tobytes())
    return path


def capture_path(directory: str = "assets/captures") -> str:
    """Timestamped capture filename, format of Core/Renderer.cpp:459-460."""
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    return os.path.join(directory, f"capture_{stamp}.png")


def read_image(path: str) -> np.ndarray:
    """Read an LDR image to float32 RGB in [0,1] (stb_image replacement)."""
    from PIL import Image
    img = Image.open(path)
    if img.mode not in ("RGB", "RGBA"):
        img = img.convert("RGBA" if "A" in img.getbands() else "RGB")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr


def write_hdr(path: str, img: np.ndarray) -> str:
    """Write an (H, W, 3) float32 RGB image as a Radiance .hdr (RGBE, flat
    scanlines) — the inverse of read_hdr, used for skydome fixtures."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    m = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    nz = m > 1e-32
    exp[nz] = np.frexp(m[nz])[1]
    scale = np.where(nz, np.ldexp(1.0, -exp) * 256.0, 0.0).astype(np.float32)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    # Flat-scanline guard: stb-style readers treat a scanline whose first two
    # bytes are 0x02 0x02 (for widths 8..32767) as adaptive-RLE. Bump the
    # green mantissa of such a first pixel by one step (≤0.4% channel error)
    # so external tools never misdecode these flat files (ADVICE r3).
    if 8 <= w < 32768:
        bad = (rgbe[:, 0, 0] == 2) & (rgbe[:, 0, 1] == 2)
        rgbe[bad, 0, 1] = 3
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (h, w))
        f.write(rgbe.tobytes())
    return path


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file to float32 RGB (stbi_loadf replacement).

    Pure-python RLE decoder for the RGBE format used by the reference's
    skydome loading (Core/Camera.cpp:9).
    """
    with open(path, "rb") as f:
        data = f.read()
    # Header ends at the first blank line; next line is the resolution.
    pos = 0
    lines = []
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
        lines.append(line)
    res_nl = data.index(b"\n", pos)
    res = data[pos:res_nl].split()
    pos = res_nl + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported .hdr orientation: {res}")
    height, width = int(res[1]), int(res[3])

    rgbe = np.zeros((height, width, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8, offset=pos)
    bi = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or not (
                buf[bi] == 2 and buf[bi + 1] == 2 and (int(buf[bi + 2]) << 8 | int(buf[bi + 3])) == width):
            # flat (non-RLE) scanline
            rgbe[y] = buf[bi:bi + width * 4].reshape(width, 4)
            bi += width * 4
            continue
        bi += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[bi]); bi += 1
                if count > 128:  # run
                    rgbe[y, x:x + count - 128, c] = buf[bi]
                    bi += 1
                    x += count - 128
                else:            # literal
                    rgbe[y, x:x + count, c] = buf[bi:bi + count]
                    bi += count
                    x += count
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]
