"""Video writing (the port's copy of ``torchdriveenv_tpu/utils/video.py``:
numpy, and PIL imported where a frame is encoded).

Two encoders that need neither OpenCV nor ffmpeg:
  - MJPEG-in-AVI (``.avi``): a pure-Python RIFF/AVI muxer around PIL JPEG
    frames;
  - animated GIF (``.gif``): PIL.
``save_video(..., 'x.mp4')`` writes ``x.avi`` and logs that it did: there is
no mp4 encoder.
"""

from __future__ import annotations

import io
import logging
import os
import struct
from typing import List

import numpy as np

logger = logging.getLogger(__name__)


def _to_hwc_uint8(img, batch_index: int) -> np.ndarray:
    arr = np.asarray(img)
    if arr.ndim == 4:  # (B, 3, H, W)
        arr = arr[batch_index]
    if arr.shape[0] in (1, 3) and arr.ndim == 3:  # CHW -> HWC
        arr = arr.transpose(1, 2, 0)
    return arr.astype(np.uint8)


def write_mjpeg_avi(frames: List[np.ndarray], filename: str, fps: int = 10,
                    quality: int = 90) -> None:
    """Minimal MJPEG AVI muxer (single video stream, index included)."""
    from PIL import Image

    h, w = frames[0].shape[:2]
    jpegs = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="JPEG", quality=quality)
        data = buf.getvalue()
        if len(data) % 2:
            data += b"\x00"
        jpegs.append(data)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    n = len(jpegs)
    max_bytes = max(len(j) for j in jpegs)
    avih = struct.pack("<14I", int(1e6 / fps), max_bytes * fps, 0, 0x10,
                       n, 0, 1, max_bytes, w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"MJPG" + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps,
                                            0, n, max_bytes, 0xFFFFFFFF, 0)
            + struct.pack("<4H", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi_items = b"".join(chunk(b"00dc", j) for j in jpegs)
    movi = lst(b"movi", movi_items)
    # idx1 index
    idx = b""
    offset = 4
    for j in jpegs:
        idx += b"00dc" + struct.pack("<III", 0x10, offset, len(j))
        offset += 8 + len(j)
    idx1 = chunk(b"idx1", idx)
    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(filename, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


def save_video(imgs, filename: str, batch_index: int = 0, fps: int = 10,
               web_browser_friendly: bool = False) -> str:
    """Write recorded birdviews to disk.

    imgs: sequence of (B, 3, H, W) or (3, H, W) uint8 frames.
    Returns the path actually written.
    """
    frames = [_to_hwc_uint8(img, batch_index) for img in imgs]
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".gif":
        from PIL import Image

        pil = [Image.fromarray(f) for f in frames]
        pil[0].save(filename, save_all=True, append_images=pil[1:],
                    duration=int(1000 / fps), loop=0)
        return filename
    if ext == ".mp4":
        target = filename[:-4] + ".avi"
        logger.info("no mp4 encoder available; writing MJPEG AVI to %s", target)
        filename = target
    write_mjpeg_avi(frames, filename, fps=fps)
    return filename
