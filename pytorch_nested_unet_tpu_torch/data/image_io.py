"""Image I/O of the port (the cv2.imread / cv2.resize / cv2.imwrite calls of the
JAX package's data path, data/native.py, val.py and infer.py).

Decoding, resizing and encoding run in the C++ library `csrc/image_io.cpp`,
built by g++ at first use into the package's `_build/` directory (a failed
build raises with the compiler's output; there is no other decoder). Its PNG
codec needs zlib only; its JPEG codec (libjpeg, quality 95 when writing, as
cv2's default) is compiled in when g++ finds <jpeglib.h>, and `has_jpeg()`
says whether it was.

Images are BGR uint8 (H, W, 3) and masks gray uint8 (H, W), as cv2 gives
them. The plain numpy versions of the library's two resizes are kept here
(`resize_bilinear_plain`, `resize_nearest_plain`): the tests hold the C++
against them.
"""

import ctypes
import functools
import os
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "image_io.cpp")
_REASONS = {1: "cannot be opened", 2: "is neither a PNG nor a JPEG",
            3: "is corrupt or an unsupported variant of its format",
            4: "is a JPEG, and the image library was built without a JPEG codec "
               "(g++ found no <jpeglib.h>)"}
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_IP = ctypes.POINTER(ctypes.c_int)


class ImageError(OSError):
    """An image file that the library could not read or write."""


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    flags = ("-DNU_JPEG", "-lz", "-ljpeg") if _build.gxx_finds_header("jpeglib.h") else ("-lz",)
    lib = _build.load_host(SRC, flags)
    lib.nu_features.restype = ctypes.c_int
    lib.nu_probe.restype = ctypes.c_int
    lib.nu_probe.argtypes = [ctypes.c_char_p, _IP, _IP, _IP]
    lib.nu_load_batch.restype = ctypes.c_int
    lib.nu_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _U8P,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, _IP, _IP]
    lib.nu_resize.restype = None
    lib.nu_resize.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.nu_union_masks.restype = None
    lib.nu_union_masks.argtypes = [_U8P, ctypes.c_int, ctypes.c_longlong, _U8P]
    lib.nu_write.restype = ctypes.c_int
    lib.nu_write.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def _ptr(a: np.ndarray, kind=_U8P):
    return a.ctypes.data_as(kind)


def has_jpeg() -> bool:
    """Whether the library (built now if needed) has its JPEG codec."""
    return bool(_lib().nu_features() & 2)


def image_error(path: str, code: int) -> ImageError:
    """The ImageError of a status code of decode_batch or probe."""
    return ImageError(f"{path} {_REASONS.get(code, f'failed (code {code})')}")


def probe(path: str) -> Tuple[int, int, int]:
    """(height, width, channels) from the file's header; raises ImageError
    naming the path when it cannot be read."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _lib().nu_probe(os.fsencode(path), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc:
        raise image_error(path, rc)
    return h.value, w.value, c.value


def decode_batch(paths: Sequence[str], size_hw: Tuple[int, int], channels: int = 3,
                 nearest: bool = False, num_threads: int = 0):
    """Decode and resize `paths` on the library's threads, trying every path.

    Returns (images (N, H, W, channels) uint8, status (N,) int32 with 0 where
    the image was read, source sizes (N, 2) int32). channels 3 gives BGR,
    1 gray; nearest selects the masks' resize, else bilinear.
    """
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    n = len(paths)
    h, w = int(size_hw[0]), int(size_hw[1])
    out = np.empty((n, h, w, channels), np.uint8)
    status = np.zeros(n, np.int32)
    sizes = np.zeros((n, 2), np.int32)
    if n:
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        _lib().nu_load_batch(arr, n, _ptr(out), h, w, channels, int(nearest), num_threads,
                             _ptr(status, _IP), _ptr(sizes, _IP))
    return out, status, sizes


def load_batch(paths: Sequence[str], size_hw: Tuple[int, int], channels: int = 3,
               nearest: bool = False, num_threads: int = 0) -> np.ndarray:
    """decode_batch's images; raises ImageError naming the first path that
    could not be read."""
    out, status, _ = decode_batch(paths, size_hw, channels, nearest, num_threads)
    bad = np.flatnonzero(status)
    if len(bad):
        raise image_error(paths[bad[0]], int(status[bad[0]]))
    return out


def load_image(path: str, channels: int = 3) -> np.ndarray:
    """One image at its own size: (H, W, 3) BGR or (H, W) gray uint8."""
    h, w, _ = probe(path)
    img = load_batch([path], (h, w), channels)[0]
    return img if channels == 3 else img[..., 0]


def _write(path: str, image: np.ndarray, fmt: str, quality: int = 95):
    image = np.ascontiguousarray(image)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"expected (H,W) gray or (H,W,3) BGR uint8, got {image.dtype} "
                         f"{image.shape}")
    c = 1 if image.ndim == 2 else 3
    rc = _lib().nu_write(os.fsencode(path), _ptr(image), image.shape[0], image.shape[1], c,
                         ord(fmt), quality)
    if rc:
        raise ImageError(f"{path}: write failed ({_REASONS.get(rc, f'code {rc}')})"
                         if rc != 1 else f"{path} cannot be opened for writing")


def write_png(path: str, image: np.ndarray):
    """Write (H,W) gray or (H,W,3) BGR uint8 as a PNG (cv2.imwrite's layout)."""
    _write(path, image, "P")


def write_jpg(path: str, image: np.ndarray, quality: int = 95):
    """Write (H,W) gray or (H,W,3) BGR uint8 as a baseline 4:2:0 JPEG."""
    _write(path, image, "J", quality)


def write_image(path: str, image: np.ndarray):
    """write_png or write_jpg by the path's extension (.png, .jpg, .jpeg)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, image)
    elif ext in (".jpg", ".jpeg"):
        write_jpg(path, image)
    else:
        raise ValueError(f"{path}: extension must be .png, .jpg or .jpeg")


def union_masks(masks: np.ndarray) -> np.ndarray:
    """Union per-instance masks (>127) into one binary mask*255 (the DSB2018
    preprocessing inner loop, reference preprocess_dsb2018.py:33-36)."""
    masks = np.ascontiguousarray(masks, np.uint8)
    n, h, w = masks.shape
    out = np.empty((h, w), np.uint8)
    _lib().nu_union_masks(_ptr(masks), n, h * w, _ptr(out))
    return out


def resize(image: np.ndarray, size_hw: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    """The library's resize of one (H, W, C) uint8 array."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    out = np.empty((int(size_hw[0]), int(size_hw[1]), c), np.uint8)
    _lib().nu_resize(_ptr(image), h, w, c, _ptr(out), out.shape[0], out.shape[1], int(nearest))
    return out


def _bilinear_taps(n_in: int, n_out: int):
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    f = np.maximum(f, 0.0)
    i0 = np.minimum(f.astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, f - i0


def resize_bilinear_plain(image: np.ndarray, size_hw: Tuple[int, int],
                          round_u8: bool = True) -> np.ndarray:
    """Plain numpy version of the library's bilinear resize (half-pixel
    centres, float64 weights, the same order of operations). round_u8 rounds
    half away from zero (C's lround, not np.round's half to even) and clips
    to uint8; without it the float64 result is returned."""
    src = np.asarray(image, np.float64)
    y0, y1, wy = _bilinear_taps(src.shape[0], int(size_hw[0]))
    x0, x1, wx = _bilinear_taps(src.shape[1], int(size_hw[1]))
    wy = wy.reshape(-1, 1, *([1] * (src.ndim - 2)))
    wx = wx.reshape(1, -1, *([1] * (src.ndim - 2)))
    p00, p01 = src[y0][:, x0], src[y0][:, x1]
    p10, p11 = src[y1][:, x0], src[y1][:, x1]
    v = (1 - wy) * ((1 - wx) * p00 + wx * p01) + wy * ((1 - wx) * p10 + wx * p11)
    if not round_u8:
        return v
    return np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8)


def resize_nearest_plain(image: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Plain numpy version of the library's nearest resize (floor indexing)."""
    h, w = image.shape[:2]
    oh, ow = int(size_hw[0]), int(size_hw[1])
    yy = np.minimum((np.arange(oh, dtype=np.float64) * h / oh).astype(np.int64), h - 1)
    xx = np.minimum((np.arange(ow, dtype=np.float64) * w / ow).astype(np.int64), w - 1)
    return np.asarray(image)[yy][:, xx]


def resize_prob(m: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize an (H, W) float32 probability map to (h, w) bilinearly with
    half-pixel centres (cv2.resize INTER_LINEAR on floats), on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(m, np.float32))[None, None]
    return F.interpolate(t, size=(int(h), int(w)), mode="bilinear",
                         align_corners=False)[0, 0].numpy()
