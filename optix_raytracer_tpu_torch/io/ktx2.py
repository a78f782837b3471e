"""KTX2 texture container (counterpart of `io/ktx2.py:38-143`): the
uncompressed 8-bit formats with supercompression NONE, ZSTD or ZLIB, the
payload of glTF's KHR_texture_basisu images. numpy and zlib only; a ZSTD
payload needs the `zstandard` package, imported where it is read or
written, and BasisLZ / UASTC transcoding raises.

Layout (KTX 2.0 spec §3): 12-byte identifier; 9 u32 header words
(vkFormat, typeSize, width, height, depth, layerCount, faceCount,
levelCount, supercompressionScheme); dfd/kvd/sgd index; a level index of
(byteOffset, byteLength, uncompressedByteLength) u64 triplets ordered
largest mip last in the file but indexed level 0 first.
"""
from __future__ import annotations

import struct

import numpy as np

_IDENTIFIER = b"\xabKTX 20\xbb\r\n\x1a\n"

# vkFormat → (channels, srgb)
_FORMATS = {
    9: (1, False),     # VK_FORMAT_R8_UNORM
    15: (1, True),     # VK_FORMAT_R8_SRGB
    16: (2, False),    # VK_FORMAT_R8G8_UNORM
    22: (2, True),     # VK_FORMAT_R8G8_SRGB
    23: (3, False),    # VK_FORMAT_R8G8B8_UNORM
    29: (3, True),     # VK_FORMAT_R8G8B8_SRGB
    37: (4, False),    # VK_FORMAT_R8G8B8A8_UNORM
    43: (4, True),     # VK_FORMAT_R8G8B8A8_SRGB
}

_SUPER_NONE, _SUPER_BASISLZ, _SUPER_ZSTD, _SUPER_ZLIB = 0, 1, 2, 3


def is_ktx2(data: bytes) -> bool:
    return data[:12] == _IDENTIFIER


def read_ktx2(src, level: int = 0):
    """Read one mip level → uint8 [H, W, C] (C per the vkFormat).

    src: path or bytes. Returns (pixels, srgb_flag)."""
    data = src if isinstance(src, (bytes, bytearray)) else open(src,
                                                                "rb").read()
    if not is_ktx2(data):
        raise ValueError("not a KTX2 file")
    (vk_format, _type_size, width, height, depth, layer_count, face_count,
     level_count, scheme) = struct.unpack_from("<9I", data, 12)
    if vk_format not in _FORMATS:
        if scheme == _SUPER_BASISLZ or vk_format == 0:
            raise NotImplementedError(
                "KTX2 BasisLZ/UASTC transcoding not supported — "
                "use uncompressed/zstd/zlib KTX2")
        raise NotImplementedError(f"KTX2 vkFormat {vk_format} not supported")
    if depth > 1 or layer_count > 1 or face_count > 1:
        raise NotImplementedError("only 2D single-layer KTX2 supported")
    channels, srgb = _FORMATS[vk_format]

    n_levels = max(level_count, 1)
    if not 0 <= level < n_levels:
        raise ValueError(f"level {level} out of range ({n_levels} levels)")
    # index block: dfd (2 u32) + kvd (2 u32) + sgd (2 u64), then levels
    level_index_off = 12 + 36 + 8 + 8 + 16
    off, length, uncomp = struct.unpack_from(
        "<3Q", data, level_index_off + 24 * level)
    payload = data[off:off + length]
    if scheme == _SUPER_ZSTD:
        import zstandard
        payload = zstandard.ZstdDecompressor().decompress(
            payload, max_output_size=max(uncomp, 1))
    elif scheme == _SUPER_ZLIB:
        import zlib
        payload = zlib.decompress(payload)
    elif scheme != _SUPER_NONE:
        raise NotImplementedError(
            f"KTX2 supercompression scheme {scheme} not supported")

    w = max(width >> level, 1)
    h = max(height >> level, 1)
    want = w * h * channels
    if len(payload) < want:
        raise ValueError("KTX2 level data truncated")
    img = np.frombuffer(payload, np.uint8, want).reshape(h, w, channels)
    return img, srgb


def read_ktx2_rgba(src, level: int = 0) -> np.ndarray:
    """Read one mip level as uint8 RGBA (grey/RG expand, alpha fills 255)."""
    img, _srgb = read_ktx2(src, level)
    h, w, c = img.shape
    out = np.empty((h, w, 4), np.uint8)
    if c == 1:
        out[..., 0] = out[..., 1] = out[..., 2] = img[..., 0]
        out[..., 3] = 255
    elif c == 2:
        out[..., 0] = out[..., 1] = out[..., 2] = img[..., 0]
        out[..., 3] = img[..., 1]
    elif c == 3:
        out[..., :3] = img
        out[..., 3] = 255
    else:
        out[:] = img
    return out


def write_ktx2(path: str, pixels: np.ndarray, srgb: bool = False,
               supercompression: str = "ZSTD") -> None:
    """Write uint8 [H, W, C] pixels as a single-level 2D KTX2 file.

    Mainly a test/fixture generator; supercompression: NONE/ZSTD/ZLIB."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    h, w, c = pixels.shape
    vk = {(1, False): 9, (1, True): 15, (2, False): 16, (2, True): 22,
          (3, False): 23, (3, True): 29, (4, False): 37, (4, True): 43}[
              (c, srgb)]
    raw = pixels.tobytes()
    scheme = {"NONE": _SUPER_NONE, "ZSTD": _SUPER_ZSTD,
              "ZLIB": _SUPER_ZLIB}[supercompression.upper()]
    if scheme == _SUPER_ZSTD:
        import zstandard
        payload = zstandard.ZstdCompressor().compress(raw)
    elif scheme == _SUPER_ZLIB:
        import zlib
        payload = zlib.compress(raw)
    else:
        payload = raw

    # minimal-but-valid DFD for an unsized 8-bit format block
    dfd = struct.pack("<I", 4)       # dfdTotalSize only (no descriptors)
    header = _IDENTIFIER + struct.pack(
        "<9I", vk, 1, w, h, 0, 0, 1, 1, scheme)
    level_index_off = 12 + 36 + 8 + 8 + 16
    dfd_off = level_index_off + 24
    data_off = dfd_off + len(dfd)
    index = struct.pack("<IIIIQQ", dfd_off, len(dfd), 0, 0, 0, 0)
    levels = struct.pack("<3Q", data_off, len(payload), len(raw))
    with open(path, "wb") as f:
        f.write(header + index + levels + dfd + payload)
