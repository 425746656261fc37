"""Image IO: Radiance .hdr (RGBE), PNG, npy and OpenEXR, the port of the JAX
package's ``utils/image.py`` (host numpy and the standard library; callers
move tensors to the host first).

Replaces the reference's stb-based Image::Store / stbi_loadf
(Image.cpp:49-74): ``store`` writes the resolved framebuffer by extension
(row 0 = top, as the reference flips on store), and ``read_hdr`` reads .hdr
environment maps for the sky. The RGBE codec is ``csrc/rgbe.cpp``
(``utils/native.py``, built at first use); ``rgbe_encode_np`` /
``rgbe_decode_np`` are its plain versions. PNG is written with ``zlib``
and ``struct`` alone, so no imaging package is needed.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from . import native


def rgbe_encode_np(rgb: np.ndarray) -> np.ndarray:
    """float32 [H,W,3] -> uint8 [H,W,4] RGBE."""
    rgb = np.maximum(rgb.astype(np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    out = np.zeros((*rgb.shape[:2], 4), np.uint8)
    valid = maxc >= 1e-32
    # frexp: maxc = m * 2^e with m in [0.5, 1)
    m, e = np.frexp(np.where(valid, maxc, 1.0))
    scale = m * 256.0 / np.where(valid, maxc, 1.0)
    for c in range(3):
        out[..., c] = np.where(valid, np.minimum(255, rgb[..., c] * scale),
                               0).astype(np.uint8)
    out[..., 3] = np.where(valid, e + 128, 0).astype(np.uint8)
    return out


def rgbe_decode_np(rgbe: np.ndarray) -> np.ndarray:
    """uint8 [H,W,4] RGBE -> float32 [H,W,3]."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def encode_hdr(rgb: np.ndarray) -> bytes:
    """The bytes of a Radiance .hdr file (flat, non-RLE scanlines:
    universally readable). rgb: [H,W,3] float32 linear radiance, row 0 =
    top."""
    rgb = np.ascontiguousarray(np.asarray(rgb, np.float32))
    h, w = rgb.shape[:2]
    return (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {h} +X {w}\n".encode() + native.rgbe_encode(rgb).tobytes())


def write_hdr(path, rgb: np.ndarray):
    """Write ``encode_hdr(rgb)`` to `path`."""
    Path(path).write_bytes(encode_hdr(rgb))


def _rle_scanline(payload: bytes, off: int, w: int):
    """One new-style RLE scanline (after its 4-byte marker): ([w, 4] uint8,
    offset after it). Each channel is a sequence of runs (count > 128: the
    next byte count - 128 times) and literals (count bytes)."""
    row = np.empty((4, w), np.uint8)
    for c in range(4):
        x = 0
        while x < w:
            n = payload[off]
            off += 1
            if n > 128:  # run
                row[c, x:x + n - 128] = payload[off]
                off += 1
                x += n - 128
            else:  # literal
                row[c, x:x + n] = np.frombuffer(payload, np.uint8, n, off)
                off += n
                x += n
    return row.T, off


def read_hdr(path) -> np.ndarray:
    """Read a Radiance .hdr file (flat or RLE scanlines) -> [H,W,3] f32."""
    data = Path(path).read_bytes()
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2 if b"\n\n" in data else 0
    nl = data.index(b"\n", pos)
    dims = data[pos:nl].decode()
    parts = dims.split()
    if len(parts) != 4 or parts[0] != "-Y" or parts[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {dims!r}")
    h, w = int(parts[1]), int(parts[3])
    payload = data[nl + 1:]
    rgbe = np.empty((h, w, 4), np.uint8)
    off = 0
    for y in range(h):
        # new-style RLE scanline marker: 0x02 0x02 hi lo
        if (len(payload) - off >= 4 and payload[off] == 2
                and payload[off + 1] == 2
                and (payload[off + 2] << 8 | payload[off + 3]) == w):
            rgbe[y], off = _rle_scanline(payload, off + 4, w)
        else:  # flat scanline
            rgbe[y] = np.frombuffer(payload, np.uint8, w * 4,
                                    off).reshape(w, 4)
            off += w * 4
    return native.rgbe_decode(rgbe)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> the bytes of an 8-bit RGB PNG, row 0 at the top
    (every scanline with filter type 0)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, not {arr.shape}")
    h, w = arr.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # a filter byte, then the row
    raw[:, 1:] = arr.reshape(h, 3 * w)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_png(path, rgb: np.ndarray):
    """Write an 8-bit PNG from [H,W,3] float32 in [0,1], row 0 = top."""
    arr = (np.clip(np.asarray(rgb), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Path(path).write_bytes(encode_png(arr))


def write_npy(path, rgb: np.ndarray):
    np.save(path, np.asarray(rgb, np.float32))


# --------------------------------------------------------------------------
# Minimal OpenEXR 2.0 (single-part, scanline, NO_COMPRESSION, FLOAT
# channels), byte for byte the JAX package's writer. The reference exports
# .hdr only (Image.cpp:71-74); EXR is the industry interchange format, and
# AOVs ride the same file as extra channels.
# --------------------------------------------------------------------------
_EXR_MAGIC = 20000630


def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + np.int32(len(data)).tobytes() + data


def write_exr(path, rgb: np.ndarray = None, channels: dict = None):
    """Write an uncompressed FLOAT scanline EXR. `rgb` [H, W, 3] becomes
    channels R/G/B; `channels` adds (or fully specifies) named [H, W]
    planes, e.g. {'N.X': nx, 'depth.Z': z}."""
    planes = {}
    if rgb is not None:
        img = np.asarray(rgb, np.float32)
        planes.update({"R": img[:, :, 0], "G": img[:, :, 1],
                       "B": img[:, :, 2]})
    for k, v in (channels or {}).items():
        planes[k] = np.asarray(v, np.float32)
    names = sorted(planes)  # EXR requires an alphabetized channel list
    h, w = planes[names[0]].shape
    # channel entry: {name\0, pixel_type=2 (FLOAT), pLinear=0 + reserved[3],
    # xSampling=1, ySampling=1}; list terminated by one null byte
    chlist = b"".join(
        n.encode() + b"\0" + np.int32(2).tobytes() + b"\0\0\0\0"
        + np.int32(1).tobytes() + np.int32(1).tobytes()
        for n in names) + b"\0"
    box = np.array([0, 0, w - 1, h - 1], np.int32).tobytes()
    header = (
        _exr_attr(b"channels", b"chlist", chlist)
        + _exr_attr(b"compression", b"compression", b"\0")
        + _exr_attr(b"dataWindow", b"box2i", box)
        + _exr_attr(b"displayWindow", b"box2i", box)
        + _exr_attr(b"lineOrder", b"lineOrder", b"\0")
        + _exr_attr(b"pixelAspectRatio", b"float", np.float32(1).tobytes())
        + _exr_attr(b"screenWindowCenter", b"v2f",
                    np.zeros(2, np.float32).tobytes())
        + _exr_attr(b"screenWindowWidth", b"float", np.float32(1).tobytes())
        + b"\0")
    preamble = np.array([_EXR_MAGIC, 2], np.int32).tobytes() + header
    # scanline blocks: y:int32, byte count:int32, then one full row per
    # channel in chlist order
    row_bytes = len(names) * w * 4
    block = 8 + row_bytes
    offset0 = len(preamble) + 8 * h
    offsets = (offset0 + block * np.arange(h, dtype=np.uint64)).tobytes()
    rows = np.stack([planes[n] for n in names], axis=1)  # [H, nch, W]
    head = np.empty((h, 2), np.int32)
    head[:, 0] = np.arange(h)
    head[:, 1] = row_bytes
    body = np.concatenate(
        [head.view(np.uint8),
         np.ascontiguousarray(rows).reshape(h, -1).view(np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(offsets)
        f.write(body.tobytes())


def read_exr_channels(path) -> dict:
    """Read an EXR written by write_exr: {name: [H, W] float32}.
    Uncompressed FLOAT scanlines only."""
    raw = Path(path).read_bytes()
    if np.frombuffer(raw[:8], np.int32)[0] != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    w = h = None
    names = []
    while raw[pos] != 0:  # attributes until the null terminator
        name_end = raw.index(b"\0", pos)
        name = raw[pos:name_end]
        typ_end = raw.index(b"\0", name_end + 1)
        size = int(np.frombuffer(raw[typ_end + 1:typ_end + 5], np.int32)[0])
        data = raw[typ_end + 5:typ_end + 5 + size]
        if name == b"dataWindow":
            x0, y0, x1, y1 = np.frombuffer(data, np.int32)
            w, h = int(x1 - x0 + 1), int(y1 - y0 + 1)
        elif name == b"compression" and data != b"\0":
            raise ValueError("only NO_COMPRESSION EXR files are read")
        elif name == b"channels":
            cpos = 0
            while data[cpos] != 0:
                cend = data.index(b"\0", cpos)
                names.append(data[cpos:cend].decode())
                if np.frombuffer(data[cend + 1:cend + 5], np.int32)[0] != 2:
                    raise ValueError("only FLOAT EXR channels are read")
                cpos = cend + 17  # name\0 + 4 type + 4 pLinear + 4 + 4
        pos = typ_end + 5 + size
    pos += 1 + 8 * h  # header terminator, offset table
    nch = len(names)
    out = np.empty((h, nch, w), np.float32)
    row_bytes = nch * w * 4
    for _ in range(h):
        y = int(np.frombuffer(raw[pos:pos + 4], np.int32)[0])
        out[y] = np.frombuffer(raw[pos + 8:pos + 8 + row_bytes],
                               np.float32).reshape(nch, w)
        pos += 8 + row_bytes
    return {n: out[:, i, :].copy() for i, n in enumerate(names)}


def read_exr(path) -> np.ndarray:
    """Read an EXR's R/G/B channels as [H, W, 3] float32."""
    ch = read_exr_channels(path)
    return np.stack([ch["R"], ch["G"], ch["B"]], axis=-1)


def store(path, rgb: np.ndarray):
    """Dispatch on extension (.hdr/.exr/.png/.npy), the Image::Store slot."""
    path = str(path)
    if path.endswith(".hdr"):
        write_hdr(path, rgb)
    elif path.endswith(".exr"):
        write_exr(path, rgb)
    elif path.endswith(".png"):
        write_png(path, rgb)
    elif path.endswith(".npy"):
        write_npy(path, rgb)
    else:
        raise ValueError(f"unsupported image extension: {path}")
