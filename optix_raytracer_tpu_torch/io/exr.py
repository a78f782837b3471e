"""Minimal OpenEXR 2.0 codec: scanline images, HALF/FLOAT, NONE/ZIP/ZIPS/PIZ
(the port's own copy of `io/exr.py`, numpy only, unchanged in behaviour:
the port imports nothing of the JAX package).

No EXR library ships in this environment, so this implements the subset of
the format the reference's denoiser sample actually exchanges
(`SDK/optixDenoiser/optixDenoiser.cpp:51-104` loads beauty/albedo/normal/
flow EXRs and writes the denoised EXR): single-part scanline files,
compression NONE, ZIPS (zlib, 1 scanline/chunk) or ZIP (zlib, 16
scanlines/chunk), HALF or FLOAT channels, written from numpy.

Format notes (from the published OpenEXR file layout):
- magic 0x76 0x2f 0x31 0x01, version int32 = 2 (no tiles, no multipart)
- header = attribute list (name\\0 type\\0 size data), empty name ends it
- required attributes: channels, compression, dataWindow, displayWindow,
  lineOrder, pixelAspectRatio, screenWindowCenter, screenWindowWidth
- channel list entries are sorted alphabetically and the pixel data of each
  scanline chunk stores channels in that order
- scanline chunk: int32 y, int32 byte-size, then per-channel rows
- an offset table (int64 per chunk) precedes the chunks
- zip chunks pre-process bytes with an even/odd split then a byte-delta
  predictor before deflate; a chunk whose deflate output would not shrink
  is stored raw (readers detect this by the stored size)
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_DTYPES = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
_COMP_NONE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ = 0, 2, 3, 4
_COMP_IDS = {"NONE": _COMP_NONE, "ZIPS": _COMP_ZIPS, "ZIP": _COMP_ZIP,
             "PIZ": _COMP_PIZ}
_LINES_PER_CHUNK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16,
                    _COMP_PIZ: 32}


def _zip_compress(raw: bytes) -> bytes:
    """OpenEXR zip pre-filter + deflate (ImfZip behavior)."""
    b = np.frombuffer(raw, np.uint8)
    half = (b.size + 1) // 2
    t = np.empty_like(b)
    t[:half] = b[0::2]
    t[half:] = b[1::2]
    d = t.astype(np.int16)
    d[1:] = (d[1:] - d[:-1] + (128 + 256)) & 0xFF
    packed = zlib.compress(d.astype(np.uint8).tobytes())
    return packed if len(packed) < len(raw) else raw


def _zip_decompress(data: bytes, raw_size: int) -> bytes:
    if len(data) == raw_size:        # stored raw (incompressible chunk)
        return data
    t = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int32)
    t[1:] -= 128 + 256
    t = (np.cumsum(t) & 0xFF).astype(np.uint8)
    half = (t.size + 1) // 2
    out = np.empty_like(t)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


# ---------------------------------------------------------------------------
# PIZ codec (wavelet + Huffman over 16-bit units) — implemented from the
# published OpenEXR PIZ format (ImfPizCompressor/ImfHuf/ImfWav semantics),
# validated against a tinyexr-written oracle file. Layout of one chunk:
#   u16 minNonZero, u16 maxNonZero, bitmap[min..max],
#   i32 hufLength, huf data (u32 im, u32 iM, u32 tableLen, u32 nBits,
#   u32 reserved, packed 6-bit code-length table, MSB-first bit stream).
# Data = per-channel planes of u16 (FLOAT splits into 2 u16 sub-planes),
# LUT-compacted via the bitmap, each plane 2D-wavelet transformed.
# ---------------------------------------------------------------------------

_HUF_ENCSIZE = (1 << 16) + 1          # one pseudo-symbol for RLE
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN   # 6


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.lc = 0

    def put(self, nbits: int, val: int):
        val = int(val)        # numpy ints would overflow the shift
        self.c = (self.c << nbits) | (val & ((1 << nbits) - 1))
        self.lc += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.out.append((self.c >> self.lc) & 0xFF)

    def done(self) -> bytes:
        if self.lc:
            self.out.append((self.c << (8 - self.lc)) & 0xFF)
            self.lc = 0
        return bytes(self.out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get(self, nbits: int) -> int:
        while self.lc < nbits:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.c = (self.c << 8) | b
            self.lc += 8
        self.lc -= nbits
        return (self.c >> self.lc) & ((1 << nbits) - 1)


def _canonical_codes(lengths: dict) -> dict:
    """Code-length dict {symbol: len} → {symbol: code}, exactly the
    hufCanonicalCodeTable assignment (codes counted per length, first code
    of each length derived longest-first, then assigned in symbol order)."""
    n = [0] * 59
    for l in lengths.values():
        n[l] += 1
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    codes = {}
    for sym in sorted(lengths):
        l = lengths[sym]
        codes[sym] = n[l]
        n[l] += 1
    return codes


def _huf_build_lengths(freq: dict) -> dict:
    """Plain heap Huffman over the present symbols → {symbol: length<=58}."""
    import heapq
    heap = [(f, sym, None, None) for sym, f in freq.items()]
    if len(heap) == 1:
        return {next(iter(freq)): 1}
    heapq.heapify(heap)
    cnt = 0
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        cnt += 1
        heapq.heappush(heap, (a[0] + b[0], _HUF_ENCSIZE + cnt, a, b))
    lengths = {}

    def walk(node, depth):
        if node[2] is None:
            lengths[node[1]] = max(1, depth)
        else:
            walk(node[2], depth + 1)
            walk(node[3], depth + 1)
    walk(heap[0], 0)
    assert max(lengths.values()) <= 58, "pathological Huffman depth"
    return lengths


def _huf_compress(data: np.ndarray) -> bytes:
    """u16 array → ImfHuf-format block."""
    vals, counts = np.unique(data, return_counts=True)
    freq = {int(v): int(c) for v, c in zip(vals, counts)}
    im = min(freq)
    iM = max(freq) + 1          # pseudo-symbol: the run-length code
    freq[iM] = 1
    lengths = _huf_build_lengths(freq)
    codes = _canonical_codes(lengths)

    # pack the code-length table (6-bit entries + zero-run codes)
    tw = _BitWriter()
    i = im
    while i <= iM:
        l = lengths.get(i, 0)
        if l == 0:
            zerun = 1
            while (i + zerun <= iM and zerun < 255 + _SHORTEST_LONG_RUN
                   and lengths.get(i + zerun, 0) == 0):
                zerun += 1
            if zerun >= _SHORTEST_LONG_RUN:
                tw.put(6, _LONG_ZEROCODE_RUN)
                tw.put(8, zerun - _SHORTEST_LONG_RUN)
                i += zerun
                continue
            if zerun >= 2:
                tw.put(6, _SHORT_ZEROCODE_RUN + zerun - 2)
                i += zerun
                continue
        tw.put(6, l)
        i += 1
    table = tw.done()

    # encode with run-length folding (sendCode semantics)
    bw = _BitWriter()
    arr = data.astype(np.int64)
    # split into runs of equal values, each capped at 256 (count byte 0-255)
    change = np.nonzero(np.diff(arr))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(arr)]])
    rl_code, rl_len = codes[iM], lengths[iM]
    for s, e in zip(starts, ends):
        sym = int(arr[s])
        code, cl = codes[sym], lengths[sym]
        total = e - s
        while total > 0:
            run = min(total, 256) - 1          # extra repeats after first
            if cl + rl_len + 8 < cl * (run + 1):
                bw.put(cl, code)
                bw.put(rl_len, rl_code)
                bw.put(8, run)
            else:
                for _ in range(run + 1):
                    bw.put(cl, code)
            total -= run + 1
    n_bits = bw.lc + 8 * len(bw.out)
    stream = bw.done()
    head = struct.pack("<IIIII", im, iM, len(table), n_bits, 0)
    return head + table + stream


def _huf_decompress(block: bytes, n_out: int) -> np.ndarray:
    im, iM, table_len, n_bits, _ = struct.unpack_from("<IIIII", block, 0)
    tr = _BitReader(block[20:20 + table_len])
    lengths = {}
    i = im
    while i <= iM:
        l = tr.get(6)
        if l == _LONG_ZEROCODE_RUN:
            i += tr.get(8) + _SHORTEST_LONG_RUN
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            if l:
                lengths[i] = l
            i += 1
    by_code = {(lengths[s], c): s
               for s, c in _canonical_codes(lengths).items()}
    # the bit stream starts byte-aligned after the packed table
    br = _BitReader(block[20 + table_len:])

    out = np.empty(n_out, np.uint16)
    n = 0
    c = 0
    lc = 0
    bits_left = n_bits
    while n < n_out:
        if bits_left <= 0:
            raise ValueError("PIZ: huf bit stream exhausted early")
        c = (c << 1) | br.get(1)
        lc += 1
        bits_left -= 1
        sym = by_code.get((lc, c))
        if sym is None:
            if lc > 58:
                raise ValueError("PIZ: bad huf code")
            continue
        c = lc = 0
        if sym == iM:                      # run-length marker
            run = br.get(8)
            bits_left -= 8
            if n == 0 or n + run > n_out:
                # matches hufUncompress's bounds checks: a run needs a
                # previous symbol to repeat and must fit the output —
                # malformed chunks must not leak uninitialized memory or
                # truncate silently
                raise ValueError("PIZ: bad huf run length")
            out[n:n + run] = out[n - 1]
            n += run
        else:
            out[n] = sym
            n += 1
    return out


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    return (ai.astype(np.int16).astype(np.uint16),
            (ai - hs).astype(np.int16).astype(np.uint16))


def _wenc14(a, b):
    ai = a.astype(np.int16).astype(np.int32)
    bi = b.astype(np.int16).astype(np.int32)
    m = (ai + bi) >> 1
    d = ai - bi
    return (m.astype(np.int16).astype(np.uint16),
            d.astype(np.int16).astype(np.uint16))


_MOD_MASK = 0xFFFF
_A_OFFSET = 1 << 15


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    m = (ao + b.astype(np.int32)) >> 1
    d = ao - b.astype(np.int32)
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wav2(plane: np.ndarray, max_value: int, decode: bool) -> None:
    """In-place 2D wavelet (ImfWav wav2Encode/Decode) on a [ny, nx] u16
    view. Vectorized per level: every 2x2 block at stride p2 transforms
    independently."""
    ny, nx = plane.shape
    w14 = max_value < (1 << 14)
    pair = (_wdec14 if decode else _wenc14) if w14 else (
        _wdec16 if decode else _wenc16)
    n = min(nx, ny)
    levels = []
    p = 1
    while 2 * p <= n:     # encode order: p = 1, 2, ... while p2 = 2p <= n
        levels.append(p)
        p <<= 1
    if decode:
        levels = levels[::-1]
    for p in levels:
        p2 = p << 1
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            yy, xx = np.meshgrid(ys, xs, indexing="ij")
            a00 = plane[yy, xx]
            a01 = plane[yy, xx + p]
            a10 = plane[yy + p, xx]
            a11 = plane[yy + p, xx + p]
            if decode:
                i00, i10 = pair(a00, a10)
                i01, i11 = pair(a01, a11)
                o00, o01 = pair(i00, i01)
                o10, o11 = pair(i10, i11)
            else:
                i00, i01 = pair(a00, a01)
                i10, i11 = pair(a10, a11)
                o00, o10 = pair(i00, i10)
                o01, o11 = pair(i01, i11)
            plane[yy, xx] = o00
            plane[yy, xx + p] = o01
            plane[yy + p, xx] = o10
            plane[yy + p, xx + p] = o11
        if nx & p and len(ys):                 # odd column (1D vertical)
            cx = (len(xs)) * p2 if len(xs) else 0
            a, b = pair(plane[ys, cx], plane[ys + p, cx])
            plane[ys, cx] = a
            plane[ys + p, cx] = b
        if ny & p and len(xs):                 # odd row (1D horizontal)
            cy = (len(ys)) * p2 if len(ys) else 0
            a, b = pair(plane[cy, xs], plane[cy, xs + p])
            plane[cy, xs] = a
            plane[cy, xs + p] = b


def _piz_compress(raw: bytes, w: int, n_lines: int, chan_sizes) -> bytes:
    """One chunk: scanline-interleaved raw bytes → PIZ block.
    chan_sizes: per (alphabetical) channel, its size in u16 units/sample."""
    scan_u16 = w * sum(chan_sizes)
    data = np.frombuffer(raw, "<u2").reshape(n_lines, scan_u16)
    # channel-planar tmp buffer
    planes = []
    col = 0
    for size in chan_sizes:
        planes.append(np.ascontiguousarray(
            data[:, col:col + w * size]))            # [ny, nx*size]
        col += w * size
    tmp = np.concatenate([p.reshape(-1) for p in planes])

    # bitmap + forward LUT
    bitmap = np.zeros(8192, np.uint8)
    present = np.unique(tmp).astype(np.int64)
    np.bitwise_or.at(bitmap, present >> 3,
                     (1 << (present & 7)).astype(np.uint8))
    bitmap[0] &= 0xFE                                 # zero never stored
    nz = np.nonzero(bitmap)[0]
    min_nz = int(nz[0]) if len(nz) else 8191
    max_nz = int(nz[-1]) if len(nz) else 0
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1                                       # zero always mapped
    lut = np.cumsum(bits).astype(np.uint16) - 1
    lut = np.where(bits.astype(bool), lut, 0).astype(np.uint16)
    max_value = int(lut.max())
    tmp = lut[tmp]

    # wavelet per channel plane (FLOAT = 2 interleaved u16 sub-planes)
    off = 0
    for size, p in zip(chan_sizes, planes):
        ny, row = p.shape
        nxs = row
        block = tmp[off:off + ny * nxs].reshape(ny, nxs)
        for j in range(size):
            _wav2(block[:, j::size], max_value, decode=False)
        off += ny * nxs

    huf = _huf_compress(tmp)
    out = struct.pack("<HH", min_nz, max_nz)
    if min_nz <= max_nz:
        out += bitmap[min_nz:max_nz + 1].tobytes()
    out += struct.pack("<i", len(huf)) + huf
    return out if len(out) < len(raw) else raw


def _piz_decompress(payload: bytes, raw_size: int, w: int, n_lines: int,
                    chan_sizes) -> bytes:
    if len(payload) == raw_size:                      # stored raw
        return payload
    min_nz, max_nz = struct.unpack_from("<HH", payload, 0)
    pos = 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        count = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(payload, np.uint8,
                                                  count, pos)
        pos += count
    huf_len = struct.unpack_from("<i", payload, pos)[0]
    pos += 4
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    rlut = np.nonzero(bits)[0].astype(np.uint16)      # compact → value
    max_value = len(rlut) - 1

    n_u16 = raw_size // 2
    tmp = _huf_decompress(payload[pos:pos + huf_len], n_u16)

    scan_u16 = w * sum(chan_sizes)
    off = 0
    cols = []
    for size in chan_sizes:
        nxs = w * size
        block = tmp[off:off + n_lines * nxs].reshape(n_lines, nxs)
        for j in range(size):
            _wav2(block[:, j::size], max_value, decode=True)
        cols.append(block)
        off += n_lines * nxs
    data = np.concatenate(cols, axis=1)
    assert data.shape == (n_lines, scan_u16)
    return rlut[data].astype("<u2").tobytes()


def _attr(name: str, typ: str, data: bytes) -> bytes:
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(data)) + data)


def _build_part(image, channels, pixel_type, compression, name=None):
    """One scanline part → (header_bytes_without_terminator, chunks) with
    chunks = [(y, payload)]. Shared by write_exr and write_exr_multipart
    (multipart parts additionally carry name/type/chunkCount attributes,
    required by the OpenEXR 2.0 multipart header rules)."""
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = image[..., None]
    h, w, nc = image.shape
    if channels is None:
        channels = {1: ("Y",), 2: ("R", "G"), 3: ("R", "G", "B"),
                    4: ("R", "G", "B", "A")}[nc]
    assert len(channels) == nc
    pt = {"HALF": _PT_HALF, "FLOAT": _PT_FLOAT}[pixel_type.upper()]
    dtype = _DTYPES[pt]
    bpp = np.dtype(dtype).itemsize

    # Channel list is stored (and pixel data laid out) alphabetically.
    order = sorted(range(nc), key=lambda i: channels[i])
    chlist = b""
    for i in order:
        chlist += (channels[i].encode() + b"\0"
                   + struct.pack("<i", pt) + struct.pack("<i", 0)
                   + struct.pack("<ii", 1, 1))
    chlist += b"\0"

    comp_id = _COMP_IDS[compression.upper()]
    lines = _LINES_PER_CHUNK[comp_id]
    n_chunks = -(-h // lines)
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (_attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([comp_id]))
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\0")          # increasing y
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f",
                      struct.pack("<ff", 0.0, 0.0))
              + _attr("screenWindowWidth", "float",
                      struct.pack("<f", 1.0)))
    if name is not None:
        header += (_attr("name", "string", name.encode())
                   + _attr("type", "string", b"scanlineimage")
                   + _attr("chunkCount", "int", struct.pack("<i", n_chunks)))

    rows = image[:, :, order].transpose(0, 2, 1).astype(dtype)  # [H, C, W]
    chan_sizes = [bpp // 2] * nc                     # u16 units per sample
    chunks = []
    for y in range(0, h, lines):
        raw = np.ascontiguousarray(rows[y:y + lines]).tobytes()
        if comp_id == _COMP_PIZ:
            raw = _piz_compress(raw, w, min(lines, h - y), chan_sizes)
        elif comp_id != _COMP_NONE:
            raw = _zip_compress(raw)
        chunks.append((y, raw))
    return header, chunks


def write_exr(path: str, image: np.ndarray, channels=None,
              pixel_type: str = "HALF", compression: str = "ZIP") -> None:
    """Write [H, W] / [H, W, C] float data as a scanline EXR.

    channels: names for the last axis; defaults to ("Y",), ("R","G","B") or
    ("R","G","B","A") by arity. pixel_type: "HALF" or "FLOAT".
    compression: "ZIP" (default; zlib, 16 scanlines per chunk), "ZIPS"
    (zlib, 1 scanline) or "NONE".
    """
    header, chunks = _build_part(image, channels, pixel_type, compression)
    head = _MAGIC + struct.pack("<i", 2) + header + b"\0"
    n_chunks = len(chunks)

    first = len(head) + 8 * n_chunks
    offsets, pos = [], first
    for _, payload in chunks:
        offsets.append(pos)
        pos += 8 + len(payload)
    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack("<%dq" % n_chunks, *offsets))
        for y, payload in chunks:
            f.write(struct.pack("<ii", y, len(payload)))
            f.write(payload)


def write_exr_multipart(path: str, parts) -> None:
    """Write a multipart (OpenEXR 2.0) scanline file.

    parts: list of (name, image) or (name, image, dict) with optional
    per-part keys channels / pixel_type / compression — the writer side
    of the multipart reads (`read_exr(part=...)`), mirroring tinyexr's
    SaveEXRMultipartImageToFile coverage (`SDK/support/tinyexr/`).
    Layout: version-flagged header sequence terminated by an empty
    header, one offset table per part in order, chunks prefixed with
    their part number.
    """
    built = []
    for p in parts:
        name, image, opts = (*p, {}) if len(p) == 2 else p
        built.append(_build_part(image, opts.get("channels"),
                                 opts.get("pixel_type", "HALF"),
                                 opts.get("compression", "ZIP"),
                                 name=name))
    head = _MAGIC + struct.pack("<i", 2 | 0x1000)
    for header, _ in built:
        head += header + b"\0"
    head += b"\0"                           # end of the header sequence

    pos = len(head) + 8 * sum(len(chunks) for _, chunks in built)
    tables = []
    for _, chunks in built:
        offsets = []
        for _, payload in chunks:
            offsets.append(pos)
            pos += 4 + 8 + len(payload)     # part number + y + size
        tables.append(offsets)
    with open(path, "wb") as f:
        f.write(head)
        for offsets in tables:
            f.write(struct.pack("<%dq" % len(offsets), *offsets))
        for idx, (_, chunks) in enumerate(built):
            for y, payload in chunks:
                f.write(struct.pack("<iii", idx, y, len(payload)))
                f.write(payload)


def _parse_header(data, pos):
    """One header (attribute list) starting at `pos` → (attrs, end_pos)."""
    attrs = {}
    while True:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        if not name:
            break
        end = data.index(b"\0", pos)
        pos = end + 1
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        attrs[name] = data[pos:pos + size]
        pos += size
    return attrs, pos


def read_exr_parts(path: str) -> list:
    """Part names of a (possibly multipart) EXR, in file order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    version = struct.unpack_from("<i", data, 4)[0]
    if not version & 0x1000:
        return [""]
    names, pos = [], 8
    while data[pos] != 0:
        attrs, pos = _parse_header(data, pos)
        names.append(attrs.get("name", b"").rstrip(b"\0").decode())
    return names


def read_exr(path: str, layers: bool = False, part=0):
    """Read a single- or multi-part scanline/tiled EXR
    (NONE/ZIPS/ZIP/PIZ compression; deep parts unsupported).

    part: index or name of the part to read (multipart files,
    `read_exr_parts` lists them). Returns float32 [H, W, C] with channels
    ordered R,G,B,A,(rest alphabetical) — or, with layers=True, a dict
    {channel_name: [H, W] f32}.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    version = struct.unpack_from("<i", data, 4)[0]
    multipart = bool(version & 0x1000)

    pos = 8
    if multipart:
        # header sequence (terminated by an empty header), then one
        # offset table per part in order; chunks carry a leading part
        # number which the readers skip via `lead`.
        headers = []
        while data[pos] != 0:
            attrs_i, pos = _parse_header(data, pos)
            headers.append(attrs_i)
        pos += 1
        if isinstance(part, str):
            names = [a.get("name", b"").rstrip(b"\0").decode()
                     for a in headers]
            part = names.index(part)
        if not 0 <= part < len(headers):
            raise ValueError(f"part {part} of a {len(headers)}-part file")
        for i, attrs_i in enumerate(headers):
            n_chunks = struct.unpack_from(
                "<i", attrs_i["chunkCount"], 0)[0]
            if i == part:
                attrs = attrs_i
                table_pos = pos
            pos += 8 * n_chunks
        ptype = attrs.get("type", b"scanlineimage").rstrip(b"\0")
        if ptype not in (b"scanlineimage", b"tiledimage"):
            raise NotImplementedError(f"deep EXR part {ptype!r}")
        tiled = ptype == b"tiledimage"
        pos = table_pos
        lead = 4                       # chunk part-number prefix
    else:
        attrs, pos = _parse_header(data, pos)
        tiled = bool(version & 0x200)
        lead = 0

    comp_id = attrs["compression"][0]
    if comp_id not in _LINES_PER_CHUNK:
        raise NotImplementedError(
            "only compression NONE/ZIPS/ZIP/PIZ supported (got type "
            f"{comp_id})")
    lines = _LINES_PER_CHUNK[comp_id]
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    chans = []          # (name, pixel_type) in file (alphabetical) order
    cpos = 0
    cl = attrs["channels"]
    while cl[cpos] != 0:
        end = cl.index(b"\0", cpos)
        cname = cl[cpos:end].decode()
        pt = struct.unpack_from("<i", cl, end + 1)[0]
        chans.append((cname, pt))
        cpos = end + 1 + 16
    row_bytes = {name: w * np.dtype(_DTYPES[pt]).itemsize
                 for name, pt in chans}

    out = {name: np.empty((h, w), np.float32) for name, _ in chans}
    if tiled:
        _read_tiles(data, pos, attrs, chans, out, comp_id, w, h, lead)
    else:
        _read_scanlines(data, pos, attrs, chans, out, comp_id, lines,
                        row_bytes, w, h, y0, lead)

    if layers:
        return out
    names = [n for n, _ in chans]
    front = [c for c in ("R", "G", "B", "A") if c in names]
    rest = sorted(n for n in names if n not in front)
    stacked = np.stack([out[n] for n in front + rest], axis=-1)
    return stacked


def _read_scanlines(data, pos, attrs, chans, out, comp_id, lines,
                    row_bytes, w, h, y0, lead=0):
    n_chunks = -(-h // lines)
    offsets = struct.unpack_from("<%dq" % n_chunks, data, pos)
    scan_bytes = sum(row_bytes.values())
    for off in offsets:
        off += lead                      # multipart: skip the part number
        y, size = struct.unpack_from("<ii", data, off)
        y -= y0
        n_lines = min(lines, h - y)
        payload = data[off + 8:off + 8 + size]
        if comp_id == _COMP_PIZ:
            payload = _piz_decompress(
                payload, n_lines * scan_bytes, w, n_lines,
                [np.dtype(_DTYPES[pt]).itemsize // 2 for _, pt in chans])
        elif comp_id != _COMP_NONE:
            payload = _zip_decompress(payload, n_lines * scan_bytes)
        p = 0
        for line in range(n_lines):
            for name, pt in chans:
                dt = _DTYPES[pt]
                row = np.frombuffer(payload, dt, count=w, offset=p)
                out[name][y + line] = row.astype(np.float32)
                p += row_bytes[name]


def _tile_counts(w, h, tw, th, mode):
    """Total chunk count of a tiled part (tinyexr-class coverage): the
    offset-table length depends on the level mode + rounding mode packed
    in the tiledesc `mode` byte (OpenEXR tiledesc)."""
    level_mode = mode & 0xF
    round_up = (mode >> 4) & 0xF == 1

    def n_levels(d):
        import math
        lv = (math.ceil if round_up else math.floor)(
            math.log2(max(d, 1)))
        return int(lv) + 1

    def lsize(d, lv):
        s = -(-d // (1 << lv)) if round_up else d // (1 << lv)
        return max(1, int(s))

    def ntiles(d, td):
        return -(-d // td)

    if level_mode == 0:                      # ONE_LEVEL
        return ntiles(w, tw) * ntiles(h, th)
    if level_mode == 1:                      # MIPMAP
        n = n_levels(max(w, h))
        return sum(ntiles(lsize(w, lv), tw) * ntiles(lsize(h, lv), th)
                   for lv in range(n))
    # RIPMAP
    nx, ny = n_levels(w), n_levels(h)
    return sum(ntiles(lsize(w, lx), tw) * ntiles(lsize(h, ly), th)
               for lx in range(nx) for ly in range(ny))


def _read_tiles(data, pos, attrs, chans, out, comp_id, w, h, lead=0):
    """Tiled single-part body: every chunk carries its own (dx, dy,
    levelx, levely) header, so levels are identified per chunk and only
    level (0, 0) fills the output — table ordering never matters."""
    tw, th_, mode = struct.unpack_from("<IIB", attrs["tiles"], 0)
    n_chunks = _tile_counts(w, h, tw, th_, mode)
    offsets = struct.unpack_from("<%dq" % n_chunks, data, pos)
    for off in offsets:
        off += lead                      # multipart: skip the part number
        dx, dy, lx, ly, size = struct.unpack_from("<iiiii", data, off)
        if lx or ly:
            continue                         # coarser mip/rip level
        tile_w = min(tw, w - dx * tw)
        tile_h = min(th_, h - dy * th_)
        payload = data[off + 20:off + 20 + size]
        t_row = {name: tile_w * np.dtype(_DTYPES[pt]).itemsize
                 for name, pt in chans}
        raw_size = tile_h * sum(t_row.values())
        if comp_id == _COMP_PIZ:
            payload = _piz_decompress(
                payload, raw_size, tile_w, tile_h,
                [np.dtype(_DTYPES[pt]).itemsize // 2 for _, pt in chans])
        elif comp_id != _COMP_NONE and size < raw_size:
            payload = _zip_decompress(payload, raw_size)
        p = 0
        for line in range(tile_h):
            yy = dy * th_ + line
            for name, pt in chans:
                dt = _DTYPES[pt]
                row = np.frombuffer(payload, dt, count=tile_w, offset=p)
                out[name][yy, dx * tw:dx * tw + tile_w] = \
                    row.astype(np.float32)
                p += t_row[name]
