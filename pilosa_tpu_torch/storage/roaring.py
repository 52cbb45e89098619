"""The official RoaringBitmap serialization, both ways.

The reference's roaring package reads and writes the official
interchange format (roaring/roaring.go:1730 WriteTo,
unmarshal_binary.go: cookies 12346 and 12347 of the RoaringFormatSpec).
This is its 32-bit form, as the JAX package has it: a fragment import
ships one blob a row id of shard-relative columns (the reference's
importRoaring path, fragment.go:2038, without its 64-bit container
keys), and an export answers one.  ``decode`` reads array, bitmap and
run containers; ``encode`` writes the no-run form (cookie 12346) with
the JAX package's bytes.  ``from_words`` gives a row's packed uint32
words as values.
"""

from __future__ import annotations

import struct

import numpy as np

from pilosa_tpu_torch.ops import bitmap as bm

SERIAL_COOKIE_NO_RUN = 12346
SERIAL_COOKIE = 12347
NO_OFFSET_THRESHOLD = 4
_ARRAY_MAX = 4096          # cardinality <= this encodes as array
_BITMAP_BYTES = 8192


class RoaringError(ValueError):
    pass


def decode(buf: bytes) -> np.ndarray:
    """Deserialize official-format bytes -> sorted uint32 values."""
    if len(buf) < 4:
        raise RoaringError("short roaring buffer")
    cookie = struct.unpack_from("<I", buf, 0)[0]
    if (cookie & 0xFFFF) == SERIAL_COOKIE:
        n = (cookie >> 16) + 1
        off = 4
        flag_bytes = (n + 7) // 8
        run_flags = np.unpackbits(
            np.frombuffer(buf, np.uint8, flag_bytes, off),
            bitorder="little")[:n].astype(bool)
        off += flag_bytes
        has_offsets = n >= NO_OFFSET_THRESHOLD
    elif cookie == SERIAL_COOKIE_NO_RUN:
        n = struct.unpack_from("<I", buf, 4)[0]
        off = 8
        run_flags = np.zeros(n, dtype=bool)
        has_offsets = True
    else:
        raise RoaringError(f"bad roaring cookie {cookie}")
    keys = np.zeros(n, dtype=np.uint32)
    cards = np.zeros(n, dtype=np.int64)
    for i in range(n):
        k, c = struct.unpack_from("<HH", buf, off + 4 * i)
        keys[i], cards[i] = k, c + 1
    off += 4 * n
    if has_offsets:
        off += 4 * n  # offsets are redundant for sequential decode
    out = []
    for i in range(n):
        base = np.uint32(keys[i]) << np.uint32(16)
        if run_flags[i]:
            n_runs = struct.unpack_from("<H", buf, off)[0]
            off += 2
            pairs = np.frombuffer(buf, np.uint16, 2 * n_runs, off
                                  ).astype(np.int64).reshape(-1, 2)
            off += 4 * n_runs
            lengths = pairs[:, 1] + 1
            starts = np.repeat(pairs[:, 0], lengths)
            steps = np.arange(int(lengths.sum())) - np.repeat(
                np.concatenate(([0], np.cumsum(lengths)[:-1])), lengths)
            vals = (starts + steps).astype(np.uint32)
        elif cards[i] <= _ARRAY_MAX:
            vals = np.frombuffer(buf, np.uint16, int(cards[i]), off
                                 ).astype(np.uint32)
            off += 2 * int(cards[i])
        else:
            bits = np.unpackbits(
                np.frombuffer(buf, np.uint8, _BITMAP_BYTES, off),
                bitorder="little")
            off += _BITMAP_BYTES
            vals = np.nonzero(bits)[0].astype(np.uint32)
        out.append(base | vals)
    return (np.concatenate(out) if out
            else np.array([], dtype=np.uint32))


def encode(values) -> bytes:
    """Serialize sorted-able uint32 values in the no-run official
    format (cookie 12346 — every reader supports it; the reference
    likewise writes without optimizing to runs unless asked).
    Values must fit uint32 — the official interop format is 32-bit;
    silently truncating would corrupt round-trips."""
    raw = np.asarray(values, dtype=np.uint64)
    if raw.size and int(raw.max()) > 0xFFFFFFFF:
        raise RoaringError(
            "official roaring format holds 32-bit values only")
    vals = np.unique(raw.astype(np.uint32))
    keys = (vals >> np.uint32(16)).astype(np.uint16)
    uniq_keys, starts = np.unique(keys, return_index=True)
    bounds = list(starts) + [len(vals)]
    n = len(uniq_keys)
    head = struct.pack("<II", SERIAL_COOKIE_NO_RUN, n)
    desc = b"".join(
        struct.pack("<HH", int(k), int(bounds[i + 1] - bounds[i] - 1))
        for i, k in enumerate(uniq_keys))
    bodies = []
    for i in range(n):
        lows = (vals[bounds[i]:bounds[i + 1]] & np.uint32(0xFFFF)
                ).astype(np.uint16)
        if lows.size <= _ARRAY_MAX:
            bodies.append(lows.tobytes())
        else:
            bits = np.zeros(1 << 16, dtype=np.uint8)
            bits[lows] = 1
            bodies.append(np.packbits(bits, bitorder="little").tobytes())
    offsets = []
    pos = len(head) + len(desc) + 4 * n
    for b in bodies:
        offsets.append(struct.pack("<I", pos))
        pos += len(b)
    return head + desc + b"".join(offsets) + b"".join(bodies)


def from_words(words) -> np.ndarray:
    """Packed uint32 row words -> the set columns as uint32 values."""
    return bm.to_columns(words).astype(np.uint32)
