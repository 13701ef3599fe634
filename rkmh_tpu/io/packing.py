"""2-bit packing of sequences into fixed-shape device tensors.

Compiled device programs need static shapes; ragged reads become [B, L] uint8 code
tensors (A=0 C=1 G=2 T=3, PAD/invalid=4+) plus a length vector.  Length
padding rounds up to a bucket boundary so jit recompiles are bounded
(one compiled program per bucket, amortized to zero over a stream).
"""

from __future__ import annotations

import numpy as np

PAD_CODE = np.uint8(255)

# byte -> 2-bit code; case-insensitive; everything non-ACGT is invalid (4)
CODE_LUT = np.full(256, 4, dtype=np.uint8)
for i, base in enumerate(b"ACGT"):
    CODE_LUT[base] = i
    CODE_LUT[base + 32] = i  # lowercase

ASCII_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def bucket_length(max_len: int, granularity: int = 128) -> int:
    """Static padded length for a batch: next multiple of `granularity`."""
    return max(round_up(max_len, granularity), granularity)


def encode_seqs(seqs: list[bytes], pad_to: int | None = None, granularity: int = 128):
    """Pack byte strings into ([B, L] uint8 codes, [B] int32 lengths).

    Padding positions get PAD_CODE (invalid), so padded windows hash to the
    0 sentinel and never enter a sketch — mirroring how rkmh simply has no
    such windows.
    """
    B = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=B)
    L = pad_to if pad_to is not None else bucket_length(int(lens.max(initial=0)), granularity)
    codes = np.full((B, L), PAD_CODE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = CODE_LUT[np.frombuffer(s, dtype=np.uint8)]
    return codes, lens


def pack_codes4(codes: np.ndarray):
    """[B, L] uint8 codes -> ([B, L/4] 2-bit-packed bases, [B, L/8]
    validity bitmask), L % 8 == 0.

    The device wire format for read batches: 0.375 B/base of
    host->device copy instead of 1.  Invalid
    bases/padding lose their exact byte value (restored as 255), which
    every consumer treats identically (only `code < 4` matters).
    """
    B, L = codes.shape
    assert L % 8 == 0, L
    from rkmh_tpu.io.native import pack4_native

    native = pack4_native(np.asarray(codes))
    if native is not None:
        return native
    return _pack_codes4_numpy(codes)


def _pack_codes4_numpy(codes: np.ndarray):
    """Pure-numpy pack_codes4 (fallback + parity oracle for the native
    packer; ~150 MB/s vs memory-speed C++)."""
    v = codes < 4
    c2 = np.where(v, codes, 0).astype(np.uint8)
    packed = (
        c2[:, 0::4]
        | (c2[:, 1::4] << 2)
        | (c2[:, 2::4] << 4)
        | (c2[:, 3::4] << 6)
    )
    vbits = np.packbits(v, axis=1, bitorder="little")
    return packed, vbits


def decode_codes(codes: np.ndarray, length: int) -> bytes:
    """codes[:length] -> ASCII bytes (invalid codes become 'N')."""
    c = np.asarray(codes[:length])
    out = np.where(c < 4, ASCII_LUT[np.minimum(c, 3)], np.uint8(78))
    return out.astype(np.uint8).tobytes()


_GRID_FINE_CAP = 512
_GRID_FINE_STEP = 32


def grid_length(n: int) -> int:
    """Data-independent padded-length grid for batching: multiples of 32
    up to 512, multiples of 128 beyond.

    The classify probe gathers one panel-table row per window slot, and
    that gather dominates the device step — short reads padded to a flat
    128 grid wasted up to ~40% of it (z1.fq 150 bp: L=256 -> 245 window
    slots vs L=160 -> 149).  Finer steps below 512 bp claw that back;
    every value is a multiple of 32 (pack4 wants L % 8 == 0) and the
    value universe is fixed, so the compile cache converges."""
    n = max(int(n), _GRID_FINE_STEP)
    step = _GRID_FINE_STEP if n <= _GRID_FINE_CAP else 128
    return round_up(n, step)


def length_buckets(lengths, max_buckets: int = 8):
    """Assign each read to a grid_length padded-length bucket; returns
    sorted unique bucket lengths and per-read bucket index.  Bounds
    padding waste for mixed-length inputs (e.g. nanopore reads 1.6-7.4kb,
    data/minION25.fq) while keeping the number of compiled programs
    small."""
    lengths = np.asarray(lengths)
    l = np.maximum(lengths, _GRID_FINE_STEP)
    fine = ((l + _GRID_FINE_STEP - 1) // _GRID_FINE_STEP) * _GRID_FINE_STEP
    coarse = ((l + 127) // 128) * 128
    raw = np.where(l <= _GRID_FINE_CAP, fine, coarse)
    uniq = np.unique(raw)
    if len(uniq) > max_buckets:
        # merge to at most max_buckets by quantile cut points
        qs = np.quantile(uniq, np.linspace(0, 1, max_buckets + 1)[1:], method="higher")
        uniq = np.unique(qs)
    idx = np.searchsorted(uniq, raw, side="left")
    idx = np.minimum(idx, len(uniq) - 1)
    # ensure each read's bucket is >= its length
    while np.any(uniq[idx] < lengths):
        idx = np.where(uniq[idx] < lengths, np.minimum(idx + 1, len(uniq) - 1), idx)
    return uniq, idx
