"""Vectorized canonical k-mer window hashing — the rkmh `calc_hashes` op.

The reference hashes every k-mer of every read with MurmurHash3 in an
OpenMP loop (mkmh calc_hashes, called from rkmh.cpp:293-433 / 860).  Here
the whole batch hashes in one fused XLA elementwise pass:

* Reads arrive as 2-bit codes ``[B, L] uint8`` (A=0 C=1 G=2 T=3, >=4 =
  invalid base or padding), produced host-side by io.packing.
* For each window start i the canonical k-mer is the lexicographic min of
  the k-mer and its reverse complement (Mash convention, matching rkmh's
  canonical=true metadata, rkmh.cpp:494-497).  Comparison keys are 2-bit
  big-endian packed uint64 limbs — code order == ASCII order for A<C<G<T,
  so integer compare == lexicographic byte compare.
* The murmur input words (8 ASCII bytes little-endian per uint64, exactly
  what MurmurHash3_x64_128 consumes) are built directly as *shifted slices*
  of the [B, L] byte arrays — no [B, W, k] window tensor is ever
  materialized.  Total live memory is ~2*ceil(k/8) uint64 arrays of shape
  [B, W].
* Windows containing any non-ACGT base hash to 0, rkmh's invalid-k-mer
  sentinel that all sketch code skips (rkmh.cpp:1233-1235, 1274-1276).

Everything is shape-static and jit/vmap/shard_map-friendly; under a Mesh
the batch axis shards cleanly (pure data parallelism, no collectives).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from rkmh_tpu.ops import murmur3

# hash value meaning "invalid k-mer" (contains non-ACGT); rkmh skips zeros.
INVALID_HASH = np.uint64(0)

_U64 = jnp.uint64


def _ascii_from_codes(codes):
    """codes 0..3 -> ASCII 'A','C','G','T' (values >3 map to 'T'; such
    windows are masked invalid downstream so the byte value is irrelevant)."""
    c = codes.astype(jnp.uint8)
    out = jnp.where(c == 0, np.uint8(65), np.uint8(84))
    out = jnp.where(c == 1, np.uint8(67), out)
    out = jnp.where(c == 2, np.uint8(71), out)
    return out


def _pack_words(byte_plane, starts, k: int, W: int):
    """Build murmur input words for every window.

    byte_plane: [..., L] uint8; word w of window i packs bytes
    byte_plane[..., i + starts[8w+j]] << 8j for j in 0..7 while 8w+j < k.
    ``starts`` maps window-relative kmer position p -> plane offset.
    Returns list of ceil(k/8) uint64 arrays of shape [..., W].
    """
    words = []
    nwords = (k + 7) // 8
    for w in range(nwords):
        acc = None
        for j in range(8):
            p = 8 * w + j
            if p >= k:
                break
            off = starts[p]
            lane = byte_plane[..., off : off + W].astype(_U64) << np.uint64(8 * j)
            acc = lane if acc is None else acc | lane
        words.append(acc)
    return words


def _murmur3_h1_from_words(words, length: int, seed: int):
    """MurmurHash3_x64_128 h1 over pre-packed little-endian uint64 words.

    ``words[w]`` holds input bytes [8w, 8w+8) (partial final word is
    zero-padded high — identical to the tail switch of the canonical
    implementation).  Arithmetic mirrors murmur3.murmur3_x64_128.
    """
    c1 = np.uint64(murmur3._C1)
    c2 = np.uint64(murmur3._C2)
    rot = murmur3._jrotl64

    shape = words[0].shape
    h1 = jnp.full(shape, seed, dtype=_U64)
    h2 = jnp.full(shape, seed, dtype=_U64)

    nblocks = length // 16
    for i in range(nblocks):
        k1 = words[2 * i]
        k2 = words[2 * i + 1]
        k1 = rot(k1 * c1, 31) * c2
        h1 = h1 ^ k1
        h1 = rot(h1, 27) + h2
        h1 = h1 * np.uint64(5) + np.uint64(0x52DCEFB5)
        k2 = rot(k2 * c2, 33) * c1
        h2 = h2 ^ k2
        h2 = rot(h2, 31) + h1
        h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)

    tl = length - nblocks * 16
    if tl >= 9:
        k2 = rot(words[2 * nblocks + 1] * c2, 33) * c1
        h2 = h2 ^ k2
    if tl >= 1:
        k1 = rot(words[2 * nblocks] * c1, 31) * c2
        h1 = h1 ^ k1

    h1 = h1 ^ np.uint64(length)
    h2 = h2 ^ np.uint64(length)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = murmur3._jfmix64(h1)
    h2 = murmur3._jfmix64(h2)
    h1 = h1 + h2
    return h1  # rkmh keeps only the low 64 bits


def _canonical_use_fwd(codes, k: int, W: int):
    """Per-window bool: forward k-mer <= its reverse complement.

    Lexicographic order decided outside-in at the first position where
    fwd base != rc base — a right-to-left fold of cheap uint8 compares
    (`later-positions verdict unless this position differs`), ~6 byte
    ops per base instead of building and comparing 2-bit-packed uint64
    keys.  Ties (palindromes) yield True, matching the <= of the
    packed-key compare.
    """
    c = codes.astype(jnp.uint8)
    three = np.uint8(3)
    use_fwd = None  # fold from the LAST position backwards
    for p in range(k - 1, -1, -1):
        a = c[..., p : p + W] & three
        # rc base at window position p is complement(code[i + k-1-p])
        q = k - 1 - p
        b = (three - (c[..., q : q + W] & three)) & three
        lt = a < b
        if use_fwd is None:
            use_fwd = a <= b
        else:
            use_fwd = jnp.where(a == b, use_fwd, lt)
    return use_fwd


def kmer_window_hashes(codes, k: int, seed: int = 42):
    """Canonical hash of every k-window of a [.., L] code tensor.

    Returns [.., L-k+1] uint64; windows containing any code >= 4 (invalid
    base or padding) are INVALID_HASH (0).  Bit-identical to
    oracle.calc_hashes for each true (non-padding) window.
    """
    codes = jnp.asarray(codes, dtype=jnp.uint8)
    L = codes.shape[-1]
    W = L - k + 1
    if W <= 0:
        return jnp.zeros(codes.shape[:-1] + (0,), dtype=_U64)

    # window validity: no code >= 4 anywhere in [i, i+k)
    bad = (codes >= 4).astype(jnp.int32)
    cs = jnp.cumsum(bad, axis=-1)
    lo = jnp.concatenate(
        [jnp.zeros(codes.shape[:-1] + (1,), jnp.int32), cs[..., : W - 1]], axis=-1
    )
    valid = (cs[..., k - 1 :] - lo) == 0

    # canonical orientation per window
    use_fwd = _canonical_use_fwd(codes, k, W)

    # murmur words from ASCII planes via shifted slices
    fw_plane = _ascii_from_codes(codes)
    rc_plane = _ascii_from_codes((np.uint64(3) - codes.astype(_U64)).astype(jnp.uint8) & np.uint8(3))

    fwd_starts = list(range(k))            # byte p of fwd kmer = plane[i+p]
    rc_starts = [k - 1 - p for p in range(k)]  # byte p of rc kmer = rcplane[i+k-1-p]

    fwd_words = _pack_words(fw_plane, fwd_starts, k, W)
    rc_words = _pack_words(rc_plane, rc_starts, k, W)
    words = [jnp.where(use_fwd, fw, rw) for fw, rw in zip(fwd_words, rc_words)]

    h1 = _murmur3_h1_from_words(words, k, seed)
    return jnp.where(valid, h1, INVALID_HASH)


def multi_k_window_hashes(codes, ks, seed: int = 42):
    """rkmh multi-k calc_hashes: per-k window hashes concatenated in k order
    (rkmh.cpp:590/860 — repeated -k flags concatenate hash lists)."""
    ks = [ks] if isinstance(ks, int) else list(ks)
    outs = [kmer_window_hashes(codes, k, seed) for k in ks]
    return jnp.concatenate(outs, axis=-1) if len(outs) > 1 else outs[0]


def window_counts(lengths, ks):
    """True (non-padding) window count per read: sum_k max(0, len-k+1)."""
    ks = [ks] if isinstance(ks, int) else list(ks)
    lengths = jnp.asarray(lengths)
    total = jnp.zeros_like(lengths)
    for k in ks:
        total = total + jnp.maximum(lengths - (k - 1), 0)
    return total


def window_mask(lengths, L: int, ks):
    """[B, sum_k (L-k+1)] bool — True for windows that exist in the unpadded
    read (matches the concatenation order of multi_k_window_hashes)."""
    ks = [ks] if isinstance(ks, int) else list(ks)
    lengths = jnp.asarray(lengths)
    parts = []
    for k in ks:
        W = L - k + 1
        if W <= 0:
            continue
        iota = jnp.arange(W, dtype=lengths.dtype)
        parts.append(iota[None, :] < (lengths - (k - 1))[:, None])
    if not parts:  # every k exceeds L: zero windows, like multi_k_window_hashes
        return jnp.zeros(lengths.shape + (0,), dtype=bool)
    return jnp.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]
