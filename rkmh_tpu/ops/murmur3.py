"""MurmurHash3_x64_128 — clean-room, bit-exact, vectorized for the device.

rkmh's hash_t is the low 64 bits (h1) of MurmurHash3_x64_128 with seed 42
(self-documented in its JSON sketch metadata, rkmh.cpp:494-497:
hashType="MurmurHash3_x64_128", hashBits=64, hashSeed=42).  The reference
gets the hash from the mkmh/murmur3 submodules (not vendored in the mount);
this module is a from-scratch implementation of Austin Appleby's public
algorithm, validated against SMHasher's published verification value
(0x6384BA69) in tests/test_murmur3.py.

Two implementations:

* ``murmur3_x64_128_np``  — scalar/loopy NumPy, the golden reference used
  to freeze test vectors and for host-side one-off hashing (e.g. the
  mutation kmers of ``rkmh call`` when run host-side).
* ``murmur3_x64_128_h1``  — vectorized jax.numpy over a [..., L] uint8
  byte tensor with *static* length L, returning the uint64 h1 lane.  All
  64-bit arithmetic uses native uint64.  This is the building block of
  the k-mer window hash kernel.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F
_FMIX1 = 0xFF51AFD7ED558CCD
_FMIX2 = 0xC4CEB9FE1A85EC53
_MASK64 = 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# NumPy golden reference (scalar; operates on python bytes)
# ---------------------------------------------------------------------------

def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * _FMIX1) & _MASK64
    k ^= k >> 33
    k = (k * _FMIX2) & _MASK64
    k ^= k >> 33
    return k


def murmur3_x64_128_np(data: bytes, seed: int = 42) -> tuple[int, int]:
    """Return (h1, h2) of MurmurHash3_x64_128(data, seed) as python ints."""
    length = len(data)
    nblocks = length // 16

    h1 = seed & _MASK64
    h2 = seed & _MASK64

    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16 : i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8 : i * 16 + 16], "little")

        k1 = (k1 * _C1) & _MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK64
        h1 ^= k1

        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _MASK64
        h1 = (h1 * 5 + 0x52DCEFB5) & _MASK64

        k2 = (k2 * _C2) & _MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK64
        h2 ^= k2

        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _MASK64
        h2 = (h2 * 5 + 0x38495AB5) & _MASK64

    tail = data[nblocks * 16 :]
    k1 = 0
    k2 = 0
    tl = len(tail)
    if tl >= 9:
        for i in range(tl - 1, 7, -1):  # bytes 8..tl-1 into k2
            k2 ^= tail[i] << ((i - 8) * 8)
        k2 = (k2 * _C2) & _MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK64
        h2 ^= k2
    if tl >= 1:
        for i in range(min(tl, 8) - 1, -1, -1):  # bytes 0..min(tl,8)-1 into k1
            k1 ^= tail[i] << (i * 8)
        k1 = (k1 * _C1) & _MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    return h1, h2


def murmur3_x64_128_digest_np(data: bytes, seed: int = 42) -> bytes:
    """16-byte little-endian digest (h1 then h2), as the C impl memcpys out."""
    h1, h2 = murmur3_x64_128_np(data, seed)
    return h1.to_bytes(8, "little") + h2.to_bytes(8, "little")


# ---------------------------------------------------------------------------
# Vectorized JAX implementation (static byte-length, batched leading dims)
# ---------------------------------------------------------------------------

def _jrotl64(x, r: int):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _jfmix64(k):
    k = k ^ (k >> np.uint64(33))
    k = k * np.uint64(_FMIX1)
    k = k ^ (k >> np.uint64(33))
    k = k * np.uint64(_FMIX2)
    k = k ^ (k >> np.uint64(33))
    return k


def _le_u64(b):
    """Pack the last-dim 8 uint8 lanes [..., 8] little-endian into uint64."""
    acc = jnp.zeros(b.shape[:-1], dtype=jnp.uint64)
    for i in range(8):
        acc = acc | (b[..., i].astype(jnp.uint64) << np.uint64(8 * i))
    return acc


def murmur3_x64_128(data, seed: int = 42):
    """MurmurHash3_x64_128 over a [..., L] uint8 tensor; returns (h1, h2).

    L (the trailing byte length) must be static.  Batched over all leading
    dimensions; everything stays elementwise uint64 so XLA fuses the whole
    chain into one VPU pass per lane.
    """
    data = jnp.asarray(data, dtype=jnp.uint8)
    length = data.shape[-1]
    nblocks = length // 16

    c1 = np.uint64(_C1)
    c2 = np.uint64(_C2)

    h1 = jnp.full(data.shape[:-1], seed, dtype=jnp.uint64)
    h2 = jnp.full(data.shape[:-1], seed, dtype=jnp.uint64)

    for i in range(nblocks):
        k1 = _le_u64(data[..., i * 16 : i * 16 + 8])
        k2 = _le_u64(data[..., i * 16 + 8 : i * 16 + 16])

        k1 = _jrotl64(k1 * c1, 31) * c2
        h1 = h1 ^ k1
        h1 = _jrotl64(h1, 27) + h2
        h1 = h1 * np.uint64(5) + np.uint64(0x52DCEFB5)

        k2 = _jrotl64(k2 * c2, 33) * c1
        h2 = h2 ^ k2
        h2 = _jrotl64(h2, 31) + h1
        h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)

    tl = length - nblocks * 16
    tail = data[..., nblocks * 16 :]
    if tl >= 9:
        k2 = jnp.zeros(data.shape[:-1], dtype=jnp.uint64)
        for i in range(8, tl):
            k2 = k2 | (tail[..., i].astype(jnp.uint64) << np.uint64((i - 8) * 8))
        k2 = _jrotl64(k2 * c2, 33) * c1
        h2 = h2 ^ k2
    if tl >= 1:
        k1 = jnp.zeros(data.shape[:-1], dtype=jnp.uint64)
        for i in range(min(tl, 8)):
            k1 = k1 | (tail[..., i].astype(jnp.uint64) << np.uint64(8 * i))
        k1 = _jrotl64(k1 * c1, 31) * c2
        h1 = h1 ^ k1

    h1 = h1 ^ np.uint64(length)
    h2 = h2 ^ np.uint64(length)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _jfmix64(h1)
    h2 = _jfmix64(h2)
    h1 = h1 + h2
    h2 = h2 + h1
    return h1, h2


def murmur3_x64_128_h1(data, seed: int = 42):
    """rkmh's hash_t: the low-64-bit lane (first 8 digest bytes) only."""
    h1, _ = murmur3_x64_128(data, seed)
    return h1
