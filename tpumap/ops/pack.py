"""Batched 2-bit read packing (device op).

The reference compresses each query once per read into fwd+rc 2-bit blocks
(src/compress.c, Compress_new_fwd/rev) on the CPU; here a whole read batch
is packed on device as one vectorized op. Layout matches the genome packing
(16 bases per uint32, base i at bits 2*(i%16)) so verification is XOR.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

BASES_PER_WORD = 16


def words_for(length: int) -> int:
    return (length + BASES_PER_WORD - 1) // BASES_PER_WORD


def pack_reads(codes: jax.Array) -> jax.Array:
    """[B, L] uint8 codes (0..3) -> [B, ceil(L/16)] uint32 packed.

    Tail positions must be pre-zeroed by the caller (they are masked by
    length in downstream ops).
    """
    B, L = codes.shape
    W = words_for(L)
    pad = W * BASES_PER_WORD - L
    if pad:
        codes = jnp.pad(codes, ((0, 0), (0, pad)))
    lanes = codes.reshape(B, W, BASES_PER_WORD).astype(jnp.uint32)
    shifts = (2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32))[None, None, :]
    return (lanes << shifts).sum(axis=2, dtype=jnp.uint32)


def revcomp_codes(codes: jax.Array, lengths: jax.Array) -> jax.Array:
    """Per-read reverse complement of [B, L] codes with per-read lengths.

    Position j of the output is complement(codes[length-1-j]) for j < length,
    zero elsewhere.
    """
    B, L = codes.shape
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = lengths[:, None] - 1 - j
    valid = src >= 0
    gathered = jnp.take_along_axis(codes, jnp.maximum(src, 0).astype(jnp.int32), axis=1)
    return jnp.where(valid, 3 - gathered, 0).astype(jnp.uint8)


def _reverse_bases_in_word(x: jax.Array) -> jax.Array:
    """Reverse the 16 2-bit groups inside each uint32 (pure vector shifts)."""
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x >> 2) & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x >> 4) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x >> 8) & jnp.uint32(0x00FF00FF))
    return (x << 16) | (x >> 16)


def revcomp_packed(packed: jax.Array, lengths: jax.Array,
                   complement: bool = True) -> jax.Array:
    """Per-read reverse(-complement) of packed reads, gather-free.

    Equivalent to pack_reads(revcomp_codes(codes, lengths)) but built from
    word reversal + in-word 2-bit-group reversal + a per-row base shift
    (the only gather is W+1 words per row instead of L elements — the
    XLA per-element gather tax makes this ~10x cheaper). With
    complement=False it reverses only (for N-flag planes).
    """
    B, W = packed.shape
    rev = _reverse_bases_in_word(packed[:, ::-1])
    if complement:
        rev = rev ^ jnp.uint32(0xFFFFFFFF)
    # the read now sits at base offset (16W - length); shift it down to 0
    off = (jnp.uint32(16 * W) - lengths.astype(jnp.uint32))
    w0 = (off >> 4).astype(jnp.int32)
    s2 = ((off & 15) << 1).astype(jnp.uint32)
    rev_pad = jnp.pad(rev, ((0, 0), (0, 1)))
    idx = w0[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    lo = jnp.take_along_axis(rev_pad, idx, axis=1)
    hi = jnp.take_along_axis(rev_pad, jnp.minimum(idx + 1, W), axis=1)
    out = (lo >> s2[:, None]) | jnp.where(
        (s2 == 0)[:, None], jnp.uint32(0),
        hi << ((jnp.uint32(32) - s2[:, None]) & jnp.uint32(31)))
    # zero the tail beyond length so downstream masks see clean padding
    base_idx = jnp.arange(W, dtype=jnp.int32)[None, :] * 16
    full = base_idx + 16 <= lengths[:, None]
    partial_bases = jnp.clip(lengths[:, None] - base_idx, 0, 16)
    tail_mask = jnp.where(
        partial_bases >= 16, jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (2 * partial_bases.astype(jnp.uint32))) - 1)
    tail_mask = jnp.where(partial_bases <= 0, jnp.uint32(0), tail_mask)
    return out & jnp.where(full, jnp.uint32(0xFFFFFFFF), tail_mask)


def revcomp_kmer(oligos: jax.Array, k: int) -> jax.Array:
    """Reverse-complement k-mers packed as uint32 (leftmost base in the
    high bits, the seed-op convention) — pure arithmetic, no gathers."""
    x = oligos
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x >> 2) & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x >> 4) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x >> 8) & jnp.uint32(0x00FF00FF))
    x = (x << 16) | (x >> 16)
    x = x ^ jnp.uint32(0xFFFFFFFF)
    # the k-mer now occupies the TOP 2k bits reversed; shift down
    return (x >> jnp.uint32(32 - 2 * k)) & ((jnp.uint32(1) << jnp.uint32(2 * k)) - jnp.uint32(1) if k < 16 else jnp.uint32(0xFFFFFFFF))


def pack_reads_host(codes) -> "np.ndarray":
    """Host (numpy) twin of pack_reads: [B, L] uint8 -> [B, W] uint32.

    Packing on the host shrinks the host->device transfer 4x."""
    import numpy as np
    B, L = codes.shape
    W = words_for(L)
    pad = W * BASES_PER_WORD - L
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))
    lanes = codes.reshape(B, W, BASES_PER_WORD).astype(np.uint32)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, None, :]
    return (lanes << shifts).sum(axis=2, dtype=np.uint32)


def unpack_reads(packed: jax.Array, L: int) -> jax.Array:
    """Device inverse of pack_reads: [B, W] uint32 -> [B, L] uint8."""
    B, W = packed.shape
    shifts = (2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32))
    lanes = (packed[..., :, None] >> shifts) & jnp.uint32(3)
    return lanes.reshape(B, W * BASES_PER_WORD)[:, :L].astype(jnp.uint8)
