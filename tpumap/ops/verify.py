"""Mismatch verification kernels (device ops).

Device equivalent of the reference's genomebits XOR+popcount machinery
(src/genomebits_count.c Genomebits_count_mismatches_substring,
src/genomebits_mismatches.c Genomebits_mismatches_fromleft/right): compare a
2-bit packed read batch against genome windows gathered at candidate
univdiagonals.

Two views are provided:
  * count_mismatches      — popcount path, one int per (read, candidate)
  * mismatch_base_mask    — per-base boolean tensor for path solving
    (prefix-sum mismatch positions, indel/splice placement)

Non-ACGT positions (genome N-flag, query N-flag) always count as mismatches,
matching the reference's treatment of N.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

U32_ONES = np.uint32(0xFFFFFFFF)
LOW_PAIRS = np.uint32(0x55555555)

# Trailing pad (in uint32 words) that DeviceIndex.from_host guarantees on
# genome_packed / genome_nmask / positions.  Sized for the widest FIXED
# window fetched as one dynamic slice (the 65,536 bp localscan window =
# 4,097 words + 1 alignment word).  Wider windows (GMAP region buckets can
# exceed this on small genomes) MUST NOT rely on the pad: lax.dynamic_slice
# silently clamps the start index when start + size exceeds the operand,
# shifting the whole window to wrong genome coordinates — the round-3
# db-mode GMAP regression.  extract_packed_window therefore zero-extends
# the operand itself whenever nwords + 1 > SAFE_PAD_WORDS.
SAFE_PAD_WORDS = 4352


def extract_packed_window(genome_packed: jax.Array, starts: jax.Array,
                          nwords: int) -> jax.Array:
    """Gather + bit-align genome windows at arbitrary base offsets.

    genome_packed: uint32[W] (16 bases/word); starts: int[...] base coords.
    Returns uint32[..., nwords] where word j holds bases
    [start + 16*j, start + 16*j + 16), i.e. the same layout as a packed read
    starting at `start`.

    Wide windows are fetched as one dynamic slice per row (a contiguous
    copy) rather than an elementwise gather: XLA lowers per-element takes
    to one gathered element per index, which made the 65 Kbp window scan
    gather-bound.  DeviceIndex pads
    genome_packed by SAFE_PAD_WORDS so slices up to that width never clamp
    for in-genome starts; wider windows zero-extend the operand here so
    lax.dynamic_slice's silent start-clamping can never shift a window
    (bases past the genome end read as zeros/'A', which callers mask via
    window-length / N masks).
    """
    starts = starts.astype(jnp.uint32)
    w0 = (starts >> 4).astype(jnp.int32)
    s2 = ((starts & 15) << 1).astype(jnp.uint32)       # bit shift within word
    if nwords >= 16:
        if nwords + 1 > SAFE_PAD_WORDS:
            # any start within the (pre-extension) operand now fetches
            # exactly, since w0 + nwords + 1 <= len + nwords + 1
            genome_packed = jnp.concatenate(
                [genome_packed,
                 jnp.zeros(nwords + 1, dtype=genome_packed.dtype)])
        flat = w0.reshape(-1)
        words = jax.vmap(
            lambda s: jax.lax.dynamic_slice(genome_packed, (s,),
                                            (nwords + 1,)))(flat)
        words = words.reshape(*w0.shape, nwords + 1)
    else:
        idx = w0[..., None] + jnp.arange(nwords + 1, dtype=jnp.int32)
        words = jnp.take(genome_packed, idx, mode="clip")
    lo = words[..., :nwords] >> s2[..., None]
    # (32 - s2) & 31 avoids the undefined shift-by-32; the s2==0 case is
    # masked out explicitly.
    hi = words[..., 1:] << ((jnp.uint32(32) - s2[..., None]) & jnp.uint32(31))
    hi = jnp.where((s2 == 0)[..., None], jnp.uint32(0), hi)
    return lo | hi


def extract_bit_window(bitmap: jax.Array, starts: jax.Array,
                       nwords16: int) -> jax.Array:
    """Like extract_packed_window but for a 1-bit-per-base bitmap, widened to
    2 bits per base so it composes with the packed-word mismatch mask.

    Returns uint32[..., nwords16] with bit 2*j set if base (start + 16*w + j)
    is flagged.
    """
    starts = starts.astype(jnp.uint32)
    w0 = (starts >> 5).astype(jnp.int32)
    s = (starts & 31).astype(jnp.uint32)
    # need nwords16*16 bits => nwords16/2 (+1) uint32 words of bitmap
    nb = nwords16 // 2 + 1
    idx = w0[..., None] + jnp.arange(nb + 1, dtype=jnp.int32)
    words = jnp.take(bitmap, idx, mode="clip")
    lo = words[..., :nb] >> s[..., None]
    hi = words[..., 1:] << ((jnp.uint32(32) - s[..., None]) & jnp.uint32(31))
    hi = jnp.where((s == 0)[..., None], jnp.uint32(0), hi)
    aligned = lo | hi                                   # 1 bit/base, 32/word
    # widen: bits [16w..16w+16) of each aligned word -> one output word
    halves = jnp.stack([aligned & jnp.uint32(0xFFFF), aligned >> 16], axis=-1)
    halves = halves.reshape(*aligned.shape[:-1], nb * 2)[..., :nwords16]
    return _spread16(halves)


def _spread16(x: jax.Array) -> jax.Array:
    """Interleave the low 16 bits of x with zeros (bit j -> bit 2j)."""
    x = x.astype(jnp.uint32) & jnp.uint32(0xFFFF)
    x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
    x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & jnp.uint32(0x33333333)
    x = (x | (x << 1)) & jnp.uint32(0x55555555)
    return x


def extract_codes_window(genome_packed: jax.Array, starts: jax.Array,
                         L: int) -> jax.Array:
    """Gather genome windows as per-base codes uint8[..., L] (unpacked)."""
    W = (L + 15) // 16
    words = extract_packed_window(genome_packed, starts, W)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))
    lanes = (words[..., :, None] >> shifts) & jnp.uint32(3)
    return lanes.reshape(*words.shape[:-1], W * 16)[..., :L].astype(jnp.uint8)


def mismatch_words(query_packed: jax.Array, genome_window: jax.Array,
                   query_nmask2: jax.Array | None = None,
                   genome_nmask2: jax.Array | None = None,
                   query_unk: bool = True,
                   genome_unk: bool = True) -> jax.Array:
    """Per-word mismatch mask: bit 2*j set iff base j mismatches.

    query_packed / genome_window: uint32[..., W]; *_nmask2: same shape,
    bit 2*j set = flagged base (from extract_bit_window / _spread16).
    """
    x = query_packed ^ genome_window
    mm = (x | (x >> 1)) & LOW_PAIRS
    # unk-mismatch semantics (gsnap --query-unk-mismatch /
    # --genome-unk-mismatch): N counts as a mismatch (|) or matches
    # anything (& ~)
    if query_nmask2 is not None:
        mm = (mm | query_nmask2) if query_unk else (mm & ~query_nmask2)
    if genome_nmask2 is not None:
        mm = (mm | genome_nmask2) if genome_unk else (mm & ~genome_nmask2)
    return mm


def length_mask_words(lengths: jax.Array, nwords: int) -> jax.Array:
    """uint32[..., nwords] with bit 2*j of word w set iff 16*w + j < length."""
    j = jnp.arange(nwords * 16, dtype=jnp.int32)
    valid = j[None, :] < lengths[..., None].astype(jnp.int32)
    lanes = valid.reshape(*lengths.shape, nwords, 16)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, :]
    return (lanes.astype(jnp.uint32) << shifts).sum(axis=-1, dtype=jnp.uint32)


def count_mismatches(mm_words: jax.Array, lmask_words: jax.Array) -> jax.Array:
    """Popcount of the masked mismatch words -> int32[...]."""
    masked = mm_words & lmask_words
    return jax.lax.population_count(masked).sum(axis=-1).astype(jnp.int32)


def mismatch_base_mask(mm_words: jax.Array, L: int) -> jax.Array:
    """uint32[..., W] mismatch words -> bool[..., L] per-base mismatch flags."""
    W = mm_words.shape[-1]
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))
    bits = (mm_words[..., :, None] >> shifts[None, :]) & jnp.uint32(1)
    return bits.reshape(*mm_words.shape[:-1], W * 16)[..., :L].astype(jnp.bool_)


def mismatch_mask_single(index, read_packed: jax.Array,
                         read_nmask2: jax.Array, lengths: jax.Array,
                         diag: jax.Array, L: int,
                         space: str | None = None, snp: bool = False,
                         query_unk: bool = True,
                         genome_unk: bool = True) -> jax.Array:
    """Per-base mismatch mask of each read against ONE diagonal.

    read_packed/read_nmask2 uint32[B, W] in the aligned orientation;
    diag uint32[B] (INVALID rows return all-mismatch). Returns bool[B, L].
    Same semantics as verify_diagonals but exposing the base mask — the
    Genomebits_mismatches_fromleft/right analog feeding end trimming
    (src/genomebits_trim.c) and path solving.
    """
    B, W = read_packed.shape
    valid = diag != jnp.uint32(0xFFFFFFFF)
    starts = jnp.where(valid, diag, 0)
    gwin = extract_packed_window(index.genome_packed, starts, W)
    if getattr(index, "genome_has_n", True):
        gn2 = extract_bit_window(index.genome_nmask, starts, W)
    else:
        gn2 = None
    if space is not None:
        from tpumap.ops.mode import transform_packed
        read_packed = transform_packed(read_packed, space)
        gwin = transform_packed(gwin, space)
    mm = mismatch_words(read_packed, gwin, read_nmask2, gn2,
                        query_unk=query_unk, genome_unk=genome_unk)
    if snp and index.genomealt_packed is not None:
        gwin_alt = extract_packed_window(index.genomealt_packed, starts, W)
        if space is not None:
            from tpumap.ops.mode import transform_packed
            gwin_alt = transform_packed(gwin_alt, space)
        mm_alt = mismatch_words(read_packed, gwin_alt, read_nmask2, gn2,
                                query_unk=query_unk, genome_unk=genome_unk)
        mm = mm & mm_alt
    mask = mismatch_base_mask(mm, L)
    return jnp.where(valid[:, None], mask, True)


def verify_diagonals(index, read_packed: jax.Array, read_nmask2: jax.Array,
                     lengths: jax.Array, diagonals: jax.Array,
                     space: str | None = None, snp: bool = False,
                     query_unk: bool = True,
                     genome_unk: bool = True) -> jax.Array:
    """Count mismatches of each read against each candidate univdiagonal.

    read_packed: uint32[B, W]; read_nmask2: uint32[B, W] (spread bits);
    lengths: int32[B]; diagonals: uint32[B, C] (univdiagonal = genome coord
    of query base 0; INVALID_DIAG lanes return length, i.e. all-mismatch).

    With `space` set (see ops/mode.py), both sides are transformed to the
    reduced base space before comparison (bisulfite / RNA-editing modes).
    With snp=True (and index.genomealt_packed present), a base mismatches
    only if it matches NEITHER the reference nor the alt allele — the
    SNP-tolerant mode of the genomebits kernels (src/genomebits_mismatches.c
    masked variants, src/gsnap.c genomebits_alt).

    Returns int32[B, C] mismatch counts.
    """
    B, W = read_packed.shape
    C = diagonals.shape[1]
    valid = diagonals != jnp.uint32(0xFFFFFFFF)
    starts = jnp.where(valid, diagonals, 0)
    gwin = extract_packed_window(index.genome_packed, starts, W)
    # the N-mask window gather costs as much as the genome gather; skip it
    # when the genome provably has no non-ACGT bases (static flag)
    if getattr(index, "genome_has_n", True):
        gn2 = extract_bit_window(index.genome_nmask, starts, W)
    else:
        gn2 = None
    if space is not None:
        # mode-aware comparison (cmet/atoi): reduce both sides' base space
        from tpumap.ops.mode import transform_packed
        read_packed = transform_packed(read_packed, space)
        gwin = transform_packed(gwin, space)
    mm = mismatch_words(read_packed[:, None, :], gwin,
                        read_nmask2[:, None, :], gn2,
                        query_unk=query_unk, genome_unk=genome_unk)
    if snp and index.genomealt_packed is not None:
        gwin_alt = extract_packed_window(index.genomealt_packed, starts, W)
        if space is not None:
            from tpumap.ops.mode import transform_packed
            gwin_alt = transform_packed(gwin_alt, space)
        mm_alt = mismatch_words(read_packed[:, None, :], gwin_alt,
                                read_nmask2[:, None, :], gn2,
                                query_unk=query_unk, genome_unk=genome_unk)
        mm = mm & mm_alt
    lmask = length_mask_words(lengths, W)[:, None, :]
    counts = count_mismatches(mm, lmask)
    return jnp.where(valid, counts, lengths[:, None].astype(jnp.int32))
