"""Window-restricted fragment scan — the localdb salvage equivalent.

The reference builds per-65,536-bp suffix arrays (src/localdb-read.c,
src/sarray-write.c, SACA-K) to locate short query fragments that the
k-mer index cannot seed (fragments shorter than k, or split by a splice
site close to the read end); Spliceends_* consult it to find novel
splice-end diagonals (src/spliceends.c:5080, src/path-solve.c).

Suffix arrays gather poorly on a batched device. The same capability
re-expressed for it: extract the bounded genomic window once as PACKED words
(W/16 uint32 gathers per read) and compare the packed fragment word
against all W offsets as 16 shift phases of an XOR+popcount stream —
the genomebits idea applied to the scan. Per offset that is ~1 uint32
op instead of F byte compares + an int32 accumulate, and no unpacked
[R, W] byte tensor ever touches device memory (the byte-tensor form
was many times slower at salvage scale).

Only reads the cascade failed to solve reach this op, batch-compacted.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpumap.ops import verify

INVALID = np.uint32(0xFFFFFFFF)
LOW_PAIRS = np.uint32(0x55555555)


def _phase_mismatch_counts(genome_packed, win_starts, frag, frag_lens,
                           window: int, max_frag: int):
    """nmm int32[R, window]: mismatches of each row's fragment at every
    window offset. frag uint8[R, max_frag] (max_frag <= 16), compared as
    one packed word per row over 16 shift phases of the packed window."""
    assert max_frag <= 16
    R = win_starts.shape[0]
    nw = window // 16 + 1
    win = verify.extract_packed_window(genome_packed, win_starts, nw + 1)
    # pack the fragment: base j at bits [2j, 2j+2)
    shifts = (2 * jnp.arange(max_frag, dtype=jnp.uint32))[None, :]
    fw = jnp.sum(frag.astype(jnp.uint32) << shifts, axis=1,
                 dtype=jnp.uint32)                       # [R]
    flen = jnp.clip(frag_lens, 0, max_frag).astype(jnp.uint32)
    # mask of bit-pairs covering the first flen bases ((4^flen)-1 without
    # the undefined shift at flen == 16)
    fm = jnp.where(flen >= 16, jnp.uint32(0xFFFFFFFF),
                   (jnp.uint32(1) << (2 * flen)) - 1)
    lo = win[:, :nw]
    hi = win[:, 1:nw + 1]
    per_phase = []
    for p in range(16):
        if p == 0:
            stream = lo
        else:
            stream = (lo >> jnp.uint32(2 * p)) | (hi << jnp.uint32(32 - 2 * p))
        x = (stream ^ fw[:, None])
        mm2 = (x | (x >> 1)) & LOW_PAIRS
        per_phase.append(jax.lax.population_count(mm2 & fm[:, None]))
    # [R, nw, 16] with offset o = 16*j + p
    nmm = jnp.stack(per_phase, axis=2).reshape(R, nw * 16)
    return nmm[:, :window].astype(jnp.int32)


@partial(jax.jit, static_argnums=(4, 5, 6))
def scan_fragment(genome_packed: jax.Array, win_starts: jax.Array,
                  frag: jax.Array, frag_lens: jax.Array,
                  window: int, max_frag: int, top_k: int = 4):
    """Find the best placements of per-read fragments inside genome
    windows.

    genome_packed: uint32[...] packed genome; win_starts: uint32[R]
    window start univcoords; frag: uint8[R, max_frag] fragment codes;
    frag_lens: int32[R] actual fragment lengths (<= max_frag <= 16).

    Returns (positions uint32[R, top_k], nmm int32[R, top_k]): genome
    univcoords of the fragment's first base at the top_k
    lowest-mismatch offsets, INVALID-padded.
    """
    nmm = _phase_mismatch_counts(genome_packed, win_starts, frag,
                                 frag_lens, window, max_frag)
    # exact top_k by iterated global-min over a combined (nmm, offset)
    # key with two-level (block-min) reduction: lax.top_k over the full
    # [R, window] tensor was far slower.
    R = nmm.shape[0]
    off = jnp.arange(window, dtype=jnp.int32)[None, :]
    key = nmm * jnp.int32(131072) + off            # nmm-major, offset tiebreak
    BLK = 64
    nb = (window + BLK - 1) // BLK
    if nb * BLK != window:
        key = jnp.concatenate(
            [key, jnp.full((R, nb * BLK - window), 2 ** 30, jnp.int32)],
            axis=1)
        off = jnp.concatenate(
            [off, jnp.full((1, nb * BLK - window), 2 ** 30, jnp.int32)],
            axis=1)
    idxs, mms = [], []
    for _ in range(top_k):
        kb = key.reshape(R, nb, BLK)
        bmin = jnp.min(kb, axis=2)
        barg = jnp.argmin(kb, axis=2)
        b = jnp.argmin(bmin, axis=1)
        inner = jnp.take_along_axis(barg, b[:, None], axis=1)[:, 0]
        o = b.astype(jnp.int32) * BLK + inner.astype(jnp.int32)
        v = jnp.take_along_axis(bmin, b[:, None], axis=1)[:, 0]
        idxs.append(o)
        mms.append(v >> jnp.int32(17))
        key = jnp.where(off == o[:, None], jnp.int32(2 ** 30), key)
    idx = jnp.stack(idxs, axis=1)
    best_mm = jnp.stack(mms, axis=1)
    positions = win_starts[:, None] + idx.astype(jnp.uint32)
    return positions, best_mm


@partial(jax.jit, static_argnums=(4, 5, 6))
def scan_exact_sites(genome_packed: jax.Array, win_starts: jax.Array,
                     frag: jax.Array, frag_lens: jax.Array,
                     window: int, max_frag: int, top_k: int = 8):
    """ALL exact placements of per-read patterns inside genome windows.

    The ambiguous-splice-end enumerator (src/spliceends.c trimmed-end
    candidate generation + src/altsplice.c coords): the pattern is a
    splice dinucleotide fused with the read's short clipped residue, and
    every exact match in the intron-length window is a legal distal
    placement.  Same packed-phase scan as scan_fragment, exact matches
    only, returned in ascending genomic order WITH the total match count
    (the ambiguity degree).

    Returns (positions uint32[R, top_k] INVALID-padded ascending,
    count int32[R]).  Rows with frag_lens <= 0 return count 0.
    """
    nmm = _phase_mismatch_counts(genome_packed, win_starts, frag,
                                 frag_lens, window, max_frag)
    hit = (nmm == 0) & (frag_lens > 0)[:, None]
    count = jnp.sum(hit.astype(jnp.int32), axis=1)
    off = jnp.arange(window, dtype=jnp.int32)[None, :]
    key = jnp.where(hit, off, jnp.int32(window))
    firstk = -jax.lax.top_k(-key, top_k)[0]        # k smallest offsets
    positions = jnp.where(firstk < window,
                          win_starts[:, None] + firstk.astype(jnp.uint32),
                          INVALID)
    return positions, count


@partial(jax.jit, static_argnums=(3, 4, 5))
def scan_fragment_runs(genome_packed: jax.Array, win_starts: jax.Array,
                       frag16: jax.Array, window: int, top_k: int = 4,
                       suffix: bool = True):
    """Rank window offsets by the longest clean RUN anchored at one end
    of a 16-base fragment.

    The missing-exon salvage problem: a clipped read end hides an exon
    of unknown length m — scanning just the clip crowds in chance
    perfect hits (E[hits] = W/4^m), while the FULL 16-base end window
    mismatches at the junction.  The discriminating statistic is the
    longest clean suffix (read tail) / prefix (read head) run: the true
    exon diagonal scores run = m, a random offset P(run >= m) = 4^-m,
    AND the run length pins the junction boundary exactly, so callers
    can check the splice dinucleotide at pos + 16 - run (suffix) or
    pos + run (prefix).  Runs are computed bit-parallel from the same
    16-phase packed XOR stream as scan_fragment (a bit-smear + popcount
    per phase, no per-base tensor).

    frag16 uint8[R, 16] (suffix: the READ'S last 16 bases; prefix: the
    first 16).  Returns (positions uint32[R, top_k], runs int32[R,
    top_k]) sorted by run descending, offset ascending.
    """
    R = win_starts.shape[0]
    nw = window // 16 + 1
    win = verify.extract_packed_window(genome_packed, win_starts, nw + 1)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, :]
    fw = jnp.sum(frag16.astype(jnp.uint32) << shifts, axis=1,
                 dtype=jnp.uint32)
    lo = win[:, :nw]
    hi = win[:, 1:nw + 1]
    per_phase = []
    for p in range(16):
        if p == 0:
            stream = lo
        else:
            stream = ((lo >> jnp.uint32(2 * p))
                      | (hi << jnp.uint32(32 - 2 * p)))
        x = stream ^ fw[:, None]
        mm2 = (x | (x >> 1)) & LOW_PAIRS
        y = mm2
        if suffix:
            # smear mismatches DOWN: ~y's high pairs = clean suffix
            for s in (2, 4, 8, 16):
                y = y | (y >> jnp.uint32(s))
        else:
            for s in (2, 4, 8, 16):
                y = y | (y << jnp.uint32(s))
        run = jax.lax.population_count(~y & LOW_PAIRS)
        per_phase.append(run)
    runs = (jnp.stack(per_phase, axis=2).reshape(R, nw * 16)[:, :window]
            .astype(jnp.int32))
    off = jnp.arange(window, dtype=jnp.int32)[None, :]
    key = -runs * jnp.int32(131072) + off
    BLK = 64
    nb = (window + BLK - 1) // BLK
    if nb * BLK != window:
        key = jnp.concatenate(
            [key, jnp.full((R, nb * BLK - window), 2 ** 30, jnp.int32)],
            axis=1)
        off = jnp.concatenate(
            [off, jnp.full((1, nb * BLK - window), 2 ** 30, jnp.int32)],
            axis=1)
    poss, rr = [], []
    for _ in range(top_k):
        kb = key.reshape(R, nb, BLK)
        bmin = jnp.min(kb, axis=2)
        barg = jnp.argmin(kb, axis=2)
        b = jnp.argmin(bmin, axis=1)
        inner = jnp.take_along_axis(barg, b[:, None], axis=1)[:, 0]
        o = b.astype(jnp.int32) * BLK + inner.astype(jnp.int32)
        v = jnp.take_along_axis(bmin, b[:, None], axis=1)[:, 0]
        poss.append(o)
        rr.append(-(v >> jnp.int32(17)))
        key = jnp.where(off == o[:, None], jnp.int32(2 ** 30), key)
    idx = jnp.stack(poss, axis=1)
    runs_k = jnp.stack(rr, axis=1)
    return win_starts[:, None] + idx.astype(jnp.uint32), runs_k
