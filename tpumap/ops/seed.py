"""Seed-finding kernels (device ops).

Batched re-expression of the reference's seed stage (src/kmer-search.c
Kmer_exact1 / Kmer_segment / Kmer_prevalent + the SIMD k-way diagonal merge
in src/merge-diagonals-simd-*.c): gather the genomic position lists of a
read's k-mers, convert to univdiagonals, and find the diagonals supported by
many k-mers via per-row sort + run-length counting — a sort-based reduction
that maps well to XLA instead of the reference's galloping intersections.

Conventions:
  * univdiagonal = genomic coordinate of query base 0 (pos - qpos).
  * INVALID (0xFFFFFFFF) marks padding lanes; sorts to the end.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

INVALID = np.uint32(0xFFFFFFFF)


def query_oligos(codes: jax.Array, nmask: jax.Array, lengths: jax.Array,
                 k: int) -> tuple[jax.Array, jax.Array]:
    """[B, L] codes -> ([B, L-k+1] uint32 oligos, bool valid).

    Oligo at q covers codes[q:q+k] with the leftmost base in the high bits
    (reference oligo convention, src/oligo.c). Oligos overlapping the read
    end or a non-ACGT base are invalid.
    """
    B, L = codes.shape
    n = L - k + 1
    acc = jnp.zeros((B, n), dtype=jnp.uint32)
    bad = jnp.zeros((B, n), dtype=jnp.bool_)
    for j in range(k):
        acc = (acc << 2) | codes[:, j:j + n].astype(jnp.uint32)
        bad = bad | nmask[:, j:j + n]
    q = jnp.arange(n, dtype=jnp.int32)[None, :]
    valid = (q + k <= lengths[:, None].astype(jnp.int32)) & ~bad
    return acc, valid


def lookup_diagonals(offsets: jax.Array, positions: jax.Array,
                     oligos: jax.Array, valid: jax.Array,
                     qpos: jax.Array, max_occ: int,
                     keep_overabundant: bool = False) -> jax.Array:
    """Gather up to max_occ genomic positions per oligo as univdiagonals.

    offsets: uint32[4^k+1]; positions: uint32[P+pad]; oligos: uint32[B, NQ];
    qpos: int32[NQ] query positions of each oligo. Returns uint32[B, NQ,
    max_occ] univdiagonals (INVALID padding). Oligos with more than max_occ
    genomic hits are dropped entirely — the reference's overabundance cap
    (src/stage1.c:3610 maxentries; repetitive oligos are better handled by
    its EF64 repetitive filter, which this mirrors cheaply.)
    """
    oligos_c = jnp.where(valid, oligos, 0).astype(jnp.int32)
    start = jnp.take(offsets, oligos_c, mode="clip")
    end = jnp.take(offsets, oligos_c + 1, mode="clip")
    count = (end - start).astype(jnp.int32)
    # keep_overabundant: repetitive-region fallback keeps the first
    # max_occ hits instead of dropping the oligo
    ok = valid if keep_overabundant else (valid & (count <= max_occ))
    lane = jnp.arange(max_occ, dtype=jnp.int32)[None, None, :]
    idx = start.astype(jnp.int32)[..., None] + lane
    pos = jnp.take(positions, idx, mode="clip")
    in_range = lane < count[..., None]
    # univdiagonal = pos - qpos; clamp reads hanging off the genome start
    diag = pos - qpos[None, :, None].astype(jnp.uint32)
    bad = (~ok[..., None]) | (~in_range) | (pos < qpos[None, :, None].astype(jnp.uint32))
    return jnp.where(bad, INVALID, diag)


def prevalent_diagonals(diags: jax.Array, top_k: int, merge_slop: int = 0,
                        return_last: bool = False):
    """Top-K diagonals per read by k-mer support.

    diags: uint32[B, N] (INVALID padding). Returns (uint32[B, top_k]
    diagonals, int32[B, top_k] support counts), count-descending; with
    return_last=True also the run's LAST (largest) diagonal — used by
    stage-1 region finding to bound the genomic window.
    With merge_slop > 0, each diagonal within slop of its PREDECESSOR in
    sorted order joins the predecessor's run (chained-neighbor merging) —
    so a hit train with successive gaps <= slop merges into ONE run no
    matter how long the train is, matching the reference's proximity
    clustering of gregions (src/stage1.c find_good_paths role). The
    stand-in for Intersect_approx is exact for slop=0; callers that pass
    a large slop (GMAP stage 1) must cap the resulting [rep, last] span
    themselves (see gmap/stage1._regions_from_rows) because a dense
    genome-wide repeat train would otherwise yield one mega-region.
    """
    B, N = diags.shape
    d = jnp.sort(diags, axis=1)
    prev = jnp.concatenate([jnp.full((B, 1), INVALID, dtype=d.dtype), d[:, :-1]], axis=1)
    if merge_slop == 0:
        is_start = d != prev
    else:
        is_start = (d - prev) > jnp.uint32(merge_slop)
    is_start = is_start.at[:, 0].set(True)
    i = jnp.arange(N, dtype=jnp.int32)[None, :]
    run_start = jax.lax.cummax(jnp.where(is_start, i, 0), axis=1)
    nxt = jnp.concatenate([d[:, 1:], jnp.full((B, 1), INVALID, dtype=d.dtype)], axis=1)
    if merge_slop == 0:
        is_last = d != nxt
    else:
        # last element of a run under slop-merging: the next element starts a new run
        nxt_start = jnp.concatenate([is_start[:, 1:],
                                     jnp.ones((B, 1), dtype=jnp.bool_)], axis=1)
        is_last = nxt_start
    count = jnp.where(is_last & (d != INVALID), i - run_start + 1, 0)
    # representative diagonal of a run = its first element (smallest)
    rep = jnp.take_along_axis(d, run_start, axis=1)
    top_counts, top_idx = jax.lax.top_k(count, top_k)
    top_diags = jnp.take_along_axis(rep, top_idx, axis=1)
    top_diags = jnp.where(top_counts > 0, top_diags, INVALID)
    if return_last:
        # count is nonzero only at run-last positions, so top_idx points at
        # the last (largest) diagonal of each selected run
        top_last = jnp.take_along_axis(d, top_idx, axis=1)
        top_last = jnp.where(top_counts > 0, top_last, INVALID)
        return top_diags, top_counts, top_last
    return top_diags, top_counts


def seed_reads(index, codes: jax.Array, nmask: jax.Array, lengths: jax.Array,
               max_occ: int = 32, top_k: int = 8, qinterval: int = 1,
               merge_slop: int = 0,
               space: str | None = None,
               index_space: str | None = None) -> tuple[jax.Array, jax.Array]:
    """Full seed stage: codes -> top-K candidate univdiagonals per read.

    With `space` set, seeding runs in the reduced base space against the
    matching mode-transformed index (cmet/atoi; see ops/mode.py).
    index_space overrides which (offsets, positions) pair is used without
    transforming the read codes — "snp" selects the SNP-tolerant index.
    """
    if space is not None:
        from tpumap.ops.mode import CODE_MAPS
        codes = jnp.take(jnp.asarray(CODE_MAPS[space]), codes.astype(jnp.int32))
    offsets, positions = index.mode_index(
        index_space if index_space is not None else space)
    oligos, valid = query_oligos(codes, nmask, lengths, index.k)
    NQ = oligos.shape[1]
    qpos = jnp.arange(0, NQ, qinterval, dtype=jnp.int32)
    diags = lookup_diagonals(offsets, positions,
                             oligos[:, ::qinterval], valid[:, ::qinterval],
                             qpos, max_occ)
    B = diags.shape[0]
    return prevalent_diagonals(diags.reshape(B, -1), top_k, merge_slop)
