"""Anchor chaining for cDNA->genomic-region alignment (GMAP stage-2 analog).

The reference builds small 8-mer indexes of the genomic region and runs a
sparse lookback DP over (querypos, genomepos) dot-plot entries
(src/stage2.c Stage2_compute + src/oligoindex_hr.c). The batched
re-expression factors that into three fixed-shape device stages:

  1. region_index   — sort-based 8-mer index of the region (per problem)
  2. anchors        — query-oligo lookups -> (q, diag) anchor set
  3. segments+chain — collapse anchors into diagonal runs ("segments",
                      the exon cores), then a masked max-plus DP over the
                      top-S segments picks the best collinear chain

Segments play the role of stage2's chained diagonal bundles; per-base exon
boundaries are refined later by the stage-3 junction ops (ops/splice.py).

All functions are shaped for vmap over a problem batch.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INVALID = np.uint32(0xFFFFFFFF)
NEG = np.int32(-(2 ** 30))


def region_oligos(codes: jax.Array, valid: jax.Array, k: int) -> jax.Array:
    """[R] uint8 codes -> [R] uint32 oligos (oligo starting at each pos).

    Positions whose k-window leaves the valid region produce INVALID.
    """
    R = codes.shape[0]
    acc = jnp.zeros(R, dtype=jnp.uint32)
    ok = jnp.ones(R, dtype=jnp.bool_)
    for j in range(k):
        rolled = jnp.roll(codes, -j)
        rolled_ok = jnp.roll(valid, -j)
        # windows that wrap past the end are invalidated by the valid mask
        acc = (acc << 2) | rolled.astype(jnp.uint32)
        ok = ok & rolled_ok
    idx = jnp.arange(R, dtype=jnp.int32)
    ok = ok & (idx < R - k + 1)
    return jnp.where(ok, acc, jnp.uint32(0xFFFFFFFF))


def region_index(codes: jax.Array, valid: jax.Array, k: int):
    """Sorted (oligo, pos) arrays: the region's on-the-fly k-mer index.

    lax.sort co-sorts the positions INSIDE the sort network — an
    argsort + permutation gather adds a gather per element, which
    dominated the whole GMAP chain stage for 100 kbp+ regions."""
    oligos = region_oligos(codes, valid, k)
    pos = jnp.arange(codes.shape[0], dtype=jnp.uint32)
    so, sp = jax.lax.sort((oligos, pos), num_keys=1)
    return so, sp


def anchors_from_query(sorted_oligos: jax.Array, sorted_pos: jax.Array,
                       q_oligos: jax.Array, q_valid: jax.Array,
                       max_occ: int, keep_overabundant: bool = False,
                       k: int | None = None):
    """For each query oligo, up to max_occ region positions.

    Returns (diag uint32[Q, max_occ], q int32[Q, max_occ], valid bool).
    diag = region_pos - q (+bias 2^20 to stay unsigned for leading exons
    whose region start precedes the query diagonal origin).

    When k is given and small (<= 12), the per-query binary search over
    the sorted region oligos is replaced by a direct-address start/count
    table of size 4^k built with one scatter pass — the vmapped
    searchsorted was the hot spot of the GMAP chain stage (the
    oligoindex_hr.c role of a direct-address table, re-expressed as
    scatter+gather)."""
    Q = q_oligos.shape[0]
    if k is not None and k <= 12:
        T = 1 << (2 * k)
        R = sorted_oligos.shape[0]
        i = jnp.arange(R, dtype=jnp.int32)
        so_i = jnp.minimum(sorted_oligos, jnp.uint32(T)).astype(jnp.int32)
        prev = jnp.concatenate([jnp.array([-1], jnp.int32), so_i[:-1]])
        is_first = so_i != prev
        # non-first entries scatter into dump row T (discarded)
        starts = jnp.zeros(T + 1, jnp.int32).at[
            jnp.where(is_first, so_i, T)].set(i, mode="drop")
        counts = jnp.zeros(T + 1, jnp.int32).at[so_i].add(1, mode="drop")
        counts = counts.at[T].set(0)
        qo = jnp.minimum(q_oligos, jnp.uint32(T)).astype(jnp.int32)
        start = jnp.take(starts, qo)
        count = jnp.take(counts, qo)
    else:
        start = jnp.searchsorted(sorted_oligos, q_oligos, side="left")
        end = jnp.searchsorted(sorted_oligos, q_oligos, side="right")
        count = (end - start).astype(jnp.int32)
    lane = jnp.arange(max_occ, dtype=jnp.int32)[None, :]
    idx = start.astype(jnp.int32)[:, None] + lane
    pos = jnp.take(sorted_pos, idx, mode="clip")
    # overabundant oligos are dropped entirely by default (the stage2
    # overabundance mask); keep_overabundant instead keeps their first
    # max_occ hits — the repetitive-region fallback
    if keep_overabundant:
        ok = q_valid[:, None] & (lane < count[:, None])
    else:
        ok = (q_valid & (count <= max_occ))[:, None] & (lane < count[:, None])
    q = jnp.arange(Q, dtype=jnp.int32)
    diag = pos.astype(jnp.int32) - q[:, None] + DIAG_BIAS
    diag = jnp.where(ok, diag, jnp.int32(0x7FFFFFFF)).astype(jnp.uint32)
    return diag, jnp.broadcast_to(q[:, None], (Q, max_occ)), ok


DIAG_BIAS = 1 << 20  # offsets diag so leading query overhang stays unsigned
ANCHOR_INVALID = np.uint32(0x7FFFFFFF)


def anchors_to_segments(diag: jax.Array, q: jax.Array, ok: jax.Array,
                        n_segments: int, k: int, max_qgap: int = 24):
    """Collapse anchors into diagonal runs; keep the top-S by anchor count.

    Inputs are [Q, max_occ] from anchors_from_query. A segment is a maximal
    set of anchors on one diagonal with successive q gaps <= max_qgap (small
    gaps absorb mismatch-broken k-mer runs, like stage2's lookback).

    Returns dict of int32[n_segments]: diag (biased), qstart, qend
    (inclusive anchor start positions; exon span is [qstart, qend + k - 1]),
    weight (anchor count), valid.
    """
    dflat = diag.reshape(-1)
    qflat = q.reshape(-1).astype(jnp.int32)
    okflat = ok.reshape(-1)
    N = dflat.shape[0]
    # lexicographic (diag, q) sort without 64-bit keys: stable sort by q,
    # then stable sort by diag (invalid anchors pushed to the end)
    dkey = jnp.where(okflat, dflat, jnp.uint32(0xFFFFFFFF))
    # two-key co-sort (diag, then q) carrying the payloads through the
    # sort network instead of argsort + permutation gathers
    d, qq, o = jax.lax.sort((dkey, qflat, okflat), num_keys=2)
    d = jnp.where(o, d, ANCHOR_INVALID)

    prev_d = jnp.concatenate([jnp.array([ANCHOR_INVALID], d.dtype), d[:-1]])
    prev_q = jnp.concatenate([jnp.array([-10 ** 6], qq.dtype), qq[:-1]])
    is_start = (d != prev_d) | (qq - prev_q > max_qgap)
    is_start = is_start & o

    i = jnp.arange(N, dtype=jnp.int32)
    run_start = jax.lax.cummax(jnp.where(is_start, i, 0))
    nxt_start = jnp.concatenate([is_start[1:] | ~o[1:], jnp.array([True])])
    is_last = o & nxt_start

    weight = jnp.where(is_last, i - run_start + 1, 0)
    qstart = jnp.take(qq, run_start)
    seg_w, seg_idx = jax.lax.top_k(weight, n_segments)
    valid = seg_w > 0
    return {
        "diag": jnp.where(valid, jnp.take(d, seg_idx).astype(jnp.int32), 0),
        "qstart": jnp.where(valid, jnp.take(qstart, seg_idx), 0),
        "qend": jnp.where(valid, jnp.take(qq, seg_idx), 0),
        "weight": seg_w,
        "valid": valid,
    }


def gap_cost(gs: jax.Array, ge: jax.Array) -> jax.Array:
    """float32[j, i] cost of joining segment i (genomic end ge[i]) to
    segment j (genomic start gs[j]): discourages absurd joins but never
    beats real anchors.  The chain DP's one float op."""
    return jnp.log1p(jnp.abs(gs[None, :] - ge[:, None])
                     .astype(jnp.float32)).T * 0.01


def chain_segments(segs: dict, max_intron: int = 500_000,
                   max_qoverlap_frac: float = 0.5):
    """Pick the best collinear segment chain (max-plus DP over segments).

    Segments are ordered by qstart; seg j may follow seg i iff
      qstart_j > qstart_i, genomic order is preserved, the genomic gap is
      within max_intron, and the query overlap is small.
    Score = sum of segment weights (anchor counts) minus a mild gap cost.

    Returns (order int32[S] chain members sorted by q, in_chain bool[S]).
    """
    S = segs["diag"].shape[0]
    # reorder by qstart for a forward scan
    qkey = jnp.where(segs["valid"], segs["qstart"], jnp.int32(2 ** 30))
    order = jnp.argsort(qkey)
    diag = segs["diag"][order]
    qs = segs["qstart"][order]
    qe = segs["qend"][order]
    w = segs["weight"][order]
    valid = segs["valid"][order]
    gs = diag + qs    # biased genomic start of segment
    ge = diag + qe

    span = jnp.maximum(qe - qs + 1, 1)

    def allowed(i, j):
        """may j follow i (i before j in query)?"""
        q_adv = qs[j] > qs[i]
        g_adv = gs[j] > ge[i]
        intron_ok = (gs[j] - ge[i]) < max_intron
        overlap = jnp.maximum(qe[i] - qs[j] + 1, 0)
        ov_ok = overlap < (jnp.minimum(span[i], span[j]) *
                           max_qoverlap_frac).astype(jnp.int32)
        return q_adv & g_adv & intron_ok & ov_ok & valid[i] & valid[j]

    ii = jnp.arange(S)
    adj = jax.vmap(lambda j: jax.vmap(lambda i: allowed(i, j))(ii))(ii)  # [j, i]

    gapcost = gap_cost(gs, ge)

    def step(scores, j):
        cand = jnp.where(adj[j], scores - gapcost[j], jnp.float32(NEG))
        best = jnp.max(cand)
        bestp = jnp.argmax(cand)
        sj = jnp.where(valid[j], w[j].astype(jnp.float32) +
                       jnp.maximum(best, 0.0), jnp.float32(NEG))
        prev = jnp.where(best > 0, bestp, -1)
        return scores.at[j].set(sj), prev

    scores0 = jnp.full((S,), NEG, dtype=jnp.float32)
    scores, prevs = jax.lax.scan(step, scores0, jnp.arange(S))

    # backtrack from the best end
    end = jnp.argmax(scores)

    def bt(state, _):
        cur, members = state
        members = members.at[jnp.maximum(cur, 0)].set(
            jnp.where(cur >= 0, True, members[jnp.maximum(cur, 0)]))
        nxt = jnp.where(cur >= 0, prevs[jnp.maximum(cur, 0)], -1)
        return (nxt, members), None

    members0 = jnp.zeros((S,), dtype=jnp.bool_)
    (_, in_chain), _ = jax.lax.scan(bt, (end.astype(jnp.int32), members0),
                                    None, length=S)
    return order, in_chain
