"""Batched multi-junction path solver + end trimming (device kernels).

Batched re-expression of the reference's path-solving/trimming stack:

* ``src/path-solve.c`` (Path_solve_from_diagonals, combine_leftright_paths,
  MAX_DEPTH_MIDDLE): resolving a read against several candidate diagonals
  with splice junctions / deletions between them;
* ``src/path-trim.c`` (Path_trim_qstart/qend) + ``src/genomebits_trim.c``
  (Genomebits_trim_qstart/qend): soft-clip trimming of dirty read ends by
  match/mismatch scoring;
* ``src/splice.c`` (Splice_resolve): junction placement by
  mismatch-vs-canonical-dinucleotide/known-site tradeoff.

The reference solves one read at a time by bounded recursive descent over
data-dependent candidates. Here the whole candidate set is solved with ONE
dynamic program over query positions — a local-alignment chain DP:

    H[k] = best score of an alignment ending at query position q while on
           candidate diagonal k

with transitions (a) extend on the same diagonal (match/mismatch score),
(b) open a fresh alignment at q (the prefix [0, q) is soft-clipped for
free), (c) jump from a genomically-earlier diagonal k' to k paying a
deletion cost (gap < min_intron) or an intron cost scored by canonical
dinucleotides (GT-AG/GC-AG/AT-AC and antisense) and known splice sites.
Ending is free anywhere (suffix soft-clipped), so end trimming falls out
of the local-alignment semantics rather than being a separate pass.

The DP is a lax.scan over query positions with [R, K, K] transition math
per step — all elementwise/reduce ops, no data-dependent control
flow; traceback is a second (reverse) scan producing fixed-size segment
arrays. R is the compacted unsolved-read set, so the O(L·K²) work runs on
a few hundred rows, not the whole batch.

Scores are integers scaled by 8 (one match = +8) so fractional bonuses
stay integral.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INVALID = np.uint32(0xFFFFFFFF)
NEG = np.int32(-(2 ** 20))

MAX_SEGMENTS = 8        # = K: segments visit strictly increasing diagonals,
#                         so a K-candidate set yields at most K segments
#                         (>= reference MAX_DEPTH bounds, path-solve.c:14-20)


@dataclass(frozen=True)
class PathScoring:
    """Integer scores, scaled so one match = +8.

    Mismatch defaults to -24 (= -3 matches, the reference's
    trim_mismatch_score default, src/gsnap.c); with per-base qualities the
    mismatch cost is quality-weighted instead (MAPQ_loglik_string role,
    src/mapq.c). Junction economics: a canonical GT-AG intron costs a net
    40 (must save >= 2 mismatches to open), semi-canonical 50/60,
    noncanonical 90 (>= 3 mismatches), a known junction 16 — mirroring
    Splice_resolve's preference order (known > GT-AG > GC-AG > AT-AC >
    noncanonical, src/splice.c).
    """
    match: int = 8
    mismatch: int = -24
    del_open: int = -24          # 1-base deletion
    del_extend: int = -8         # per additional deleted base
    splice_base: int = -90       # noncanonical junction
    bonus_gtag: int = 50
    bonus_gcag: int = 40
    bonus_atac: int = 30
    bonus_known: int = 74        # net -16: known junctions open readily
    min_intron: int = 9          # same as path-solve.c MIN_INTRONLEN
    max_intron: int = 200_000
    # insertions INSIDE the chain (src/path-solve.c:309
    # Indel_resolve_middle_insertion interleaved with splice resolution,
    # src/junction.h:5 INS_JUNCTION): a jump to a genomically-EARLIER
    # diagonal by n <= max_insert bases is an n-base query insertion.
    ins_open: int = -24
    ins_extend: int = -8
    max_insert: int = 6
    # noncanonical novel junctions pay splice_base with no bonus (the
    # MaxEnt-low-probability analog); False rejects them outright.
    # Ambiguity control is downstream: a noncanonical junction whose
    # boundary placement TIES under wobble is demoted to a soft clip by
    # the splice-ends review (driver._late_stages), per altsplice.c.
    allow_noncanon: bool = True


def quality_mismatch_cost(quals: jax.Array) -> jax.Array:
    """Per-base mismatch cost from phred qualities (uint8[..., L]).

    Q30 -> -24 (the flat default); low-quality bases are nearly free to
    mismatch, the MAPQ_loglik_string weighting idea (src/mapq.h:18-20)
    applied to alignment scoring.
    """
    q = jnp.minimum(quals.astype(jnp.int32), 40)
    return -(8 + (q * 8) // 15)


# dinucleotide codes (2-bit base codes a=0 c=1 g=2 t=3, hi*4+lo)
_GT, _AG, _GC, _AT, _CT, _AC = 11, 2, 9, 3, 7, 1


@partial(jax.jit, static_argnames=("scoring", "with_quals"))
def chain_solve(index, codes: jax.Array, nmask: jax.Array,
                lengths: jax.Array, diags: jax.Array,
                scoring: PathScoring = PathScoring(),
                with_quals: bool = False,
                quals: jax.Array | None = None,
                known=None):
    """Solve each read against its candidate diagonal set.

    codes uint8[R, L] in the ALIGNED orientation (caller orients rc reads),
    nmask bool[R, L], lengths int32[R], diags uint32[R, K] candidate
    univdiagonals (INVALID-padded; unsorted OK — sorted internally).
    quals: uint8[R, L] phred scores (used iff with_quals).
    known: optional dict of sorted uint32 coord arrays
    {donor, acceptor, antidonor, antiacceptor} (gsnap/knownsplicing.py).

    Returns dict (all device arrays):
      score int32[R]          best local chain score
      q_start/q_end int32[R]  aligned query interval [q_start, q_end)
      nsegs int32[R]          number of segments (1 = no junction)
      seg_q int32[R, S]       segment start query positions, ascending
      seg_diag uint32[R, S]   univdiagonal per segment
      nmm int32[R]            mismatches inside the aligned interval
    """
    R, L = codes.shape
    K = diags.shape[1]
    S = MAX_SEGMENTS

    # sort candidates by diagonal so junction/deletion jumps are k' < k
    diags_sorted = jnp.sort(diags, axis=1)
    valid_k = diags_sorted != INVALID
    d0 = jnp.where(valid_k, diags_sorted, 0)

    from tpumap.ops import verify
    gwin = verify.extract_codes_window(index.genome_packed, d0, L + 1)
    mm = (codes[:, None, :] != gwin[..., :L])
    if getattr(index, "genome_has_n", True):
        gn2 = verify.extract_bit_window(index.genome_nmask, d0,
                                        (L + 15) // 16)
        gnb = verify.mismatch_base_mask(gn2, L)
        mm = mm | gnb
    mm = mm | nmask[:, None, :]

    inlen = jnp.arange(L, dtype=jnp.int32)[None, :] < lengths[:, None]
    if with_quals:
        miscost = quality_mismatch_cost(quals)[:, None, :]
    else:
        miscost = jnp.int32(scoring.mismatch)
    s = jnp.where(mm, miscost, jnp.int32(scoring.match))
    s = jnp.where(inlen[:, None, :] & valid_k[..., None], s, 0)

    # dinucleotides starting at each genome offset q: don[r, k, q] is the
    # pair (q, q+1) on diagonal k; the acceptor dinuc for a boundary at q
    # is the pair (q-2, q-1) = don[..., q-2]
    don = (gwin[..., 0:L] * 4 + gwin[..., 1:L + 1]).astype(jnp.int32)
    acc = jnp.concatenate(
        [jnp.full((R, K, 2), 16, jnp.int32), don[..., :L - 2]], axis=-1)

    if known is not None:
        from tpumap.gsnap.knownsplicing import coords_in_set
        qs = jnp.arange(L, dtype=jnp.uint32)[None, None, :]
        site = d0[..., None] + qs                       # [R, K, L]
        kdon = coords_in_set(known["donor"], site)
        kacc = coords_in_set(known["acceptor"], site)
        kantidon = coords_in_set(known["antidonor"], site)
        kantiacc = coords_in_set(known["antiacceptor"], site)
    else:
        z = jnp.zeros((R, K, L), jnp.bool_)
        kdon = kacc = kantidon = kantiacc = z

    # junction geometry [R, K', K]: gap = diag[k] - diag[k'] in uint32
    # wrap semantics — a genomically-earlier k (negative true gap) wraps to
    # a huge value and is rejected by the <= max_intron test
    gap = (diags_sorted[:, None, :] - diags_sorted[:, :, None])
    is_del = (gap >= jnp.uint32(1)) & (gap < jnp.uint32(scoring.min_intron))
    is_intron = ((gap >= jnp.uint32(scoring.min_intron))
                 & (gap <= jnp.uint32(scoring.max_intron)))
    gap_small = jnp.minimum(gap, jnp.uint32(scoring.min_intron)
                            ).astype(jnp.int32)
    del_cost = (jnp.int32(scoring.del_open)
                + jnp.int32(scoring.del_extend)
                * jnp.maximum(gap_small - 1, 0))
    # insertion jump: new diagonal n bases EARLIER (query gains n bases
    # with no genome counterpart).  The DP walks every query position, so
    # a jump at q means the n query bases [q-n, q) are the inserted run:
    # H already match/mismatch-scored them on the OLD diagonal k', and
    # the transition subtracts exactly those n per-base scores back out
    # (a rolling window of recent s values carried through the scan), so
    # the chain score equals the emitted alignment's score regardless of
    # where the tie-free boundary lands.  Emission: previous segment M
    # ends at q-n, query [q-n, q) is the nI run, new segment starts at q.
    neg_gap = jnp.uint32(0) - gap                     # d[k'] - d[k]
    is_ins = ((neg_gap >= jnp.uint32(1))
              & (neg_gap <= jnp.uint32(scoring.max_insert)))
    nins = jnp.minimum(neg_gap, jnp.uint32(scoring.max_insert)
                       ).astype(jnp.int32)
    ins_cost = (jnp.int32(scoring.ins_open)
                + jnp.int32(scoring.ins_extend) * jnp.maximum(nins - 1, 0))
    NI = int(scoring.max_insert)
    pair_ok = valid_k[:, :, None] & valid_k[:, None, :]

    b_gtag = jnp.int32(scoring.bonus_gtag)
    b_gcag = jnp.int32(scoring.bonus_gcag)
    b_atac = jnp.int32(scoring.bonus_atac)
    b_known = jnp.int32(scoring.bonus_known)
    splice_base = jnp.int32(scoring.splice_base)
    match_i = jnp.int32(scoring.match)

    # scan inputs, time-major; pad L to a multiple of the unroll factor
    # (padded steps have q >= lengths and are inert under the active
    # guard).  Unrolling amortizes the per-step scan overhead — the
    # [R, K, K] transition math is small, so step dispatch dominated.
    U = 4
    Lp = ((L + U - 1) // U) * U
    pad = Lp - L

    def tmajor(x, fill=0):
        x = jnp.transpose(x, (2, 0, 1))
        if pad:
            x = jnp.concatenate(
                [x, jnp.full((pad, *x.shape[1:]), fill, x.dtype)], axis=0)
        return x.reshape(Lp // U, U, *x.shape[1:])

    s_t = tmajor(s)                                   # [L/U, U, R, K]
    don_t = tmajor(don)
    acc_t = tmajor(acc)
    kdon_t = tmajor(kdon)
    kacc_t = tmajor(kacc)
    kantidon_t = tmajor(kantidon)
    kantiacc_t = tmajor(kantiacc)
    q_t = jnp.arange(Lp, dtype=jnp.int32).reshape(Lp // U, U)

    start_val = jnp.where(valid_k, 0, NEG)            # [R, K]

    def step1(carry, xs):
        H, best_score, best_q, best_k, recent = carry
        s_q, don_q, acc_q, kd_q, ka_q, kad_q, kaa_q, q = xs

        dj = don_q[:, :, None]                        # donor on k'
        aj = acc_q[:, None, :]                        # acceptor on k
        sense_b = jnp.where((dj == _GT) & (aj == _AG), b_gtag,
                            jnp.where((dj == _GC) & (aj == _AG), b_gcag,
                                      jnp.where((dj == _AT) & (aj == _AC),
                                                b_atac, jnp.int32(0))))
        anti_b = jnp.where((dj == _CT) & (aj == _AC), b_gtag,
                           jnp.where((dj == _CT) & (aj == _GC), b_gcag,
                                     jnp.where((dj == _GT) & (aj == _AT),
                                               b_atac, jnp.int32(0))))
        canon = jnp.maximum(sense_b, anti_b)
        known_pair = ((kd_q[:, :, None] & ka_q[:, None, :])
                      | (kaa_q[:, :, None] & kad_q[:, None, :]))
        bonus = jnp.maximum(canon, jnp.where(known_pair, b_known, 0))
        intron_cost = splice_base + bonus
        if not scoring.allow_noncanon:
            intron_cost = jnp.where(bonus > 0, intron_cost, NEG)

        # exact insertion correction: remove the per-base scores H
        # accumulated on the OLD diagonal for the n inserted bases
        # [q-n, q) — recent[r, k', j] = s at step q-1-j on diagonal k'
        run = jnp.cumsum(recent, axis=-1)             # [R, K, NI]
        corr = jnp.zeros_like(ins_cost)
        for n in range(1, NI + 1):
            corr = jnp.where(nins == n, run[..., n - 1][:, :, None], corr)
        trans = jnp.where(is_intron, intron_cost,
                          jnp.where(is_del, del_cost,
                                    jnp.where(is_ins, ins_cost - corr,
                                              NEG)))
        # an insertion jump at q needs the n inserted bases to exist
        # before q (q >= n + 1 so the previous segment keeps >= 1 base)
        trans = jnp.where(is_ins & (q < nins + 1), NEG, trans)
        trans = jnp.where(pair_ok & (q >= 1), trans, NEG)

        jump = H[:, :, None] + trans                  # [R, K', K]
        switch_best = jnp.max(jump, axis=1)           # [R, K]
        switch_arg = jnp.argmax(jump, axis=1).astype(jnp.int32)

        cont = H
        best3 = jnp.maximum(cont, jnp.maximum(start_val, switch_best))
        choice = jnp.where(best3 == cont, jnp.int32(0),
                           jnp.where(best3 == start_val, jnp.int32(1),
                                     jnp.int32(2) + switch_arg))
        H_next = best3 + s_q

        active = (q < lengths)[:, None]
        H_next = jnp.where(active, H_next, H)
        choice = jnp.where(active, choice, 0).astype(jnp.uint8)
        recent = jnp.where(
            active[..., None],
            jnp.concatenate([s_q[..., None], recent[..., :-1]], axis=-1),
            recent)

        row_best = jnp.max(H_next, axis=1)
        row_k = jnp.argmax(H_next, axis=1).astype(jnp.int32)
        # ties keep the LATEST co-optimal end (less trim, the
        # reference's trim-scan tie rule — and a hidden tail exon whose
        # net gain exactly equals the intron cost ties the clipped
        # path: the junction explains more of the read at equal score)
        upd = (row_best >= best_score) & (q < lengths)
        best_score = jnp.where(upd, row_best, best_score)
        best_q = jnp.where(upd, q, best_q)
        best_k = jnp.where(upd, row_k, best_k)
        return (H_next, best_score, best_q, best_k, recent), choice

    def step(carry, xs):
        outs = []
        for u in range(U):
            carry, choice = step1(carry, tuple(x[u] for x in xs))
            outs.append(choice)
        return carry, jnp.stack(outs, axis=0)

    H0 = jnp.full((R, K), NEG, jnp.int32)
    bs0 = jnp.full((R,), NEG, jnp.int32)
    bq0 = jnp.zeros((R,), jnp.int32)
    bk0 = jnp.zeros((R,), jnp.int32)
    rec0 = jnp.zeros((R, K, NI), jnp.int32)
    (H_last, best_score, best_q, best_k, _rec), choices = jax.lax.scan(
        step, (H0, bs0, bq0, bk0, rec0),
        (s_t, don_t, acc_t, kdon_t, kacc_t, kantidon_t, kantiacc_t, q_t))
    choices = choices.reshape(Lp, R, K)[:L]
    # choices: [L, R, K] uint8

    # ---- traceback (reverse scan) ----
    def back1(carry, xs):
        k_cur, done, seg_idx, seg_q, seg_k, skip = carry
        c_q, q = xs                                   # c_q [R, K]
        inside = (q <= best_q) & ~done
        c = jnp.take_along_axis(c_q, k_cur[:, None], axis=1)[:, 0]
        c = c.astype(jnp.int32)
        is_start = inside & (c == 1)
        is_switch = inside & (c >= 2)
        event = is_start | is_switch
        slot = (jnp.arange(S, dtype=jnp.int32)[None, :]
                == seg_idx[:, None]) & event[:, None]
        seg_q = jnp.where(slot, q, seg_q)
        seg_k = jnp.where(slot, k_cur[:, None], seg_k)
        seg_idx = seg_idx + event.astype(jnp.int32)
        # inserted query bases (the skip>0 window below an insertion
        # jump) are I ops in the emitted alignment: exclude them from
        # the per-base diag track so nmm matches the emitted NM
        kk = jnp.where(inside & (skip == 0), k_cur, -1)
        skip = jnp.where(inside, jnp.maximum(skip - 1, 0), skip)
        d_cur = jnp.take_along_axis(diags_sorted, k_cur[:, None],
                                    axis=1)[:, 0]
        kp = jnp.clip(c - 2, 0, K - 1)
        d_prev = jnp.take_along_axis(diags_sorted, kp[:, None],
                                     axis=1)[:, 0]
        n_ij = d_prev - d_cur                         # uint32 wrap
        ins_j = is_switch & (n_ij >= jnp.uint32(1)) & (
            n_ij <= jnp.uint32(scoring.max_insert))
        skip = jnp.where(ins_j, n_ij.astype(jnp.int32), skip)
        k_cur = jnp.where(is_switch, c - 2, k_cur)
        done = done | is_start
        return (k_cur, done, seg_idx, seg_q, seg_k, skip), kk

    def back(carry, xs):
        outs = []
        for u in range(U):
            carry, kk = back1(carry, tuple(x[u] for x in xs))
            outs.append(kk)
        return carry, jnp.stack(outs, axis=0)

    # reversed + padded (padded steps carry q < 0: no choice events, and
    # their kk output rows are sliced away below)
    c_rev = jnp.concatenate(
        [choices[::-1], jnp.zeros((pad, R, K), choices.dtype)], axis=0)
    q_rev = jnp.concatenate(
        [jnp.arange(L - 1, -1, -1, dtype=jnp.int32),
         jnp.full((pad,), -1, jnp.int32)])
    c_rev = c_rev.reshape(Lp // U, U, R, K)
    q_rev = q_rev.reshape(Lp // U, U)
    (k_fin, done_fin, nsegs, seg_q_rev, seg_k_rev, _sk), kk_rev = \
        jax.lax.scan(
            back,
            (best_k, jnp.zeros((R,), jnp.bool_),
             jnp.zeros((R,), jnp.int32),
             jnp.zeros((R, S), jnp.int32),
             jnp.zeros((R, S), jnp.int32),
             jnp.zeros((R,), jnp.int32)),
            (c_rev, q_rev))
    kk = kk_rev.reshape(Lp, R)[:L][::-1]              # [L, R]
    kk = jnp.transpose(kk, (1, 0))                    # [R, L]

    # segments were recorded last-first; flip to ascending query order
    flip_idx = jnp.maximum(nsegs[:, None] - 1
                           - jnp.arange(S, dtype=jnp.int32)[None, :], 0)
    seg_q = jnp.take_along_axis(seg_q_rev, flip_idx, axis=1)
    seg_k = jnp.take_along_axis(seg_k_rev, flip_idx, axis=1)
    in_seg = jnp.arange(S, dtype=jnp.int32)[None, :] < nsegs[:, None]
    seg_q = jnp.where(in_seg, seg_q, 0)
    seg_diag = jnp.where(
        in_seg,
        jnp.take_along_axis(diags_sorted, seg_k, axis=1), INVALID)

    # mismatches inside the aligned interval
    kk_c = jnp.clip(kk, 0, K - 1)
    mm_path = jnp.take_along_axis(mm, kk_c[:, None, :], axis=1)[:, 0, :]
    nmm = jnp.sum(jnp.where(kk >= 0, mm_path, False), axis=1).astype(jnp.int32)

    q_start = seg_q[:, 0]
    q_end = best_q + 1
    return {"score": best_score, "q_start": q_start, "q_end": q_end,
            "nsegs": nsegs, "seg_q": seg_q, "seg_diag": seg_diag,
            "nmm": nmm}


def _trim_scan(scores, mask, redemption, interval_len, idx, descending):
    """One direction of the reference end-trim scan
    (Spliceends_trim_qstart/qend_nosplice, src/spliceends.c:4121).

    In scan order over mismatch positions (mask): track the running max
    score with >=-updates (ties keep scanning-later = less trim); stop at
    the first mismatch where score < max AND score + redemption < 0; after
    an untruncated scan keep the FULL interval if (a) the best trim was at
    the last-scanned mismatch or (b) the whole interval's score
    (interval_len - 4*m) beats the best.

    Returns (best_pos, keep_full) — best_pos = the winning mismatch
    position (meaningless when keep_full).
    """
    L = scores.shape[-1]
    sc = jnp.where(mask, scores, NEG)
    axis = sc.ndim - 1
    if descending:
        runmax_incl = jax.lax.cummax(sc[..., ::-1], axis=axis)[..., ::-1]
        runmax_excl = jnp.concatenate(
            [runmax_incl[..., 1:],
             jnp.full((*sc.shape[:-1], 1), NEG, jnp.int32)], axis=-1)
    else:
        runmax_incl = jax.lax.cummax(sc, axis=axis)
        runmax_excl = jnp.concatenate(
            [jnp.full((*sc.shape[:-1], 1), NEG, jnp.int32),
             runmax_incl[..., :-1]], axis=-1)
    term = mask & (scores < runmax_excl) & (scores + redemption < 0)
    any_term = jnp.any(term, axis=-1)
    if descending:
        # scan goes from high idx down: first termination = largest idx
        first_term = jnp.max(jnp.where(term, idx, -1), axis=-1)
        allowed = mask & (idx >= first_term[..., None])
    else:
        first_term = jnp.min(jnp.where(term, idx, L), axis=-1)
        allowed = mask & (idx <= first_term[..., None])
    best_sc = jnp.max(jnp.where(allowed, scores, NEG), axis=-1)
    is_best = allowed & (scores == best_sc[..., None])
    if descending:      # scan-latest = smallest position
        best_pos = jnp.min(jnp.where(is_best, idx, L), axis=-1)
        j_star = jnp.sum(mask & (idx > best_pos[..., None]),
                         axis=-1)
    else:
        best_pos = jnp.max(jnp.where(is_best, idx, -1), axis=-1)
        j_star = jnp.sum(mask & (idx < best_pos[..., None]),
                         axis=-1)
    m = jnp.sum(mask, axis=-1).astype(jnp.int32)
    keep1 = (~any_term) & (j_star == m - 1)
    score_last = interval_len - 4 * m
    keep2 = (~any_term) & (score_last >= best_sc)
    keep_full = (m == 0) | keep1 | keep2
    return best_pos.astype(jnp.int32), keep_full


def trim_ends(mm: jax.Array, lengths: jax.Array,
              match: int = 8, mismatch: int = -24):
    """End trimming of an ungapped alignment — exact re-expression of the
    reference's Spliceends_trim_qstart/qend_nosplice scoring
    (src/spliceends.c:4110-4216, constants src/genomebits_trim.c:24-25:
    match +1 / mismatch -3, here verified empirically against
    /tmp/refbin/gsnap soft-clip CIGARs on terminal-mismatch reads).

    mm bool[..., L] per-base mismatch flags in aligned orientation.
    qstart is trimmed first over [0, len), then qend over [qstart, len)
    (the localdb-read.c:2062-2082 order). Trims anchor AT mismatch
    positions: qstart = winning_mm + 1, qend = winning_mm; isolated
    boundary mismatches are kept (the reference's keep-full rules), so a
    single leading mismatch yields no clip but a 2-mismatch run does.

    Returns (q_start, q_end, score, nmm_inside) int32 arrays [...];
    score = match/mismatch-weighted score of the kept interval (default
    8/-24, the chain-solver scale — same 1:3 ratio as the reference).
    """
    L = mm.shape[-1]
    idx = jnp.arange(L, dtype=jnp.int32)
    inlen = idx < lengths[..., None]
    mask = mm & inlen
    cnt_incl = jnp.cumsum(mask.astype(jnp.int32), axis=-1)
    cnt_excl = cnt_incl - mask.astype(jnp.int32)
    m_tot = jnp.sum(mask, axis=-1).astype(jnp.int32)

    # --- qstart: scan mismatches from the 3' end leftward
    right_excl = m_tot[..., None] - cnt_incl      # mms strictly right of p
    sc_start = (lengths[..., None] - idx - 1) - 4 * right_excl
    red_start = idx + 1                           # pos + 1 - pos5
    best_p, keep_full = _trim_scan(sc_start, mask, red_start,
                                   lengths, idx, descending=True)
    q_start = jnp.where(keep_full, 0, best_p + 1)
    q_start = jnp.minimum(q_start, lengths)

    # --- qend: scan mismatches in [q_start, len) rightward
    mask2 = mask & (idx >= q_start[..., None])
    cnt_at_qs = jnp.take_along_axis(
        jnp.concatenate([jnp.zeros((*mask.shape[:-1], 1), jnp.int32),
                         cnt_incl], axis=-1),
        q_start[..., None], axis=-1)              # mms strictly before qs
    left_excl = cnt_excl - cnt_at_qs              # mms in [qs, p)
    sc_end = (idx - q_start[..., None]) - 4 * left_excl
    red_end = lengths[..., None] - idx            # pos3 - pos
    best_p2, keep_full2 = _trim_scan(sc_end, mask2, red_end,
                                     lengths - q_start, idx,
                                     descending=False)
    q_end = jnp.where(keep_full2, lengths, best_p2)
    q_end = jnp.maximum(q_end, q_start)

    mmq = mask.astype(jnp.int32)
    pref_mm = jnp.concatenate(
        [jnp.zeros((*mm.shape[:-1], 1), jnp.int32),
         jnp.cumsum(mmq, axis=-1)], axis=-1)
    nmm_in = (jnp.take_along_axis(pref_mm, q_end[..., None], axis=-1)
              - jnp.take_along_axis(pref_mm, q_start[..., None], axis=-1)
              )[..., 0]
    alen = q_end - q_start
    score = match * (alen - nmm_in) + mismatch * nmm_in
    return q_start, q_end, score, nmm_in
