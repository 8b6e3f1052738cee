"""Fused device refinement ladder — cascade + splice + indel in ONE jit.

The round-2 driver ran the method ladder as host-orchestrated stages
(cascade -> host -> indel DP -> host -> candidate assembly -> chain DP ->
host -> salvage scan -> host), each stage a separate dispatch and a
separate device->host fetch, so per-stage dispatch and transfer
latency dwarfed the compute.  This module is the batched re-expression
of the whole ladder (src/stage1hr-single.c method ladder + src/path-solve.c
Path_solve_from_diagonals + src/spliceends.c localdb salvage +
src/dynprog_single.c indel DP) as one compiled program:

  cascade (seed/verify/trim)
    -> chain-trigger compaction (fixed R_CHAIN rows)
    -> on-device candidate assembly from the cascade's ranked lists
    -> chain DP pass 1 (multi-junction splices + deletions + trimming)
    -> residual-clip detection -> localdb fragment salvage scan
       (fixed R_SALV rows) -> chain DP pass 2 with augmented candidates
    -> indel-trigger compaction gated on splice failure (fixed R_INDEL)
       -> banded affine DP
    -> one result dict (fetched with a single RPC by the driver)

All compaction sizes are static, so exactly one executable per
(batch-shape, config) serves every batch — no per-batch recompiles.

The salvage pass 2 is also what solves the two-junction reads whose
SHORT middle exon never seeds (the reference finds these through
localdb lookups inside path-solve): pass 1 soft-clips at the missing
exon, the residual-clip fragment scan finds the middle-exon diagonal,
and pass 2 chains all three segments.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpumap.gsnap.engine import (AlignConfig, align_batch_cascaded_packed,
                                 refine_indels)
from tpumap.ops import localscan, pack, pathdp, verify

INVALID = np.uint32(0xFFFFFFFF)

SALVAGE_W = 65536         # localdb region scale (src/localdb-write.c)
SALVAGE_F = 16
RUNLEN = 20               # anchor-run length (driver._anchor_runs parity)
MIN_FRAG = 6


def _oriented_rows_dev(packed, pnmask, lengths, idx, strands, L):
    """Compacted rows as per-base codes in the aligned orientation.

    Reverse-complement runs on the PACKED words (revcomp_packed: word
    reversal + in-word bit games, gather-free) before unpacking — the
    per-element [R, L] take_along_axis revcomp gathers this replaces ran
    at ~20 M elem/s and were the top fusions in the RNA ladder."""
    p = jnp.take(packed, idx, axis=0)
    li = jnp.take(lengths, idx)
    is_rc = (strands == 1)[:, None]
    p_sel = jnp.where(is_rc, pack.revcomp_packed(p, li), p)
    codes = pack.unpack_reads(p_sel, L)
    if pnmask.shape == packed.shape:
        nm_p = jnp.take(pnmask, idx, axis=0)
        nm_sel = jnp.where(is_rc,
                           pack.revcomp_packed(nm_p, li, complement=False),
                           nm_p)
        nmask = pack.unpack_reads(nm_sel, L).astype(jnp.bool_)
    else:
        nmask = jnp.zeros(codes.shape, jnp.bool_)
    return codes, nmask, li


def _dedup_keep_first(cands):
    """INVALID-out duplicate lanes, preserving lane positions."""
    dup = (cands[:, None, :] == cands[:, :, None]) & (
        jnp.arange(cands.shape[1])[None, :] <
        jnp.arange(cands.shape[1])[:, None])[None]
    return jnp.where(jnp.any(dup, axis=2), INVALID, cands)


def _anchor_runs_dev(mm, lengths, L):
    """First RUNLEN-base exact-run start u and last run end e per row
    from a per-base mismatch mask (u = L when no run exists)."""
    mmi = mm.astype(jnp.int32)
    cnt = jnp.concatenate(
        [jnp.zeros((mm.shape[0], 1), jnp.int32), jnp.cumsum(mmi, axis=1)],
        axis=1)
    p = jnp.arange(L - RUNLEN + 1, dtype=jnp.int32)[None, :]
    run = ((jnp.take_along_axis(cnt, p + RUNLEN, axis=1)
            - jnp.take_along_axis(cnt, p, axis=1)) == 0)
    run = run & ((p + RUNLEN) <= lengths[:, None])
    u = jnp.min(jnp.where(run, p, L), axis=1)
    e = jnp.max(jnp.where(run, p + RUNLEN, -1), axis=1)
    return u, e


def _take_window(codes, starts, n, L):
    """codes[r, starts[r] : starts[r]+n] with clipping, uint8[R, n]."""
    idx = jnp.clip(starts[:, None] + jnp.arange(n, dtype=jnp.int32)[None, :],
                   0, L - 1)
    return jnp.take_along_axis(codes, idx, axis=1)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8, 9, 10))
def align_batch_full(index, pbatch, config: AlignConfig, L: int,
                     scoring: pathdp.PathScoring,
                     splicing: bool, salvage: bool,
                     r_chain: int, r_salv: int, r_indel: int,
                     keep_cands: bool = False):
    """One-jit GSNAP ladder. Returns a flat dict of device arrays:

    cascade fields (diag/strand/nmismatch/.../trim_*), plus
    ch_idx/ch_sel/ch_score/ch_qstart/ch_qend/ch_nsegs/ch_segq/ch_segd/
    ch_nmm [r_chain...] (chain solutions for compacted rows) and
    in_idx/in_sel/in_score/in_ops/in_startoff [r_indel...] (banded-DP
    indel solutions for rows the splice pass did not solve).
    """
    from tpumap.utils.fetch import narrow_result
    res = align_batch_cascaded_packed(index, pbatch, config, L)
    return narrow_result(
        refine_full(index, pbatch, res, config, L, scoring, splicing,
                    salvage, r_chain, r_salv, r_indel, keep_cands))


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8, 9))
def align_batch_full_known(index, pbatch, config: AlignConfig, L: int,
                           scoring: pathdp.PathScoring,
                           splicing: bool, salvage: bool,
                           r_chain: int, r_salv: int, r_indel: int,
                           known=None):
    """align_batch_full with known splicing fused in: the chain stage
    derives partner diagonals from the known junction-pair table ON
    DEVICE and scores boundaries with the known-site bonus — gsnap's
    flagship -s mode stays on the one-jit fast path
    (src/knownsplicing.c, src/path-solve.c known-splice resolution)."""
    from tpumap.utils.fetch import narrow_result
    res = align_batch_cascaded_packed(index, pbatch, config, L)
    return narrow_result(
        refine_full(index, pbatch, res, config, L, scoring, splicing,
                    salvage, r_chain, r_salv, r_indel, known=known))


N_PARTNER = 3   # partner diagonals derived per side of the primary diag
#                 (a read can overlap several annotated junction
#                 boundaries in densely-annotated regions)


def refine_full(index, pbatch, res, config: AlignConfig, L: int,
                scoring: pathdp.PathScoring,
                splicing: bool, salvage: bool,
                r_chain: int, r_salv: int, r_indel: int,
                keep_cands: bool = False, known=None):
    """The post-cascade refinement half of align_batch_full, callable
    from any candidate producer — in particular the sharded-index path
    (parallel/sharded.py), whose cascade all-gathers candidates across
    index shards and then refines locally: chain/salvage/indel only
    touch the (replicated) genome, so no further collectives are
    needed.  `index` needs genome_packed/genome_nmask/genome_has_n/
    chrom_offsets; `res` needs the cascade result incl. cand_* lists
    and trim_* fields."""
    lengths = pbatch["lengths"]
    B = lengths.shape[0]
    diag = res["diag"]
    strand = res["strand"]
    valid = diag != INVALID
    out = dict(res)

    nmm = res["nmismatch"]
    trim_nmm = res.get("trim_nmm", nmm)
    if "trim_qstart" in res:
        tqs = res["trim_qstart"]
        tqe = jnp.minimum(res["trim_qend"], lengths)
        clip = tqs + (lengths - tqe)
    else:
        clip = jnp.zeros_like(nmm)

    from tpumap.gsnap.params import (CLIP_INDEL_TRIGGER,
                                     CLIP_SPLICE_TRIGGER,
                                     INDEL_BAND, INDEL_MARGIN,
                                     INDEL_NMM_TRIGGER,
                                     SPLICE_NMM_TRIGGER)

    splice_accept_b = jnp.zeros((B,), jnp.bool_)
    if splicing:
        rc = min(r_chain, B)
        chain_m = valid & ((trim_nmm >= SPLICE_NMM_TRIGGER)
                           | (clip >= CLIP_SPLICE_TRIGGER))
        # compaction ranked by SIGNAL (clip + excess mismatches), batch
        # order breaking ties: when trigger rows exceed r_chain, the
        # weakest (trim-noise) rows overflow, not arbitrary real
        # spliced reads (the round-4 recall collapse)
        signal = jnp.clip(clip + trim_nmm, 0, 255)
        prio = jnp.where(chain_m,
                         signal * jnp.int32(2 * B)
                         + (jnp.int32(B) - jnp.arange(B,
                                                      dtype=jnp.int32)),
                         0)
        _, idx = jax.lax.top_k(prio, rc)
        sel = jnp.take(chain_m, idx)
        st = jnp.take(strand, idx)
        codes, nmask, li = _oriented_rows_dev(
            pbatch["packed"], pbatch["pnmask"], lengths, idx, st, L)
        adiag = jnp.take(diag, idx)

        # candidates: the cascade's ranked lists, same-strand, dedup
        cd = jnp.take(res["cand_diags"], idx, axis=0)
        cs = jnp.take(res["cand_strands"], idx, axis=0)
        cands = jnp.where(cs == st[:, None], cd, INVALID)
        if known is not None:
            # partner diagonals from the known junction-pair table (the
            # derived_pairs analog, on device): a junction whose left
            # boundary falls inside the read anchored at `adiag` implies
            # partner diag + intron; one whose right boundary falls
            # inside implies diag - intron
            jl, jli = known["jleft"], known["jleft_intron"]
            jr, jri = known["jright"], known["jright_intron"]
            li_u = jnp.take(lengths, idx).astype(jnp.uint32)
            offs = jnp.arange(N_PARTNER, dtype=jnp.int32)[None, :]

            def partners(coords, introns, sign):
                pos = jnp.searchsorted(coords, adiag + jnp.uint32(1))
                ji = jnp.clip(pos[:, None] + offs, 0,
                              coords.shape[0] - 1)
                c = jnp.take(coords, ji)
                n = jnp.take(introns, ji)
                ok = ((c > adiag[:, None]) & (c < adiag[:, None] + li_u[:, None])
                      & (n > 0) & (n <= jnp.int32(scoring.max_intron)))
                nu = n.astype(jnp.uint32)
                part = (adiag[:, None] + nu if sign > 0
                        else adiag[:, None] - nu)
                if sign < 0:
                    ok = ok & (adiag[:, None] >= nu)
                return jnp.where(ok, part, INVALID)

            cands = jnp.concatenate(
                [cands, partners(jl, jli, +1), partners(jr, jri, -1)],
                axis=1)
        cands = _dedup_keep_first(cands)

        quals = None
        with_quals = "quals" in pbatch
        if with_quals:
            q = jnp.take(pbatch["quals"], idx, axis=0)
            rev = jnp.clip(li[:, None] - 1
                           - jnp.arange(L, dtype=jnp.int32)[None, :],
                           0, L - 1)
            q_rc = jnp.take_along_axis(q, rev, axis=1)
            quals = jnp.where((st == 1)[:, None], q_rc, q)

        c1 = pathdp.chain_solve(index, codes, nmask, li, cands,
                                scoring=scoring, with_quals=with_quals,
                                quals=quals, known=known)

        if salvage:
            rs = min(r_salv, rc)
            # residual clip after pass 1: an unexplained read end >= 6 bp
            # (the missing middle/short exon case)
            resid_pre = c1["q_start"]
            resid_suf = li - c1["q_end"]
            # the trim/chain end absorbs ~1-2 chance-matching exon bases,
            # so a hidden m-base exon often leaves only m-2 clipped; the
            # run statistic (not the clip) is the discriminator, so the
            # salvage NEED gate is looser than MIN_FRAG
            need = sel & ((resid_pre >= MIN_FRAG - 2)
                          | (resid_suf >= MIN_FRAG - 2))
            # rank by residual size so overflow drops the weakest rows
            sres = jnp.clip(jnp.maximum(resid_pre, resid_suf), 0, 255)
            sprio = jnp.where(need,
                              sres * jnp.int32(2 * rc)
                              + (jnp.int32(rc)
                                 - jnp.arange(rc, dtype=jnp.int32)), 0)
            _, sidx = jax.lax.top_k(sprio, rs)
            s_sel = jnp.take(need, sidx)
            s_codes = jnp.take(codes, sidx, axis=0)
            s_li = jnp.take(li, sidx)
            s_qs = jnp.take(c1["q_start"], sidx)
            s_qe = jnp.take(c1["q_end"], sidx)
            # anchor diagonals at the solved path's ends
            s_segq = jnp.take(c1["seg_q"], sidx, axis=0)
            s_segd = jnp.take(c1["seg_diag"], sidx, axis=0)
            nsegs = jnp.take(c1["nsegs"], sidx)
            first_d = s_segd[:, 0]
            last_ix = jnp.maximum(nsegs - 1, 0)[:, None]
            last_d = jnp.take_along_axis(s_segd, last_ix, axis=1)[:, 0]
            has_sol = nsegs >= 1
            s_adiag = jnp.take(adiag, sidx)
            first_d = jnp.where(has_sol, first_d, s_adiag)
            last_d = jnp.where(has_sol, last_d, s_adiag)
            # the scan probes the FULL 16-base read end and ranks window
            # offsets by the longest clean run ANCHORED at the read end
            # (localscan.scan_fragment_runs): the hidden exon of length
            # m scores run = m while a random offset needs P = 4^-run,
            # and the run pins the junction boundary so the splice
            # dinucleotide is checked at the EXACT spot — scanning just
            # the m-base clip drowned in W/4^m chance perfect hits
            # (the round-4 recall sweep: 7/20 found at m=6)
            frag16_s = _take_window(s_codes, s_li - SALVAGE_F,
                                    SALVAGE_F, L)
            ws_s = last_d + s_qe.astype(jnp.uint32) + jnp.uint32(
                scoring.min_intron)
            base_p = first_d + s_qs.astype(jnp.uint32)
            ws_p = jnp.where(
                base_p > jnp.uint32(SALVAGE_W + scoring.min_intron),
                base_p - jnp.uint32(SALVAGE_W + scoring.min_intron),
                jnp.uint32(0))
            frag16_p = _take_window(s_codes, jnp.zeros_like(s_qs),
                                    SALVAGE_F, L)
            pos_s, run_s = localscan.scan_fragment_runs(
                index.genome_packed, ws_s, frag16_s, SALVAGE_W, 8,
                True)
            pos_p, run_p = localscan.scan_fragment_runs(
                index.genome_packed, ws_p, frag16_p, SALVAGE_W, 8,
                False)
            fl_s = jnp.clip(s_li - s_qe, 0, SALVAGE_F)
            fl_p = jnp.clip(s_qs, 0, SALVAGE_F)
            ok_s = ((run_s >= MIN_FRAG)
                    & (fl_s >= MIN_FRAG - 2)[:, None]
                    & (s_li >= SALVAGE_F)[:, None])
            ok_p = ((run_p >= MIN_FRAG)
                    & (fl_p >= MIN_FRAG - 2)[:, None]
                    & (s_li >= SALVAGE_F)[:, None])
            # splice-site anchor at the run-determined boundary: an
            # acceptor (AG/AC) precedes the suffix exon, a donor
            # (GT/CT) follows the prefix exon.  The clean run can
            # EXTEND past the true boundary by chance (P ~ 1/3), so
            # the junction may sit up to 3 bases inside the run — the
            # dinucleotide is accepted at any of those 4 positions.
            # Runs >= 9 are already statistically unique in a 65 kb
            # window and skip the anchor.
            exon_start = pos_s + jnp.uint32(SALVAGE_F) \
                - run_s.astype(jnp.uint32)
            din_s = verify.extract_codes_window(
                index.genome_packed,
                jnp.where(exon_start >= 2, exon_start - jnp.uint32(2),
                          0), 6)
            acc_ok = jnp.zeros(pos_s.shape, jnp.bool_)
            for d in range(4):
                acc_ok = acc_ok | (
                    (din_s[..., d] == 0)
                    & ((din_s[..., d + 1] == 2)
                       | (din_s[..., d + 1] == 1))
                    & (run_s - d >= MIN_FRAG))
            ok_s = ok_s & (acc_ok | (run_s >= 9))
            dp_start = pos_p + run_p.astype(jnp.uint32)
            din_p = verify.extract_codes_window(
                index.genome_packed,
                jnp.where(dp_start >= 3, dp_start - jnp.uint32(3), 0),
                6)
            don_ok = jnp.zeros(pos_p.shape, jnp.bool_)
            for d in range(4):
                don_ok = don_ok | (
                    ((din_p[..., d] == 2) | (din_p[..., d] == 1))
                    & (din_p[..., d + 1] == 3)
                    & (run_p - (3 - d) >= MIN_FRAG))
            ok_p = ok_p & (don_ok | (run_p >= 9))
            # hit -> candidate diagonal
            dB = pos_s - (s_li - SALVAGE_F)[:, None].astype(jnp.uint32)
            ok_s = ok_s & ((dB - last_d[:, None])
                           <= jnp.uint32(scoring.max_intron))
            dA = pos_p
            ok_p = ok_p & ((first_d[:, None] - dA)
                           <= jnp.uint32(scoring.max_intron))
            # MIDDLE-exon fragments (the 2-junction case): pass 1 clips
            # at the missing middle exon, whose bases start exactly at
            # q_end / end at q_start — the read-END-anchored run scans
            # above cannot see them, so the q_end-anchored forward (and
            # q_start-anchored backward) mismatch scans stay alongside
            frag_m = _take_window(s_codes, s_qe, SALVAGE_F, L)
            pos_m, mm_m = localscan.scan_fragment(
                index.genome_packed, ws_s, frag_m,
                jnp.where(fl_s >= MIN_FRAG, fl_s, 0), SALVAGE_W,
                SALVAGE_F, 4)
            ok_m = (mm_m <= 1) & (fl_s >= MIN_FRAG)[:, None]
            dM = pos_m - s_qe[:, None].astype(jnp.uint32)
            ok_m = ok_m & ((dM - last_d[:, None])
                           <= jnp.uint32(scoring.max_intron))
            frag_mp = _take_window(s_codes, s_qs - fl_p, SALVAGE_F, L)
            pos_mp, mm_mp = localscan.scan_fragment(
                index.genome_packed, ws_p, frag_mp,
                jnp.where(fl_p >= MIN_FRAG, fl_p, 0), SALVAGE_W,
                SALVAGE_F, 4)
            ok_mp = (mm_mp <= 1) & (fl_p >= MIN_FRAG)[:, None]
            dMp = pos_mp - (s_qs - fl_p)[:, None].astype(jnp.uint32)
            ok_mp = ok_mp & ((first_d[:, None] - dMp)
                             <= jnp.uint32(scoring.max_intron))
            new_cands = jnp.concatenate(
                [jnp.take(cands, sidx, axis=0),
                 jnp.where(ok_m, dM, INVALID),
                 jnp.where(ok_mp, dMp, INVALID),
                 jnp.where(ok_s, dB, INVALID),
                 jnp.where(ok_p, dA, INVALID)], axis=1)
            # keep the 8 best lanes: original candidates first, then hits
            new_cands = _dedup_keep_first(new_cands)
            K = cands.shape[1]
            lane_valid = new_cands != INVALID
            order = jnp.argsort(~lane_valid, axis=1, stable=True)
            new_cands = jnp.take_along_axis(new_cands, order, axis=1)[:, :K]
            s_nmask = jnp.take(nmask, sidx, axis=0)
            s_quals = (jnp.take(quals, sidx, axis=0) if with_quals
                       else None)
            c2 = pathdp.chain_solve(index, s_codes, s_nmask, s_li,
                                    new_cands, scoring=scoring,
                                    with_quals=with_quals, quals=s_quals,
                                    known=known)
            c1_sc = jnp.take(c1["score"], sidx)
            c1_ns = jnp.take(c1["nsegs"], sidx)
            # ties prefer the higher-coverage (more-segment) solution:
            # a hidden exon of m bases with k chance-matched boundary
            # bases nets exactly (m-k)*8 - 40, which TIES the clip at
            # m-k = 5 — the junction explains more of the read at the
            # same score (found_score coverage preference)
            better = s_sel & ((c2["score"] > c1_sc)
                              | ((c2["score"] == c1_sc)
                                 & (c2["nsegs"] > c1_ns)))
            for key in ("score", "q_start", "q_end", "nsegs", "nmm"):
                upd = jnp.where(better, c2[key], jnp.take(c1[key], sidx))
                c1[key] = c1[key].at[sidx].set(upd)
            for key in ("seg_q", "seg_diag"):
                upd = jnp.where(better[:, None], c2[key],
                                jnp.take(c1[key], sidx, axis=0))
                c1[key] = c1[key].at[sidx].set(upd)

        # acceptance: strictly better than the trimmed/full substitution
        # alternative, all segments on one chromosome
        li_b = jnp.take(lengths, idx)
        if "trim_score" in res:
            best_other = jnp.take(res["trim_score"], idx)
        else:
            best_other = 8 * li_b - 32 * jnp.take(nmm, idx)
        accept = sel & (c1["nsegs"] >= 1) & (
            (c1["score"] > best_other)
            | ((c1["score"] == best_other) & (c1["nsegs"] >= 2)))
        # chromosome containment (uint32 chrom offsets, few chroms)
        co = index.chrom_offsets
        seg_start = c1["seg_diag"] + c1["seg_q"].astype(jnp.uint32)
        in_seg = (jnp.arange(c1["seg_q"].shape[1])[None, :]
                  < c1["nsegs"][:, None])
        chr_of = jnp.searchsorted(co, seg_start, side="right")
        last_end = (jnp.take_along_axis(
            c1["seg_diag"],
            jnp.maximum(c1["nsegs"] - 1, 0)[:, None], axis=1)[:, 0]
            + c1["q_end"].astype(jnp.uint32) - 1)
        chr_last = jnp.searchsorted(co, last_end, side="right")
        chr0 = chr_of[:, 0]
        same = jnp.all(jnp.where(in_seg, chr_of == chr0[:, None], True),
                       axis=1) & (chr_last == chr0)
        accept = accept & same

        out["ch_idx"] = idx
        out["ch_sel"] = accept
        out["ch_score"] = c1["score"].astype(jnp.int16)
        out["ch_qstart"] = c1["q_start"].astype(jnp.uint16)
        out["ch_qend"] = c1["q_end"].astype(jnp.uint16)
        out["ch_nsegs"] = c1["nsegs"].astype(jnp.uint8)
        out["ch_segq"] = c1["seg_q"].astype(jnp.uint16)
        out["ch_segd"] = c1["seg_diag"]
        out["ch_nmm"] = c1["nmm"].astype(jnp.uint16)
        splice_accept_b = jnp.zeros((B,), jnp.bool_).at[idx].set(
            accept & sel)

    # indel stage AFTER splices: only rows splices did not solve.
    # Clipped ends trigger too — an end indel's few tail mismatches can
    # stay under the nmm trigger while the trim stage clips them away
    # (QUERYEND_INDELS role, src/dynprog_end.h:26,48).
    ri = min(r_indel, B)
    need_i = valid & ((nmm >= INDEL_NMM_TRIGGER)
                      | (clip >= CLIP_INDEL_TRIGGER)) & ~splice_accept_b
    iprio = jnp.where(need_i, jnp.int32(2 * B) - jnp.arange(B,
                      dtype=jnp.int32), 0)
    _, iidx = jax.lax.top_k(iprio, ri)
    isel = jnp.take(need_i, iidx)
    ist = jnp.take(strand, iidx)
    icodes, _inm, ili = _oriented_rows_dev(
        pbatch["packed"], pbatch["pnmask"], lengths, iidx, ist, L)
    idg = jnp.where(jnp.take(valid, iidx), jnp.take(diag, iidx), 0)
    from tpumap.gsnap.engine import indel_forward, indel_traceback
    fwd = indel_forward(index, icodes, ili, idg, INDEL_BAND, INDEL_MARGIN)
    # second compaction BEFORE the traceback: the sequential traceback
    # walk (L+band steps of per-row gathers) costs ~2/3 of the indel
    # stage, but only rows whose DP score beats what substitutions alone
    # could score can ever be accepted by the host (its threshold is
    # max(3L-6nmm, 3/8*trim_score) >= 3L-6nmm, so this gate is a strict
    # superset of acceptance); trace only the best r_tb of those
    r_tb = min(max(r_indel // 8, 32), ri)
    sub_score = 3 * ili - 6 * jnp.take(nmm, iidx).astype(jnp.int32)
    improves = isel & (fwd["score"] > sub_score)
    gain = jnp.clip(fwd["score"] - sub_score, 0, 2 ** 20)
    tprio = jnp.where(improves,
                      gain * jnp.int32(2 * ri)
                      + (jnp.int32(ri) - jnp.arange(ri, dtype=jnp.int32)),
                      0)
    _, tbx = jax.lax.top_k(tprio, r_tb)
    out["indel_tb_overflow"] = jnp.maximum(
        jnp.sum(improves.astype(jnp.int32)) - r_tb, 0)
    isel = jnp.take(improves, tbx)
    iidx = jnp.take(iidx, tbx)
    fwd = {"score": jnp.take(fwd["score"], tbx),
           "end_k": jnp.take(fwd["end_k"], tbx),
           "dirs": jnp.take(fwd["dirs"], tbx, axis=0),
           "gstart_off": jnp.take(fwd["gstart_off"], tbx)}
    ili = jnp.take(ili, tbx)
    ref = indel_traceback(fwd, ili, INDEL_BAND)
    # run-length-encode the edit transcript on device: the raw ops tensor
    # [R, L+band] was the largest single item in the result fetch
    from tpumap.ops.dp import T_END
    MAXRUNS = 12
    rev = ref["ops"][:, ::-1]
    ops_valid = rev != jnp.uint8(T_END)
    prev = jnp.concatenate(
        [jnp.full((rev.shape[0], 1), 255, rev.dtype), rev[:, :-1]], axis=1)
    prev_valid = jnp.concatenate(
        [jnp.zeros((rev.shape[0], 1), jnp.bool_), ops_valid[:, :-1]],
        axis=1)
    newrun = ops_valid & ((rev != prev) | ~prev_valid)
    runidx = jnp.cumsum(newrun.astype(jnp.int32), axis=1) - 1
    nruns = jnp.max(jnp.where(ops_valid, runidx, -1), axis=1) + 1
    slot = jnp.arange(MAXRUNS, dtype=jnp.int32)[None, None, :]
    onehot = (runidx[:, :, None] == slot) & ops_valid[:, :, None]
    run_len = jnp.sum(onehot, axis=1).astype(jnp.uint16)
    run_op = (jnp.max(jnp.where(onehot, rev[:, :, None] + 1, 0), axis=1)
              .astype(jnp.uint8))
    out["in_idx"] = iidx
    out["in_sel"] = isel & (nruns <= MAXRUNS)
    out["in_score"] = ref["score"].astype(jnp.int16)
    out["in_runop"] = run_op
    out["in_runlen"] = run_len
    out["in_startoff"] = ref["start_off"].astype(jnp.int16)

    # ---- in-program ambiguous splice-end review scan ----------------
    # (src/spliceends.c trimmed-end candidate generation +
    # src/altsplice.c coords).  The host used to dispatch this as a
    # SECOND device program per batch (driver gap #1 / VERDICT r4 #3);
    # here the task construction (boundary shifts x proximal-dinucleotide
    # sense gating x fragment assembly) and the exact-site window scan
    # run inside the one-jit ladder, and the host only pools the
    # returned hits (spliceends.pool_device_results).
    if splicing and "trim_qstart" in res:
        from tpumap.gsnap.spliceends import (AMB_MAX, BOUNDARY_SHIFTS,
                                             SCAN_W, TOP_ALTS)
        from tpumap.gsnap.spliceends import MIN_INTRON as AMB_MIN_INTRON
        F = AMB_MAX + 2
        NS5 = len(BOUNDARY_SHIFTS)
        W_amb = min(SCAN_W, max(1024, scoring.max_intron))
        r_amb = min(max(512, B // 32), B)
        r_task = min(max(1536, B // 16), r_amb * 2 * NS5)
        indel_b = jnp.zeros((B,), jnp.bool_).at[iidx].set(isel)

        u_v = tqs.astype(jnp.int32)
        v_v = (lengths - tqe).astype(jnp.int32)
        alen_t = (tqe - tqs).astype(jnp.int32)
        maxmm = jnp.maximum(1, (alen_t.astype(jnp.float32)
                                * config.max_mismatch_frac)
                            .astype(jnp.int32))
        trim_amb = (valid & (trim_nmm <= maxmm)
                    & ~splice_accept_b & ~indel_b)
        e_trim = trim_amb & (v_v >= 1) & (v_v <= AMB_MAX)
        s_trim = trim_amb & (u_v >= 1) & (u_v <= AMB_MAX)

        # review sides: chain-accepted rows whose terminal exon is short
        # (scattered from the chain compaction; a = proximal segment's
        # diagonal, qb0 = the junction's query boundary)
        a_e_b = diag
        qb_e_b = tqe.astype(jnp.int32)
        a_s_b = diag
        qb_s_b = tqs.astype(jnp.int32)
        rev_e = jnp.zeros((B,), jnp.bool_)
        rev_s = jnp.zeros((B,), jnp.bool_)
        if splice_accept_b is not None and "ch_idx" in out:
            ns_c = c1["nsegs"]
            last_ix = jnp.maximum(ns_c - 1, 0)[:, None]
            last_q = jnp.take_along_axis(c1["seg_q"], last_ix,
                                         axis=1)[:, 0]
            last_d = jnp.take_along_axis(c1["seg_diag"], last_ix,
                                         axis=1)[:, 0]
            prev_ix = jnp.maximum(ns_c - 2, 0)[:, None]
            prev_d = jnp.take_along_axis(c1["seg_diag"], prev_ix,
                                         axis=1)[:, 0]
            seg1_q = c1["seg_q"][:, 1]
            seg1_d = c1["seg_diag"][:, 1]
            first_d = c1["seg_diag"][:, 0]
            multi = accept & sel & (ns_c >= 2)
            # signed gaps via bitcast (uint32 wrap-subtract is exact for
            # |gap| < 2^31; astype would clamp large unsigned values)
            gap_e = jax.lax.bitcast_convert_type(last_d - prev_d,
                                                 jnp.int32)
            gap_s = jax.lax.bitcast_convert_type(seg1_d - first_d,
                                                 jnp.int32)
            short_e = (c1["q_end"] - last_q >= 1) & (
                c1["q_end"] - last_q <= AMB_MAX)
            short_s = (seg1_q - c1["q_start"] >= 1) & (
                seg1_q - c1["q_start"] <= AMB_MAX)
            rv_e = multi & (gap_e >= scoring.min_intron) & short_e
            rv_s = multi & (gap_s >= scoring.min_intron) & short_s
            rev_e = rev_e.at[idx].set(rv_e)
            rev_s = rev_s.at[idx].set(rv_s)
            a_e_b = a_e_b.at[idx].set(jnp.where(rv_e, prev_d,
                                                jnp.take(a_e_b, idx)))
            qb_e_b = qb_e_b.at[idx].set(
                jnp.where(rv_e, last_q, jnp.take(qb_e_b, idx)))
            a_s_b = a_s_b.at[idx].set(jnp.where(rv_s, seg1_d,
                                                jnp.take(a_s_b, idx)))
            qb_s_b = qb_s_b.at[idx].set(
                jnp.where(rv_s, seg1_q, jnp.take(qb_s_b, idx)))
        e_ok_b = rev_e | e_trim
        s_ok_b = rev_s | s_trim

        row_need = e_ok_b | s_ok_b
        rprio = jnp.where(row_need,
                          jnp.int32(2 * B) - jnp.arange(B,
                                                        dtype=jnp.int32),
                          0)
        _, ridx = jax.lax.top_k(rprio, r_amb)
        rneed = jnp.take(row_need, ridx)
        out["amb_row_overflow"] = jnp.maximum(
            jnp.sum(row_need.astype(jnp.int32))
            - jnp.sum(rneed.astype(jnp.int32)), 0)
        rst = jnp.take(strand, ridx)
        codes_a, _nm_a, li_a = _oriented_rows_dev(
            pbatch["packed"], pbatch["pnmask"], lengths, ridx, rst, L)

        shifts_v = jnp.asarray(BOUNDARY_SHIFTS, jnp.int32)[None, :]
        glen = jnp.uint32(
            getattr(index, "genome_length", 1 << 31))
        ar_f = jnp.arange(F, dtype=jnp.int32)

        def side_tasks(is_end):
            if is_end:
                ok0 = jnp.take(e_ok_b, ridx) & rneed
                a_r = jnp.take(a_e_b, ridx)
                qb0 = jnp.take(qb_e_b, ridx)
            else:
                ok0 = jnp.take(s_ok_b, ridx) & rneed
                a_r = jnp.take(a_s_b, ridx)
                qb0 = jnp.take(qb_s_b, ridx)
            qb = qb0[:, None] + shifts_v                      # [r, 5]
            g = a_r[:, None] + qb.astype(jnp.uint32)
            if is_end:
                v = li_a[:, None] - qb
                ok = ok0[:, None] & (v >= 1) & (v <= AMB_MAX) & (qb >= 1)
                ok = ok & (g + jnp.uint32(2) <= glen)
                din = verify.extract_codes_window(
                    index.genome_packed, g, 2)                # [r, 5, 2]
                d0, d1 = din[..., 0], din[..., 1]
                sense = jnp.where((d0 == 2) & ((d1 == 3) | (d1 == 1)),
                                  jnp.int32(1),
                                  jnp.where((d0 == 1) & (d1 == 3),
                                            jnp.int32(-1), jnp.int32(0)))
                ok = ok & (sense != 0)
                # frag = [ACC dinuc, residue c[qb:li]]
                resid = jnp.take_along_axis(
                    codes_a[:, None, :].repeat(NS5, axis=1).reshape(
                        r_amb * NS5, L),
                    jnp.clip(qb.reshape(-1)[:, None] + (ar_f - 2)[None, :],
                             0, L - 1), axis=1).reshape(r_amb, NS5, F)
                acc1 = jnp.where(sense > 0, jnp.uint8(2), jnp.uint8(1))
                frag = jnp.where(
                    ar_f[None, None, :] == 0, jnp.uint8(0),
                    jnp.where(ar_f[None, None, :] == 1, acc1[..., None],
                              resid.astype(jnp.uint8)))
                inres = (ar_f[None, None, :] - 2) < v[..., None]
                frag = jnp.where((ar_f[None, None, :] < 2) | inres,
                                 frag, 0)
                flen = jnp.clip(v, 0, AMB_MAX) + 2
                ws = g + jnp.uint32(AMB_MIN_INTRON - 2)
            else:
                u = qb
                ok = (ok0[:, None] & (u >= 1) & (u <= AMB_MAX)
                      & (qb <= li_a[:, None] - 1))
                ok = ok & (g >= jnp.uint32(2))
                din = verify.extract_codes_window(
                    index.genome_packed,
                    jnp.where(g >= 2, g - jnp.uint32(2), 0), 2)
                d0, d1 = din[..., 0], din[..., 1]
                sense = jnp.where((d0 == 0) & (d1 == 2), jnp.int32(1),
                                  jnp.where((d0 == 0) & (d1 == 1),
                                            jnp.int32(-1), jnp.int32(0)))
                ok = ok & (sense != 0)
                # frag = [c[0:u], DON dinuc]
                head = codes_a[:, None, :F]
                don0 = jnp.where(sense > 0, jnp.uint8(2), jnp.uint8(1))
                frag = jnp.where(
                    ar_f[None, None, :] < u[..., None],
                    jnp.broadcast_to(head, (r_amb, NS5, F)),
                    jnp.where(ar_f[None, None, :] == u[..., None],
                              don0[..., None],
                              jnp.where(ar_f[None, None, :]
                                        == u[..., None] + 1,
                                        jnp.uint8(3), jnp.uint8(0))))
                flen = jnp.clip(u, 0, AMB_MAX) + 2
                # ws = max(g - W - u, 0) without signed underflow
                back = jnp.uint32(W_amb) + u.astype(jnp.uint32)
                ws = jnp.where(g > back, g - back, jnp.uint32(0))
            return ok, frag.astype(jnp.uint8), flen, ws, g, qb, sense

        ok_e, frag_e, flen_e, ws_e, g_e, qb_e, sn_e = side_tasks(True)
        ok_s, frag_s, flen_s, ws_s, g_s, qb_s, sn_s = side_tasks(False)

        def flat(e, s):
            return jnp.concatenate([e.reshape(r_amb * NS5, *e.shape[2:]),
                                    s.reshape(r_amb * NS5, *s.shape[2:])])

        ok_t = flat(ok_e, ok_s)
        frag_t = flat(frag_e, frag_s)
        flen_t = flat(flen_e, flen_s)
        ws_t = flat(ws_e, ws_s)
        g_t = flat(g_e, g_s)
        qb_t = flat(qb_e, qb_s)
        sn_t = flat(sn_e, sn_s)
        side_t = jnp.concatenate(
            [jnp.ones(r_amb * NS5, jnp.uint8),
             jnp.zeros(r_amb * NS5, jnp.uint8)])
        rows_t = jnp.concatenate([jnp.take(ridx, jnp.arange(r_amb)
                                           .repeat(NS5))] * 2)
        NT = 2 * r_amb * NS5
        tprio = jnp.where(ok_t,
                          jnp.int32(2 * NT) - jnp.arange(NT,
                                                         dtype=jnp.int32),
                          0)
        _, tix = jax.lax.top_k(tprio, r_task)
        t_ok = jnp.take(ok_t, tix)
        out["amb_task_overflow"] = jnp.maximum(
            jnp.sum(ok_t.astype(jnp.int32))
            - jnp.sum(t_ok.astype(jnp.int32)), 0)
        pos_a, count_a = localscan.scan_exact_sites(
            index.genome_packed, jnp.take(ws_t, tix),
            jnp.take(frag_t, tix, axis=0),
            jnp.where(t_ok, jnp.take(flen_t, tix), 0),
            W_amb, F, TOP_ALTS)
        out["amb_valid"] = t_ok
        out["amb_idx"] = jnp.take(rows_t, tix).astype(jnp.int32)
        out["amb_side"] = jnp.take(side_t, tix)
        out["amb_qb"] = jnp.take(qb_t, tix).astype(jnp.int16)
        out["amb_sense"] = jnp.take(sn_t, tix).astype(jnp.int8)
        out["amb_g"] = jnp.take(g_t, tix)
        out["amb_pos"] = pos_a
        out["amb_count"] = count_a.astype(jnp.uint16)
    # cand lists are only consumed on device now; don't ship the full
    # [B, K] tables back (the paired wrapper keeps them for its
    # in-program concordance).  Multimapping rows (n_best > 1) keep
    # their ranked lists through a small compaction so -n/--npaths > 1
    # (reference default 100, src/gsnap.c:523) stays on the fused path —
    # secondaries exist only for those rows.
    if not keep_cands:
        r_sec = min(max(256, B // 64), B)
        sec_need = valid & (res["n_best"] > 1)
        sprio2 = jnp.where(sec_need,
                           jnp.int32(2 * B) - jnp.arange(B,
                                                         dtype=jnp.int32),
                           0)
        _, sidx2 = jax.lax.top_k(sprio2, r_sec)
        out["sec_idx"] = sidx2.astype(jnp.int32)
        out["sec_sel"] = jnp.take(sec_need, sidx2)
        out["sec_overflow"] = jnp.maximum(
            jnp.sum(sec_need.astype(jnp.int32)) - r_sec, 0)
        out["sec_diags"] = jnp.take(res["cand_diags"], sidx2, axis=0)
        out["sec_strands"] = jnp.take(res["cand_strands"], sidx2,
                                      axis=0).astype(jnp.uint8)
        out["sec_nmm"] = jnp.take(res["cand_nmm"], sidx2,
                                  axis=0).astype(jnp.uint16)
        for key in ("cand_diags", "cand_strands", "cand_nmm"):
            out.pop(key, None)
    return out


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13))
def align_pair_full(index, pbatch, config: AlignConfig, L: int,
                    scoring: pathdp.PathScoring,
                    splicing: bool, salvage: bool,
                    r_chain: int, r_salv: int, r_indel: int,
                    pairmax: int, orientation: str,
                    pairexpect: int, pairdev: int, known=None):
    """Fused paired-end program: the full single-end ladder over the
    interleaved flat batch (read 1 of pair p at row 2p, read 2 at
    2p+1), PLUS the device concordance kernel over the cascade's
    ranked candidate lists — one dispatch, one fetch per batch (the
    Stage1_paired_read + concordance role, src/stage1hr-paired.c:5359,
    src/concordance.c).

    Extra result keys: pe_ci/pe_cj int32[B/2] (chosen candidate index
    per end), pe_valid bool[B/2], pe_insert int32[B/2], and
    pe_cd1/pe_cs1/pe_cn1/pe_cd2/pe_cs2/pe_cn2 (the per-end candidate
    columns the host needs to apply the choice without the full lists).
    """
    from tpumap.gsnap.paired import concordance_device

    res = align_batch_cascaded_packed(index, pbatch, config, L)
    out = refine_full(index, pbatch, res, config, L, scoring, splicing,
                      salvage, r_chain, r_salv, r_indel,
                      keep_cands=True, known=known)
    lengths = pbatch["lengths"]
    cd, cs, cn = (out.pop("cand_diags"), out.pop("cand_strands"),
                  out.pop("cand_nmm"))
    d1, d2 = cd[0::2], cd[1::2]
    s1, s2 = cs[0::2], cs[1::2]
    n1, n2 = cn[0::2], cn[1::2]
    L1, L2 = lengths[0::2], lengths[1::2]
    ci, cj, valid, insert = concordance_device(
        d1, s1, n1, L1, d2, s2, n2, L2, pairmax, orientation,
        pairexpect, pairdev)
    out["pe_ci"] = ci
    out["pe_cj"] = cj
    out["pe_valid"] = valid
    out["pe_insert"] = insert
    take = lambda a, i: jnp.take_along_axis(a, i[:, None], axis=1)[:, 0]
    out["pe_cd1"] = take(d1, ci)
    out["pe_cs1"] = take(s1, ci)
    out["pe_cn1"] = take(n1, ci)
    out["pe_cd2"] = take(d2, cj)
    out["pe_cs2"] = take(s2, cj)
    out["pe_cn2"] = take(n2, cj)
    from tpumap.utils.fetch import narrow_result
    return narrow_result(out)
