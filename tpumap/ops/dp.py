"""Banded affine-gap pairwise DP (device kernel).

Capability analog of the reference's SIMD dynamic programming core
(src/dynprog_simd.c Dynprog_simd_8/16 with upper/lower band split,
src/dynprog_single.c Dynprog_single_gap, src/dynprog_end.c): batched,
banded Needleman-Wunsch/semi-global alignment with affine gaps.

Band layout: cell (i, j) with |j - i| <= band is stored at lane
k = j - i + band of row i, giving a [Lq+1, 2*band+1] matrix per problem.
Row recurrence (lane-parallel):
    F[k] = max(H_prev[k+1] - open, F_prev[k+1] - extend)     (gap in query)
    M[k] = H_prev[k] + sub(i-1, j-1)                          (diag)
    E[k] = max_{k'<k} (max(M,F)[k'] - open - (k-1-k')*extend) (gap in genome)
    H[k] = max(M, F, E)
The E scan uses the fact that an optimal row-gap always opens from a
non-E cell, so a single cummax over (max(M,F)[k'] + extend*k') is exact —
this replaces the reference's lazy-F loop with one associative scan, which
XLA maps onto vector units.

Traceback: per-cell 2-bit direction + gap-continuation bits are stored
during the forward pass ([Lq, W] uint8 per problem) and walked back with a
fori_loop (vmapped over the batch) to produce fixed-length edit
transcripts.

Scoring follows the reference's tier-1 constants (src/dynprog.h:43-77):
match +3 (FULLMATCH), mismatch -3, gap open -8 including the first
residue, extend -3 per additional residue.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG = np.int32(-(2 ** 20))

# traceback codes
DIAG, UP, LEFT, STOP = 0, 1, 2, 3   # UP: gap in genome row move? see below


@dataclass(frozen=True)
class Scoring:
    match: int = 3
    mismatch: int = -3
    gap_open: int = 8      # cost of a 1-residue gap
    gap_extend: int = 3    # per additional residue


@partial(jax.jit, static_argnums=(4, 5, 6))
def banded_align(qcodes, qlens, gcodes, glens, band: int,
                 scoring: Scoring = Scoring(), mode: str = "glocal"):
    """Batched banded affine-gap alignment.

    qcodes uint8[B, Lq], gcodes uint8[B, Lg] with Lg >= Lq (the genome
    window); qlens/glens int32[B]. Lane k of row i addresses genome column
    j = i + k - band.

    mode:
      "global": both sequences fully aligned (ends anchored at
                (qlen, qlen + goffset) where goffset = glen - qlen must be
                within the band).
      "glocal": query fully aligned, genome end free (row 0 free shift) —
                used for indel discovery around a candidate diagonal.

    Returns dict: score int32[B], end_k int32[B] (band lane of the
    endpoint in the last query row), dirs uint8[B, Lq, W] traceback info.
    """
    B, Lq = qcodes.shape
    W = 2 * band + 1
    lanes = jnp.arange(W, dtype=jnp.int32)

    def sub_scores(i, carry_j_valid=None):
        """substitution scores for row i (query index i-1): [B, W]"""
        j = i - 1 + lanes[None, :] - band          # genome index per lane
        jc = jnp.clip(j, 0, gcodes.shape[1] - 1)
        g = jnp.take_along_axis(gcodes, jc, axis=1)
        q = qcodes[:, i - 1][:, None]
        eq = (g == q) & (j >= 0) & (j < glens[:, None])
        return jnp.where(eq, scoring.match, scoring.mismatch).astype(jnp.int32), j

    o = jnp.int32(scoring.gap_open)
    e = jnp.int32(scoring.gap_extend)

    # row 0 init
    if mode == "global":
        # H[0][k] = gap cost of leading genome gap of length (k - band)
        lead = lanes[None, :] - band
        H0 = jnp.where(lead == 0, 0,
                       jnp.where(lead > 0, -(o + (lead - 1) * e), NEG))
        H0 = jnp.broadcast_to(H0, (B, W)).astype(jnp.int32)
    else:
        H0 = jnp.zeros((B, W), jnp.int32)
    F0 = jnp.full((B, W), NEG, jnp.int32)

    ks = lanes[None, :].astype(jnp.int32)

    def row(carry, i):
        H_prev, F_prev = carry
        s, j = sub_scores(i)
        in_band_j = (j >= 0) & (j < glens[:, None])

        H_up = jnp.concatenate([H_prev[:, 1:], jnp.full((B, 1), NEG)], axis=1)
        F_up = jnp.concatenate([F_prev[:, 1:], jnp.full((B, 1), NEG)], axis=1)
        F = jnp.maximum(H_up - o, F_up - e)
        M = H_prev + s
        MF = jnp.maximum(M, F)
        # E via cummax scan: t[k'] = MF[k'] + e*k'
        t = MF + e * ks
        c = jax.lax.cummax(t, axis=1)
        c_shift = jnp.concatenate([jnp.full((B, 1), NEG), c[:, :-1]], axis=1)
        E = c_shift - o - e * (ks - 1)
        H = jnp.maximum(MF, E)
        H = jnp.where(in_band_j, H, NEG)
        F = jnp.where(in_band_j, F, NEG)

        dir_bits = jnp.where(H == M, jnp.uint8(DIAG),
                             jnp.where(H == E, jnp.uint8(LEFT), jnp.uint8(UP)))
        # gap bookkeeping for the affine traceback:
        #  bit 2: F gap continues upward (did NOT open at this cell)
        #  bit 3: E gap's source is the immediate left neighbor (gap ends)
        #  bit 4: at a gap-source cell, max(M, F) was M (vs F)
        fcont = ((F == F_up - e) & (F != H_up - o)).astype(jnp.uint8) << 2
        esrc = (c_shift == jnp.concatenate(
            [jnp.full((B, 1), NEG), t[:, :-1]], axis=1)).astype(jnp.uint8) << 3
        mf_is_m = (MF == M).astype(jnp.uint8) << 4
        dirs_row = dir_bits | fcont | esrc | mf_is_m
        # rows beyond this problem's qlen: carry H through unchanged
        active = (i <= qlens)[:, None]
        H = jnp.where(active, H, H_prev)
        F = jnp.where(active, F, F_prev)
        return (H, F), dirs_row

    (H_last, _), dirs = jax.lax.scan(row, (H0, F0),
                                     jnp.arange(1, Lq + 1, dtype=jnp.int32))
    dirs = jnp.transpose(dirs, (1, 0, 2))     # [B, Lq, W]

    if mode == "global":
        end_k = (glens - qlens + band).astype(jnp.int32)
        score = jnp.take_along_axis(H_last, end_k[:, None], axis=1)[:, 0]
    else:
        score = jnp.max(H_last, axis=1)
        end_k = jnp.argmax(H_last, axis=1).astype(jnp.int32)
    return {"score": score, "end_k": end_k, "dirs": dirs, "H_last": H_last}


# edit transcript codes
T_MATCH, T_INS, T_DEL, T_END = 0, 1, 2, 3   # INS: extra query base; DEL: extra genome base


@partial(jax.jit, static_argnums=(3,))
def traceback(dirs, qlens, end_k, band: int):
    """Walk the direction matrix back to (0, ·).

    Returns ops uint8[B, S] (S = Lq + 2*band), emitted end-first:
    T_MATCH consumes one query + one genome base, T_INS one query base
    (insertion in query relative to genome), T_DEL one genome base.
    The transcript is reversed/decoded on host (ops are in reverse order).
    """
    B, Lq, W = dirs.shape
    S = Lq + 2 * band
    # walker states: which matrix the current cell's value belongs to.
    # ST_MF = the cell is a row-gap source, restricted to max(M, F).
    ST_H, ST_E, ST_F, ST_MF = 0, 1, 2, 3

    def one(dirs_b, qlen, k0):
        def body(state, step):
            i, k, st, done = state
            kc = jnp.clip(k, 0, W - 1)
            cell = dirs_b[jnp.clip(i - 1, 0, Lq - 1), kc]
            d = (cell & jnp.uint8(3)).astype(jnp.int32)
            fcont = ((cell >> 2) & jnp.uint8(1)).astype(jnp.int32)
            esrc = ((cell >> 3) & jnp.uint8(1)).astype(jnp.int32)
            mf_is_m = ((cell >> 4) & jnp.uint8(1)).astype(jnp.int32)

            at_end = done | (i <= 0)
            # resolve the effective move of this cell under its state
            in_e = (st == ST_E) | ((st == ST_H) & (d == LEFT))
            is_m = ((st == ST_H) & (d == DIAG)) | ((st == ST_MF) & (mf_is_m == 1))
            in_f = ((st == ST_F) | ((st == ST_H) & (d == UP))
                    | ((st == ST_MF) & (mf_is_m == 0)))

            emit = jnp.where(at_end, jnp.uint8(T_END),
                             jnp.where(in_e, jnp.uint8(T_DEL),
                                       jnp.where(is_m, jnp.uint8(T_MATCH),
                                                 jnp.uint8(T_INS))))
            # next state
            nst = jnp.where(in_e, jnp.where(esrc == 1, ST_MF, ST_E),
                            jnp.where(is_m, ST_H,
                                      jnp.where(fcont == 1, ST_F, ST_H)))
            ni = jnp.where(in_e, i, i - 1)
            nk = jnp.where(in_e, k - 1, jnp.where(is_m, k, k + 1))
            ndone = at_end | ((emit != T_DEL) & (ni <= 0))
            return (jnp.where(at_end, i, ni), jnp.where(at_end, k, nk),
                    jnp.where(at_end, st, nst.astype(jnp.int32)), ndone), emit

        (_, k_final, _, _), ops = jax.lax.scan(
            body, (qlen.astype(jnp.int32), k0.astype(jnp.int32),
                   jnp.int32(ST_H), False),
            None, length=S)
        return ops, k_final

    ops, k_final = jax.vmap(one)(dirs, qlens, end_k)
    return ops, k_final
