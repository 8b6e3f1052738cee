#!/usr/bin/env python3
"""Smoke test of the aligner on one NVIDIA GPU, at bench size.

    python chip_smoke.py                        # every phase
    python chip_smoke.py --stop-after compile   # device, setup, compile

Phases, each printing its own lines on stdout:

  device   JAX must report a GPU, or the script exits 1 before any work.
           Prints the card's name and power limit, the compile cache in
           effect, and requires the native host library.
  setup    generates the bench workload (tools/bench_data.py: 46.7 Mbp
           genome, 50k DNA reads, the 40%-spliced RNA set, 20k FR pairs,
           256 cDNAs) and builds the k=14 interval-3 index through
           tpumap-build; generation, build and upload seconds apart.
  compile  lowers and compiles the fused single-end ladder (DNA, RNA),
           the paired program and the GMAP chain stage at the shapes the
           CLI runs, and prints compiled.memory_analysis() for each.
  e2e      GSNAP DNA, RNA (-N 1), paired-end and GMAP (-f 2) through the
           CLIs' main() in this process, graded against the generator's
           truth.  Wall times are single smoke readings, not a benchmark.
  compare  the same CLI runs on one full batch of each (all cDNAs) and
           the device ops at bench widths, on the CPU backend in one
           child process (JAX_PLATFORMS=cpu, so only this process opens
           the card); SAM and GFF3 bodies must be byte-identical, integer
           op outputs exact and float ones within FLOAT_RTOL.

The last line is {"ok": true, "device": {...}} only when every phase
passed; any failure exits non-zero without it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))


@dataclasses.dataclass(frozen=True)
class Sizes:
    genome_len: int = 46_700_000
    n_genes: int = 400
    n_reads: int = 50_000
    n_pairs: int = 20_000
    n_cdna: int = 256
    k: int = 14
    dna_batch: int = 32768
    rna_batch: int = 16384
    pe_batch: int = 8192          # pairs; the program runs 2x rows
    dp_rows: int = 8192           # banded DP at 8192 x 112, band 16
    chain_rows: int = 8192        # r_chain of an RNA batch (B/2)
    scan_rows: int = 2048         # r_salv of an RNA batch (B/8)


# Accuracy floors for the GPU output over the compare subset (one full
# batch of each workload, all cDNAs): the levels the same CLI runs reach
# on the CPU backend at that size, as this script's CPU reference child
# graded them on the H100's host (RNA: precision 0.9995, recall 0.9643,
# locus 0.9911; every other grade 1.0), less 1e-4 for the rounding of
# the printed values.  They hold at the bench sizes (Sizes()) only.
GATES = {
    "dna": {"aligned_frac": 0.9999, "locus_acc": 0.9999},
    "rna": {"junction_precision": 0.9994, "junction_recall": 0.9642,
            "locus_acc": 0.9910},
    "pe": {"concordant_frac": 0.9999},
    "gmap": {"found_frac": 0.9999, "locus_acc": 0.9999},
}


class SmokeFailure(Exception):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------- helpers

def sam_body(lines):
    """Alignment lines of SAM text (header lines dropped)."""
    return [ln for ln in lines if ln and not ln.startswith("@")]


def compare_text(gpu_lines, cpu_lines, comment: str = "@PG"):
    """Differences between two outputs, ignoring lines that start with
    `comment` (the @PG / '# Generated by' line holds the command line).
    Returns [(line_no, gpu_line, cpu_line)] for every differing line."""
    a = [ln for ln in gpu_lines if not ln.startswith(comment)]
    b = [ln for ln in cpu_lines if not ln.startswith(comment)]
    diffs = [(i, x, y) for i, (x, y) in enumerate(zip(a, b)) if x != y]
    for i in range(min(len(a), len(b)), max(len(a), len(b))):
        diffs.append((i, a[i] if i < len(a) else None,
                      b[i] if i < len(b) else None))
    return diffs


def subset_lines(lines, names):
    """SAM header lines plus the body lines whose QNAME is in names."""
    return [ln for ln in lines
            if ln.startswith("@") or ln.split("\t", 1)[0] in names]


def grade_gmap(gff3_lines, plan) -> dict:
    """Found fraction and locus accuracy of GMAP GFF3 gene output for
    cDNAs c<i> against their exon plan (tools/bench_gmap.query_plan)."""
    from tools.bench_data import LOCUS_SLOP
    found = loc = 0
    for ln in gff3_lines:
        c = ln.split("\t")
        if ln.startswith("#") or len(c) < 9 or c[2] != "gene":
            continue
        name = re.search(r"Name=([^;]+)", c[8]).group(1)
        exons = plan[int(name[1:])]
        found += 1
        if abs(int(c[3]) - 1 - exons[0][0]) <= LOCUS_SLOP:
            loc += 1
    n = len(plan)
    return {"found_frac": found / n, "locus_acc": loc / n}


def check_gates(cell: str, grades: dict, gates: dict) -> None:
    for key, floor in gates.get(cell, {}).items():
        if grades[key] < floor:
            raise SmokeFailure(f"{cell}: {key} {grades[key]:.4f} is below "
                               f"the CPU level {floor}")


def configure(sz: Sizes, root: pathlib.Path) -> None:
    """Point the bench generator at root and the given sizes."""
    from tools import bench_data as bd
    bd.ROOT = root
    bd.GENOME_LEN = sz.genome_len
    bd.N_GENES = sz.n_genes
    bd.N_READS = sz.n_reads
    bd.PE_N_PAIRS = sz.n_pairs


def files(root: pathlib.Path) -> dict:
    return {"genome": root / "genome.fa", "dna": root / "reads.fa",
            "rna": root / "reads_rna.fa", "pe1": root / "reads_pe_1.fa",
            "pe2": root / "reads_pe_2.fa", "cdna": root / "cdna.fa",
            "db": root / "bench",
            "dna_cmp": root / "cmp_dna.fa", "rna_cmp": root / "cmp_rna.fa",
            "pe1_cmp": root / "cmp_pe_1.fa", "pe2_cmp": root / "cmp_pe_2.fa"}


def cli_argv(sz: Sizes, f: dict, cell: str, out: pathlib.Path,
             compare: bool = False) -> list[str]:
    """The CLI arguments of one cell; compare=True reads the subset."""
    db = str(f["db"])
    if cell == "dna":
        return ["-D", db, "--batch-size", str(sz.dna_batch), "--time",
                "-o", str(out), str(f["dna_cmp" if compare else "dna"])]
    if cell == "rna":
        return ["-D", db, "-N", "1", "--batch-size", str(sz.rna_batch),
                "--time", "-o", str(out),
                str(f["rna_cmp" if compare else "rna"])]
    if cell == "pe":
        sfx = "_cmp" if compare else ""
        return ["-D", db, "--batch-size", str(sz.pe_batch), "--time",
                "-o", str(out), str(f["pe1" + sfx]), str(f["pe2" + sfx])]
    # -n 1: one path per query, the batched GMAP path bench.py times
    return ["-D", db, "-f", "2", "-n", "1", "--time", str(f["cdna"])]


def run_cli(cell: str, argv: list[str], stdout_path=None):
    """Run one CLI main() in this process; returns (wall s, stderr)."""
    from tpumap.cli import gmap_cli, gsnap_cli
    main = gmap_cli.main if cell == "gmap" else gsnap_cli.main
    err = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stderr(err))
        if stdout_path is not None:
            fh = stack.enter_context(open(stdout_path, "w"))
            stack.enter_context(contextlib.redirect_stdout(fh))
        t0 = time.perf_counter()
        rc = main(argv)
        dt = time.perf_counter() - t0
    text = err.getvalue()
    sys.stderr.write(text)
    if rc not in (0, None):
        raise SmokeFailure(f"{cell}: CLI exited {rc}")
    if "retrying reads individually" in text:
        raise SmokeFailure(f"{cell}: a batch failed and was retried read "
                           f"by read")
    return dt, text


def aligned_seconds(stderr_text: str) -> float | None:
    """The CLI's own --time figure (alignment after index load)."""
    m = re.search(r"Aligned \d+ \w+ in ([0-9.]+) s", stderr_text)
    return float(m.group(1)) if m else None


# ------------------------------------------------------------------ phases

def phase_device() -> dict:
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(f"JAX reports {devs[0].platform} devices, not "
                           f"a GPU; this smoke has no CPU fallback")
    d = devs[0]
    say("device", f"platform={d.platform} kind={d.device_kind} "
                  f"count={len(devs)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    say("device", f"card: {card}")
    from tpumap.native import get_lib
    from tpumap.utils import jaxcache
    say("device", f"compile cache: {jaxcache.cache_dir()} "
                  f"(jax: {jax.config.jax_compilation_cache_dir})")
    if get_lib() is None:
        raise SmokeFailure("native host library unavailable")
    say("device", "native host library: built and loaded")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def phase_setup(sz: Sizes, root: pathlib.Path):
    import jax

    from tools import bench_data as bd
    from tools.bench_gmap import query_plan
    from tpumap.cli import build_cli
    from tpumap.index import GenomeDB
    from tpumap.index.device import DeviceIndex
    from tpumap.io.fasta import read_fasta

    configure(sz, root)
    f = files(root)
    t0 = time.perf_counter()
    bd.ensure_files()
    bd.ensure_rna_files()
    bd.ensure_pe_files()
    g = bd._codes_to_str(bd.genome_codes())
    with open(f["cdna"], "w") as fh:
        for i, exons in enumerate(query_plan(sz.genome_len, sz.n_cdna)):
            fh.write(f">c{i}\n"
                     + "".join(g[a:a + n] for a, n in exons) + "\n")
    del g
    for src, dst, n in (("dna", "dna_cmp", sz.dna_batch),
                        ("rna", "rna_cmp", sz.rna_batch),
                        ("pe1", "pe1_cmp", sz.pe_batch),
                        ("pe2", "pe2_cmp", sz.pe_batch)):
        with open(f[dst], "w") as fh:
            for rec, _ in zip(read_fasta(f[src]), range(n)):
                fh.write(f">{rec.accession}\n{rec.sequence}\n")
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    rc = build_cli.main(["-D", str(root), "-d", "bench", "-k", str(sz.k),
                         "-q", "3", str(f["genome"])])
    if rc not in (0, None):
        raise SmokeFailure(f"tpumap-build exited {rc}")
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    db = GenomeDB.load(str(f["db"]))
    index = DeviceIndex.from_host(db)
    jax.block_until_ready(index)
    t_upload = time.perf_counter() - t0
    sizes = {k: v.nbytes for k, v in
             (("offsets", index.offsets), ("positions", index.positions),
              ("genome", index.genome_packed),
              ("nmask", index.genome_nmask))}
    say("setup", f"generate {t_gen:.1f} s, build {t_build:.1f} s, "
                 f"load+upload {t_upload:.1f} s")
    say("setup", f"genome {db.genome_length} bp, k={db.k} "
                 f"interval={db.interval}; device index "
                 + ", ".join(f"{k} {v / 1e6:.1f} MB"
                             for k, v in sizes.items())
                 + f" = {sum(sizes.values()) / 1e9:.3f} GB")
    return f, index


class _CompiledOnly(BaseException):
    """Stops a CLI run once its program is compiled (BaseException, so the
    CLI's own error handling does not catch it)."""


def phase_compile(sz: Sizes, f: dict, out_dir: pathlib.Path) -> None:
    from tpumap.gmap import engine as gmap_engine
    from tpumap.gsnap import ladder

    cells = (("dna", ladder, "align_batch_full"),
             ("rna", ladder, "align_batch_full"),
             ("pe", ladder, "align_pair_full"),
             ("gmap", gmap_engine, "_chain_pipeline_windows"))
    for cell, mod, name in cells:
        orig = getattr(mod, name)
        seen = {}

        def spy(*a, _orig=orig, _seen=seen, **kw):
            t0 = time.perf_counter()
            lowered = _orig.lower(*a, **kw)
            _seen["compiled"] = lowered.compile()
            _seen["s"] = time.perf_counter() - t0
            _seen["shape"] = [tuple(x.shape) for x in
                              (a[1].values() if isinstance(a[1], dict)
                               else a[2:4])]
            raise _CompiledOnly

        setattr(mod, name, spy)
        try:
            run_cli(cell, cli_argv(sz, f, cell, out_dir / "compile.out"),
                    stdout_path=(out_dir / "compile.out"
                                 if cell == "gmap" else None))
        except _CompiledOnly:
            pass
        finally:
            setattr(mod, name, orig)
        if "compiled" not in seen:
            raise SmokeFailure(f"compile: {cell} never reached {name}")
        ma = seen["compiled"].memory_analysis()
        mem = ("memory_analysis unavailable" if ma is None else
               f"args {ma.argument_size_in_bytes / 1e6:.1f} MB, "
               f"out {ma.output_size_in_bytes / 1e6:.1f} MB, "
               f"temp {ma.temp_size_in_bytes / 1e6:.1f} MB, "
               f"code {ma.generated_code_size_in_bytes / 1e6:.1f} MB")
        say("compile", f"{cell} {name} inputs {seen['shape']}: "
                       f"{seen['s']:.1f} s; {mem}")


def phase_e2e(sz: Sizes, f: dict, out_dir: pathlib.Path) -> dict:
    import jax

    from tools import bench_data as bd
    from tools.bench_gmap import query_plan

    outs = {}
    for cell in ("dna", "rna", "pe", "gmap"):
        out = out_dir / f"gpu_{cell}.{'gff3' if cell == 'gmap' else 'sam'}"
        wall, err = run_cli(cell, cli_argv(sz, f, cell, out),
                            stdout_path=out if cell == "gmap" else None)
        lines = out.read_text().splitlines()
        n = {"dna": sz.n_reads, "rna": sz.n_reads, "pe": 2 * sz.n_pairs,
             "gmap": sz.n_cdna}[cell]
        if cell == "dna":
            g = bd.grade_dna(lines)
        elif cell == "rna":
            g = bd.grade_rna(lines)
        elif cell == "pe":
            g = bd.grade_pe(lines)
        else:
            g = grade_gmap(lines, query_plan(sz.genome_len, sz.n_cdna))
        al = aligned_seconds(err)
        unit = "queries" if cell == "gmap" else "reads"
        say("e2e", f"{cell}: {n} {unit}, CLI wall {wall:.2f} s"
                   + (f", aligned in {al:.2f} s = {n / al:.1f} {unit}/s"
                      if al else "")
                   + "; " + ", ".join(f"{k} {v:.4f}" for k, v in g.items()))
        outs[cell] = lines
    stats = jax.devices()[0].memory_stats() or {}
    say("e2e", f"device peak_bytes_in_use "
               f"{stats.get('peak_bytes_in_use', 0) / 1e9:.2f} GB of "
               f"bytes_limit {stats.get('bytes_limit', 0) / 1e9:.2f} GB")
    return outs


# ------------------------------------------------------------ op compare

def _read_codes(path, n: int, L: int):
    import numpy as np

    from tpumap.io.fasta import read_fasta
    from tpumap.utils import dna
    codes = np.zeros((n, L), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i, (rec, _) in enumerate(zip(read_fasta(path), range(n))):
        c, _m = dna.encode(rec.sequence)
        codes[i, :len(c)] = c
        lengths[i] = len(c)
    return codes, lengths


def op_cases(sz: Sizes, f: dict, index, timings: dict | None = None):
    """Outputs of the device ops at bench widths, as numpy arrays.

    Inputs come from the workload files and a fixed seed, so the GPU
    parent and the CPU child build identical inputs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tools import bench_data as bd
    from tools.bench_gmap import query_plan
    from tpumap.gmap import engine as gmap_engine
    from tpumap.gsnap.ladder import SALVAGE_F, SALVAGE_W
    from tpumap.ops import chain as chain_ops
    from tpumap.ops import dp, localscan, pack, pathdp, seed, verify

    rng = np.random.default_rng(11)
    G = bd.genome_codes().astype(np.uint8)
    INV = np.uint32(0xFFFFFFFF)
    L = 128
    cases = {}

    # seed + verify: the DNA batch as the CLI runs it (L = 128)
    codes, lengths = _read_codes(f["dna"], sz.dna_batch, L)
    nmask = np.zeros_like(codes, dtype=bool)
    seed_fn = jax.jit(seed.seed_reads, static_argnames=("max_occ", "top_k"))
    cases["seed"] = (lambda: seed_fn(index, codes, nmask, lengths,
                                     max_occ=32, top_k=8))
    starts = bd.read_plan()[0][:sz.dna_batch].astype(np.int64)
    diags = starts[:, None] + rng.integers(-50, 51, (sz.dna_batch, 8))
    diags[:, 0] = starts
    diags = np.clip(diags, 0, sz.genome_len - L).astype(np.uint32)
    diags[:, 7] = INV

    @jax.jit
    def verify_fn(index, codes, nmask, lengths, diags):
        return verify.verify_diagonals(
            index, pack.pack_reads(codes),
            pack.pack_reads(nmask.astype(jnp.uint8)), lengths, diags)

    cases["verify"] = lambda: verify_fn(index, codes, nmask, lengths, diags)

    # banded affine DP + traceback: reads with substitutions and one indel
    # against their genome windows, 8192 x 112, band 16
    R, LQ, BAND = sz.dp_rows, 112, 16
    p = rng.integers(BAND, sz.genome_len - LQ - 4 * BAND, R)
    gc = np.stack([G[x - BAND:x + LQ + BAND] for x in p])
    qc = np.stack([G[x:x + LQ + 1] for x in p])
    for i in range(R):
        qc[i, rng.integers(0, LQ, 3)] = rng.integers(0, 4, 3)
        if i % 2:
            j = int(rng.integers(10, LQ - 10))
            qc[i, j:-1] = qc[i, j + 1:]
    qc = qc[:, :LQ]
    ql = np.full(R, LQ, np.int32)
    gl = np.full(R, LQ + 2 * BAND, np.int32)

    def dp_case():
        r = dp.banded_align(qc, ql, gc, gl, BAND)
        ops, k_final = dp.traceback(r["dirs"], ql, r["end_k"], BAND)
        return {"score": r["score"], "end_k": r["end_k"], "dirs": r["dirs"],
                "tb_ops": ops, "tb_k": k_final}

    cases["dp"] = dp_case

    # path DP: RNA reads in the aligned orientation against their true
    # segment diagonals plus decoys
    R = sz.chain_rows
    plan = bd.rna_read_plan()[:R]
    rcodes = np.zeros((R, L), np.uint8)
    rlen = np.zeros(R, np.int32)
    rdiag = np.full((R, 8), INV, np.uint32)
    for i, pl in enumerate(plan):
        s = np.concatenate([G[a:a + n] for a, n in pl["segs"]])
        for j, b in pl["subs"]:
            s[j] = b
        rcodes[i, :len(s)] = s
        rlen[i] = len(s)
        q = 0
        for j, (a, n) in enumerate(pl["segs"]):
            rdiag[i, j] = a - q
            q += n
        rdiag[i, 4:7] = np.clip(pl["segs"][0][0]
                                + rng.integers(-3000, 3000, 3), 0,
                                sz.genome_len - L)
    rnmask = np.zeros_like(rcodes, dtype=bool)
    cases["pathdp"] = lambda: pathdp.chain_solve(index, rcodes, rnmask, rlen,
                                                 rdiag)

    # salvage scans: 16-base fragments inside 64 kb windows
    R = sz.scan_rows
    ws = rng.integers(0, sz.genome_len - SALVAGE_W - 64, R)
    off = ws + rng.integers(0, SALVAGE_W - SALVAGE_F, R)
    frag = np.stack([G[x:x + SALVAGE_F] for x in off])
    frag[np.arange(R), rng.integers(0, SALVAGE_F, R)] = rng.integers(0, 4, R)
    flen = rng.integers(6, SALVAGE_F + 1, R).astype(np.int32)
    ws = ws.astype(np.uint32)

    def scan_case():
        pos, nmm = localscan.scan_fragment(index.genome_packed, ws, frag,
                                           flen, SALVAGE_W, SALVAGE_F, 4)
        rpos, runs = localscan.scan_fragment_runs(index.genome_packed, ws,
                                                  frag, SALVAGE_W, 8, True)
        return {"pos": pos, "nmm": nmm, "run_pos": rpos, "runs": runs}

    cases["localscan"] = scan_case

    # GMAP anchor chaining (float32 gap cost in the chain scan) over every
    # cDNA's true window
    qplan = query_plan(sz.genome_len, sz.n_cdna)
    qs = [np.concatenate([G[a:a + n] for a, n in ex]) for ex in qplan]
    wst = [max(0, ex[0][0] - 2000) for ex in qplan]
    wln = [ex[-1][0] + ex[-1][1] + 2000 - w for ex, w in zip(qplan, wst)]
    Qp, Rp = gmap_engine._bucket(max(map(len, qs))), gmap_engine._bucket(
        max(wln))
    cfg = gmap_engine.GmapConfig()
    if Qp // 16 > cfg.n_segments:
        cfg = dataclasses.replace(cfg, n_segments=min(512, Qp // 16))
    N = len(qs)
    qc2 = np.zeros((N, Qp), np.uint8)
    qv2 = np.zeros((N, Qp), bool)
    for i, q in enumerate(qs):
        qc2[i, :len(q)] = q
        qv2[i, :len(q)] = True
    wst = np.asarray(wst, np.uint32)
    wln = np.asarray(wln, np.int32)
    sp = np.zeros(N, np.int32)
    cases["chain"] = lambda: gmap_engine._chain_pipeline_windows(
        index.genome_packed, index.genome_nmask, qc2, qv2, wst, wln, sp, Rp,
        cfg)
    # its float32 gap cost alone, over segment ends up to max_intron apart
    gs = rng.integers(0, cfg.max_intron, (N, cfg.n_segments)).astype(np.int32)
    ge = rng.integers(0, cfg.max_intron, (N, cfg.n_segments)).astype(np.int32)
    cases["chain_gapcost"] = lambda: jax.jit(jax.vmap(chain_ops.gap_cost))(
        gs, ge)

    out = {}
    for name, fn in cases.items():
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        if timings is not None:         # a second call, compiled
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn())
            timings[name] = (first, time.perf_counter() - t0)
        if isinstance(res, jax.Array):
            res = {"out": res}
        leaves = res.items() if isinstance(res, dict) else enumerate(res)
        for k, v in leaves:
            out[f"{name}.{k}"] = np.asarray(v)
    return out


# float outputs may differ in the last bits: the backends' log1p differ
# by a few ulp (float32 ulp ~1.2e-7 relative), far inside 1e-5
FLOAT_RTOL = 1e-5


def compare_ops(gpu: dict, cpu: dict) -> list[tuple[str, bool]]:
    """(line, ok) per op output: integer outputs must be exact, float
    outputs within FLOAT_RTOL relative."""
    import numpy as np
    lines = []
    for key in sorted(gpu):
        a, b = gpu[key], cpu.get(key)
        if b is None or a.shape != b.shape or a.dtype != b.dtype:
            lines.append((f"{key}: missing, or shape/dtype differs", False))
            continue
        head = f"{key} {a.dtype}{list(a.shape)}: "
        if np.issubdtype(a.dtype, np.floating) and not np.array_equal(a, b):
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
            lines.append((head + f"max relative difference {rel:.2e}",
                          rel <= FLOAT_RTOL))
            continue
        bad = np.nonzero((a != b).reshape(len(a), -1).any(axis=1))[0]
        lines.append((head + ("exact" if len(bad) == 0 else
                              f"{len(bad)} rows differ, first "
                              f"{bad[:8].tolist()}"), len(bad) == 0))
    return lines


# ------------------------------------------------------- CPU reference

def start_reference(sz: Sizes, root: pathlib.Path):
    """The CPU reference child: JAX_PLATFORMS=cpu, so it never opens the
    card.  Where the host has several cores, this process keeps the first
    half and the child takes the rest."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    argv = [sys.executable, str(pathlib.Path(__file__).resolve()),
            "--cpu-reference", str(root),
            "--sizes", json.dumps(dataclasses.asdict(sz))]
    cores = sorted(os.sched_getaffinity(0))
    half = len(cores) // 2 if len(cores) >= 4 else 0
    if half:
        os.sched_setaffinity(0, cores[:half])
        argv += ["--cores", ",".join(map(str, cores[half:]))]
    with open(root / "cpu_reference.log", "w") as log:
        return subprocess.Popen(argv, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def reference_child(sz: Sizes, root: pathlib.Path) -> None:
    import numpy as np

    from tpumap.index import GenomeDB
    from tpumap.index.device import DeviceIndex

    configure(sz, root)
    f = files(root)
    for cell in ("dna", "rna", "pe", "gmap"):
        out = root / f"cpu_{cell}.{'gff3' if cell == 'gmap' else 'sam'}"
        wall, _err = run_cli(cell, cli_argv(sz, f, cell, out, compare=True),
                             stdout_path=out if cell == "gmap" else None)
        print(f"cpu {cell}: {wall:.1f} s", flush=True)
    index = DeviceIndex.from_host(GenomeDB.load(str(f["db"])))
    t0 = time.perf_counter()
    np.savez(root / "cpu_ops.npz", **op_cases(sz, f, index))
    print(f"cpu ops: {time.perf_counter() - t0:.1f} s", flush=True)


def phase_compare(sz: Sizes, f: dict, root: pathlib.Path, index,
                  gpu_out: dict, child, timeout: float) -> None:
    gates = GATES if sz == Sizes() else {}
    import numpy as np

    from tools import bench_data as bd
    from tools.bench_gmap import query_plan

    timings = {}
    gpu_ops = op_cases(sz, f, index, timings)
    say("compare", "GPU op seconds (first call incl. compile / second): "
        + ", ".join(f"{k} {a:.3f}/{b:.4f}" for k, (a, b) in timings.items()))
    try:
        rc = child.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        raise SmokeFailure(f"CPU reference still running after {timeout} s")
    log = (root / "cpu_reference.log").read_text()
    for ln in log.splitlines():
        if ln.startswith("cpu "):
            say("compare", ln)
    if rc != 0:
        sys.stderr.write(log[-8000:])
        raise SmokeFailure(f"CPU reference exited {rc}")

    failures = []
    for cell in ("dna", "rna", "pe", "gmap"):
        ext = "gff3" if cell == "gmap" else "sam"
        cpu = (root / f"cpu_{cell}.{ext}").read_text().splitlines()
        gpu = gpu_out[cell]
        if cell == "gmap":
            diffs = compare_text(gpu, cpu, comment="#")
            plan = query_plan(sz.genome_len, sz.n_cdna)
            g_gpu, g_cpu = grade_gmap(gpu, plan), grade_gmap(cpu, plan)
        else:
            names = {ln.split("\t", 1)[0] for ln in sam_body(cpu)}
            gpu = subset_lines(gpu, names)
            diffs = compare_text(gpu, cpu)
            # mates keep their /1, /2 suffixes as QNAME
            n = {"dna": sz.dna_batch, "rna": sz.rna_batch,
                 "pe": 2 * sz.pe_batch}[cell]
            if len(names) != n:
                failures.append(f"{cell}: CPU output names {len(names)} "
                                f"reads, expected {n}")
            grade = {"dna": lambda x: bd.grade_dna(x, n),
                     "rna": lambda x: bd.grade_rna(x, n),
                     "pe": bd.grade_pe}[cell]
            g_gpu, g_cpu = grade(gpu), grade(cpu)
        say("compare", f"{cell}: {len(sam_body(cpu))} CPU lines, "
                       f"{len(diffs)} differ; GPU "
                       + ", ".join(f"{k} {v:.4f}" for k, v in g_gpu.items())
                       + " | CPU "
                       + ", ".join(f"{k} {v:.4f}" for k, v in g_cpu.items()))
        for i, a, b in diffs[:5]:
            say("compare", f"  line {i}\n    GPU {a}\n    CPU {b}")
        if diffs:
            failures.append(f"{cell}: {len(diffs)} lines differ")
        try:
            check_gates(cell, g_gpu, gates)
        except SmokeFailure as exc:
            failures.append(str(exc))

    with np.load(root / "cpu_ops.npz") as z:
        cpu_ops = {k: z[k] for k in z.files}
    for ln, ok in compare_ops(gpu_ops, cpu_ops):
        say("compare", "op " + ln)
        if not ok:
            failures.append("op " + ln)
    if failures:
        raise SmokeFailure("; ".join(failures))


# -------------------------------------------------------------------- main

def run(sz: Sizes, root: pathlib.Path, compile_only: bool = False) -> None:
    """Every phase after the device check (which main() makes)."""
    root.mkdir(parents=True, exist_ok=True)
    f, index = phase_setup(sz, root)
    phase_compile(sz, f, root)
    if compile_only:
        return
    child = start_reference(sz, root)
    try:
        gpu_out = phase_e2e(sz, f, root)
        phase_compare(sz, f, root, index, gpu_out, child, timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-after", choices=["compile"],
                    help="stop after the compile phase")
    ap.add_argument("--cpu-reference", metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--sizes", help=argparse.SUPPRESS)
    ap.add_argument("--cores", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sz = Sizes(**json.loads(args.sizes)) if args.sizes else Sizes()
    if args.cores:
        os.sched_setaffinity(0, [int(c) for c in args.cores.split(",")])
    if args.cpu_reference:
        reference_child(sz, pathlib.Path(args.cpu_reference))
        return 0
    t0 = time.perf_counter()
    try:
        device = phase_device()
        from tools import bench_data
        run(sz, bench_data.ROOT / "smoke", args.stop_after == "compile")
    except SmokeFailure as exc:
        print(f"FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    say("done", f"{time.perf_counter() - t0:.1f} s in all")
    if args.stop_after:
        return 0
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
