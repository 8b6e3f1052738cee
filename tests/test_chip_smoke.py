"""chip_smoke.py's helpers on the CPU: the device gate, the output
comparison and the truth grading it shares with bench.py."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tools import bench_data  # noqa: E402


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu_before_any_work():
    r = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "[setup]" not in r.stdout
    assert "not a GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


SAM = ["@HD\tVN:1.0\tSO:unsorted",
       "@SQ\tSN:chr1\tLN:1000",
       "@PG\tID:tpumap\tPN:tpumap\tCL:tpumap-gsnap -D gpu/db reads.fa",
       "r0\t0\tchr1\t101\t40\t100M\t*\t0\t0\tACGT\t*\tNM:i:0",
       "r1\t16\tchr1\t201\t40\t50M900N50M\t*\t0\t0\tACGT\t*\tNM:i:1"]


def test_compare_ignores_pg_line():
    other = list(SAM)
    other[2] = "@PG\tID:tpumap\tPN:tpumap\tCL:tpumap-gsnap -D cpu/db x.fa"
    assert chip_smoke.compare_text(SAM, other) == []


def test_compare_flags_one_byte():
    other = list(SAM)
    other[4] = other[4].replace("NM:i:1", "NM:i:2")
    diffs = chip_smoke.compare_text(SAM, other)
    assert diffs == [(3, SAM[4], other[4])]


def test_compare_flags_missing_line():
    diffs = chip_smoke.compare_text(SAM, SAM[:-1])
    assert diffs == [(3, SAM[4], None)]


def test_subset_keeps_headers_and_named_reads():
    assert chip_smoke.subset_lines(SAM, {"r1"}) == SAM[:3] + [SAM[4]]


@pytest.fixture
def tiny_plan(monkeypatch):
    monkeypatch.setattr(bench_data, "GENOME_LEN", 2_000_000)
    monkeypatch.setattr(bench_data, "N_GENES", 16)
    monkeypatch.setattr(bench_data, "N_READS", 200)
    return bench_data.rna_read_plan()


def _rna_line(i, plan_i, cigar=None, flag=0):
    segs = plan_i["segs"]
    if cigar is None:
        parts = [f"{segs[0][1]}M"]
        for (a, n), (b, n2) in zip(segs, segs[1:]):
            parts.append(f"{b - (a + n)}N{n2}M")
        cigar = "".join(parts)
    nj = len(segs) - 1
    return (f"q{i}_{nj}\t{flag}\tchr1\t{segs[0][0] + 1}\t40\t{cigar}\t*\t0"
            f"\t0\tACGT\t*")


def _bench_r05_rna(lines, truth):
    """bench.py's RNA arithmetic as it stood before the grading moved to
    tools/bench_data.py (one primary line per read, in read order)."""
    tp = fp = fn = n_loc = 0
    for line, (tjs, tstart) in zip(lines, truth):
        c = line.split("\t")
        flag, pos, cigar = int(c[1]), int(c[3]), c[5]
        pjs = set(bench_data.cigar_junctions(pos, cigar))
        tp += len(pjs & tjs)
        fp += len(pjs - tjs)
        fn += len(tjs - pjs)
        if not flag & 4 and abs(pos - 1 - tstart) <= 150:
            n_loc += 1
    return (tp / max(tp + fp, 1), tp / max(tp + fn, 1),
            n_loc / len(truth))


def test_rna_grading_reproduces_bench(tiny_plan):
    truth = bench_data.rna_truth()
    lines = [_rna_line(i, p) for i, p in enumerate(tiny_plan)]
    g = bench_data.grade_rna(lines)
    assert (g["junction_precision"], g["junction_recall"],
            g["locus_acc"]) == (1.0, 1.0, 1.0)
    # a missed junction, a false one, an unmapped read and a secondary
    spliced = [i for i, p in enumerate(tiny_plan) if len(p["segs"]) > 1]
    flat = [i for i, p in enumerate(tiny_plan) if len(p["segs"]) == 1]
    lines[spliced[0]] = _rna_line(spliced[0], tiny_plan[spliced[0]],
                                  cigar="100M")
    lines[flat[0]] = _rna_line(flat[0], tiny_plan[flat[0]],
                               cigar="50M500N50M")
    lines[flat[1]] = _rna_line(flat[1], tiny_plan[flat[1]], cigar="*",
                               flag=4)
    secondary = lines[flat[2]].replace("\t0\t", "\t256\t", 1)
    g = bench_data.grade_rna(lines + [secondary])
    want = _bench_r05_rna(lines, truth)
    assert (g["junction_precision"], g["junction_recall"],
            g["locus_acc"]) == want
    n_true = sum(len(t[0]) for t in truth)
    n_lost = len(tiny_plan[spliced[0]]["segs"]) - 1
    assert want[1] == (n_true - n_lost) / n_true
    assert want[2] == (len(truth) - 1) / len(truth)


def test_dna_and_pe_grading(monkeypatch):
    monkeypatch.setattr(bench_data, "N_READS", 50)
    starts = bench_data.read_plan()[0]
    lines = [f"r{i}\t0\tchr1\t{int(s) + 1}\t40\t100M\t*\t0\t0\tA\t*"
             for i, s in enumerate(starts)]
    lines[3] = lines[3].replace(f"\t{int(starts[3]) + 1}\t", "\t1\t")
    lines[4] = "r4\t4\t*\t0\t0\t*\t*\t0\t0\tA\t*"
    g = bench_data.grade_dna(lines)
    assert g == {"aligned_frac": 49 / 50, "locus_acc": 48 / 50}
    pe = ["p0/1\t99\tchr1\t1\t40\t100M", "p0/2\t147\tchr1\t300\t40\t100M",
          "p1/1\t65\tchr1\t1\t40\t100M", "p1/2\t129\tchr1\t9\t40\t100M",
          "p1/1\t321\tchr1\t5\t0\t100M"]
    assert bench_data.grade_pe(pe) == {"concordant_frac": 0.5}


def test_gmap_grading():
    plan = [[(1000, 200), (1500, 300)], [(5000, 150), (6000, 100)],
            [(9000, 120), (9300, 130)]]
    gff = ["##gff-version   3", "# Generated by tpumap using call: x",
           "chr1\tbench\tgene\t1001\t1800\t.\t+\t.\tID=c0.path1;Name=c0",
           "chr1\tbench\texon\t1001\t1200\t100\t+\t.\tID=c0.mrna1.exon1;"
           "Name=c0",
           "chr1\tbench\tgene\t7001\t7100\t.\t+\t.\tID=c1.path1;Name=c1"]
    assert chip_smoke.grade_gmap(gff, plan) == {"found_frac": 2 / 3,
                                                "locus_acc": 1 / 3}


def test_gates_fail_below_cpu_level():
    grades = {"junction_precision": 0.9995, "junction_recall": 0.9643,
              "locus_acc": 0.9911}
    chip_smoke.check_gates("rna", grades, chip_smoke.GATES)
    with pytest.raises(chip_smoke.SmokeFailure, match="junction_recall"):
        chip_smoke.check_gates("rna", {**grades, "junction_recall": 0.96},
                               chip_smoke.GATES)
    chip_smoke.check_gates("rna", {**grades, "junction_recall": 0.5}, {})


def test_op_compare_exact_ints_and_float_tolerance():
    import numpy as np
    ints = np.arange(12, dtype=np.int32).reshape(4, 3)
    floats = np.linspace(0.1, 1.0, 8, dtype=np.float32).reshape(4, 2)
    gpu = {"a.0": ints, "b.0": floats}
    assert all(ok for _l, ok in chip_smoke.compare_ops(gpu, dict(gpu)))
    off = ints.copy()
    off[2, 1] += 1
    near = floats * np.float32(1 + 1e-6)
    far = floats * np.float32(1 + 1e-3)
    (la, oka), (lb, okb) = chip_smoke.compare_ops(gpu, {"a.0": off,
                                                        "b.0": near})
    assert not oka and "1 rows differ, first [2]" in la
    assert okb and "relative difference" in lb
    assert not chip_smoke.compare_ops(gpu, {"a.0": ints, "b.0": far})[1][1]
    assert not chip_smoke.compare_ops(gpu, {"a.0": ints})[1][1]
