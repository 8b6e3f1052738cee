"""Native C++ tokenizer (tpumap/native): FASTQ/FASTA scan + 2-bit encode
must agree exactly with the Python readers (src/shortread.c role)."""
import numpy as np
import pytest

from tpumap.io.fastread import _python_fallback, load_reads_arrays
from tpumap.native import get_lib

need_native = pytest.mark.skipif(get_lib() is None,
                                 reason="g++ unavailable")


@pytest.fixture
def fastq(tmp_path):
    rng = np.random.default_rng(1)
    recs = []
    for i in range(50):
        L = int(rng.integers(30, 150))
        seq = "".join("ACGTN"[j] for j in rng.integers(0, 5, L))
        recs.append(f"@read{i} extra stuff\n{seq}\n+\n{'F' * L}\n")
    p = tmp_path / "r.fq"
    p.write_text("".join(recs))
    return p


@pytest.fixture
def fasta_multiline(tmp_path):
    rng = np.random.default_rng(2)
    out = []
    for i in range(10):
        L = int(rng.integers(100, 400))
        seq = "".join("ACGT"[j] for j in rng.integers(0, 4, L))
        wrapped = "\n".join(seq[k:k + 60] for k in range(0, L, 60))
        out.append(f">ctg{i} desc\n{wrapped}\n")
    p = tmp_path / "g.fa"
    p.write_text("".join(out))
    return p


@need_native
def test_fastq_native_matches_python(fastq):
    names, quals, batch = load_reads_arrays(str(fastq))
    pn, pq, pb = _python_fallback(str(fastq), None)
    assert names == pn
    assert quals == pq
    assert np.array_equal(batch["lengths"], pb["lengths"])
    assert np.array_equal(batch["codes"], pb["codes"])
    assert np.array_equal(batch["nmask"], pb["nmask"])


@need_native
def test_fasta_multiline_native_matches_python(fasta_multiline):
    names, quals, batch = load_reads_arrays(str(fasta_multiline))
    pn, _pq, pb = _python_fallback(str(fasta_multiline), None)
    assert names == pn
    assert quals is None
    assert np.array_equal(batch["codes"], pb["codes"])
    assert np.array_equal(batch["nmask"], pb["nmask"])


@need_native
def test_max_len_truncation(fastq):
    names, _q, batch = load_reads_arrays(str(fastq), max_len=40)
    assert batch["codes"].shape[1] == 40
    assert batch["lengths"].max() <= 40


def test_gzip_falls_back(tmp_path):
    import gzip
    p = tmp_path / "r.fq.gz"
    with gzip.open(p, "wt") as f:
        f.write("@a\nACGT\n+\nIIII\n")
    names, quals, batch = load_reads_arrays(str(p))
    assert names == ["a"]
    assert list(batch["codes"][0][:4]) == [0, 1, 2, 3]


def test_changed_key_triggers_rebuild(tmp_path, monkeypatch):
    import os
    import shutil

    from tpumap import native
    srcs = []
    for s in native._SRCS:
        shutil.copy(s, tmp_path / os.path.basename(s))
        srcs.append(str(tmp_path / os.path.basename(s)))
    build = tmp_path / "build"
    first = native.ensure_built(srcs, build_dir=str(build))
    stamp = os.path.getmtime(first)
    assert native.ensure_built(srcs, build_dir=str(build)) == first
    assert os.path.getmtime(first) == stamp          # reused, not rebuilt
    with open(srcs[0], "a") as f:
        f.write("\n// changed source\n")
    second = native.ensure_built(srcs, build_dir=str(build))
    assert second != first and os.path.exists(second)
    assert not list(build.glob("*.tmp"))
    key = native.build_key(srcs)
    assert native.build_key(srcs, flags=["-O2", "-shared", "-fPIC"]) != key
    monkeypatch.setattr(native.platform, "machine", lambda: "other-arch")
    assert native.build_key(srcs) != key
