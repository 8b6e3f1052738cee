"""Multi-process ordered output merge (parallel/outmerge.py, gsnap -O):
a 2-process run with --ordered must write ONE stream, from process
0 only, byte-identical to the single-process run — the
Outbuffer_thread_ordered contract (src/outbuffer.c:1387) at the
process-per-host scale (SURVEY §5 distributed backend)."""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).parents[1]

WORKER = r"""
import sys
import jax

coord, nproc, pid, dbdir, reads, outdir = sys.argv[1:7]
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=coord,
                           num_processes=int(nproc),
                           process_id=int(pid))
from tpumap.cli import gsnap_cli

rc = gsnap_cli.main(["-D", dbdir, "--batch-size", "32", "-O",
                     "--no-sam-headers",
                     "-o", f"{outdir}/p{pid}.sam", reads])
sys.exit(rc or 0)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_ordered_merge(tmp_path):
    rng = np.random.default_rng(17)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    (tmp_path / "g.fa").write_text(">chr1\n" + seq + "\n")
    reads = []
    for i in range(101):          # odd count: uneven shards + tail
        p = int(rng.integers(0, 19000 - 100))
        reads.append(f">r{i:03d}\n{seq[p:p + 100]}\n")
    (tmp_path / "reads.fa").write_text("".join(reads))

    from tpumap.index import build_db
    db = build_db(tmp_path / "g.fa", name="om", k=12, interval=3)
    db.save(str(tmp_path / "omdb"))

    from tpumap.cli import gsnap_cli
    rc = gsnap_cli.main(["-D", str(tmp_path / "omdb"),
                         "--batch-size", "32", "--no-sam-headers",
                         "-o", str(tmp_path / "single.sam"),
                         str(tmp_path / "reads.fa")])
    assert not rc

    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, "2", str(pid),
         str(tmp_path / "omdb"), str(tmp_path / "reads.fa"),
         str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err.decode()[-3000:]

    single = (tmp_path / "single.sam").read_text()
    merged = (tmp_path / "p0.sam").read_text()
    assert merged == single
    # the non-writer process emits nothing
    assert (tmp_path / "p1.sam").read_text() == ""
