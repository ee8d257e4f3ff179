"""Measure multi-process corpus encode: serial vs P concurrent workers.

Backs the BASELINE.md multi-process row (VERDICT r2 #1): launches real
OS processes sharded with corpus.shard_files over one shared output dir,
verifies every output is byte-identical to the serial run, and reports
wall times. On this 1-core host P>1 cannot beat serial wall time — the
deliverable is measured coordination overhead + correctness; on multi-core
production hosts the same code path scales at file granularity.

Usage: python tools/measure_multiproc.py [n_files] [n_procs]
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from sla_tpu import wavio
from sla_tpu.corpus import encode_corpus, merge_manifests

_WORKER = """
import json, sys
from sla_tpu.corpus import encode_corpus
files = json.loads(sys.argv[1])
res = encode_corpus(files, sys.argv[2], preset=2,
                    process_index=int(sys.argv[3]), process_count=int(sys.argv[4]))
print(json.dumps({"encoded": res.encoded, "failed": res.failed,
                  "seconds": res.seconds}))
"""


def make_corpus(root: pathlib.Path, n_files: int) -> list[pathlib.Path]:
    rng = np.random.default_rng(7)
    files = []
    for i in range(n_files):
        n = 5 * 44100  # 5 s CD stereo, the BASELINE bulk-corpus config
        t = np.arange(n) / 44100.0
        sig = (0.4 * np.sin(2 * np.pi * (220 + 7 * i) * t)
               + 0.1 * rng.standard_normal(n))
        pcm = np.clip(sig * 32767, -32768, 32767).astype(np.int32)
        stereo = np.stack([pcm, np.roll(pcm, 3)], axis=0) << 16
        p = root / f"track{i:03d}.wav"
        wavio.write_wav(str(p), wavio.WavFile(2, 44100, 16, stereo))
        files.append(p)
    return files


def run_procs(files, out_dir, n_procs) -> float:
    # the workers stay on the host backend: several processes must never
    # open one card (each JAX client reserves most of its memory); point
    # them at the repo so `import sla_tpu` works from any cwd
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER,
             json.dumps([str(f) for f in files]), str(out_dir), str(i), str(n_procs)],
            stdout=subprocess.PIPE, env=env, text=True)
        for i in range(n_procs)
    ]
    outs = [json.loads(p.communicate(timeout=600)[0]) for p in procs]
    wall = time.perf_counter() - t0
    assert all(o["failed"] == 0 for o in outs), outs
    assert sum(o["encoded"] for o in outs) == len(files), outs
    return wall


def main() -> None:
    n_files = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    n_procs = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    with tempfile.TemporaryDirectory() as td:
        root = pathlib.Path(td)
        (root / "in").mkdir()
        files = make_corpus(root / "in", n_files)
        in_bytes = sum(f.stat().st_size for f in files)
        samples = n_files * 5 * 44100 * 2

        out_serial = root / "serial"
        t0 = time.perf_counter()
        res = encode_corpus(files, out_serial, preset=2)
        t_serial = time.perf_counter() - t0
        assert res.encoded == n_files and res.failed == 0

        out_multi = root / "multi"
        t_multi = run_procs(files, out_multi, n_procs)
        for f in files:
            a = (out_serial / (f.stem + ".sla")).read_bytes()
            b = (out_multi / (f.stem + ".sla")).read_bytes()
            assert a == b, f"output mismatch for {f.name}"
        merged = merge_manifests(out_multi)
        assert merged["encoded"] == n_files

        print(json.dumps({
            "n_files": n_files, "n_procs": n_procs,
            "pcm_msamples": round(samples / 1e6, 2),
            "in_mbytes": round(in_bytes / 1e6, 2),
            "serial_s": round(t_serial, 3),
            "multi_s": round(t_multi, 3),
            "serial_msps": round(samples / t_serial / 1e6, 2),
            "multi_msps": round(samples / t_multi / 1e6, 2),
            "byte_identical": True,
        }))


if __name__ == "__main__":
    main()
