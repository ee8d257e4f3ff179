#!/usr/bin/env python
"""Smoke test of the codec's GPU path on one NVIDIA GPU (or four).

    python chip_smoke.py          # phases 0-3 on one card
    python chip_smoke.py --four   # phase 4 only: the corpus on a 4-card mesh

Phases, each printing one line of findings:

0. device: a GPU must be JAX's default device; prints its kind, the device
   count and nvidia-smi's name and power limit.
1. kernels: the three GPU filter kernels (kernels/gpu_filters.py), compiled
   for the card, against the `lax.scan` twins through XLA on the same card,
   at B = 2048 rows and the (p, T, M, L) of presets 2 and 4 and of the
   format's limits, plus ragged row counts and order-0 stages. Exact
   equality; prints each kernel's time beside the scan's.
2. files: a 5-minute CD-stereo file (preset 2) and a 60 s 96 kHz/24-bit
   5.1 file (preset 4) encoded with backend='device' (device_entropy
   'auto', 'off' and 'on') must be byte-identical to backend='host', and
   decode PCM-exact;
   the GPU kernels must be what ran. Prints the wall times.
3. corpus: encode_corpus (filter_batch=16) and decode_corpus over 16 files
   of 30 s CD stereo with backend='device', file by file equal to a
   backend='host' run.
4. (--four) phase 3's corpus with backend='mesh' over a (4, 1)
   ('blocks', 'channels') mesh of four cards, against the host run.

Any mismatch raises; the last line of standard output is one JSON object
naming the device, printed only when every phase passed. The full
findings also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
B_ROWS = 2048
# (p, T, M, L): preset 2, preset 4, the format's limits (SLAInternal.h)
KERNEL_SHAPES = [(16, 1, 8, 12288), (32, 3, 8, 16384), (48, 5, 40, 16384)]
# ragged row counts and order-0 stages
EDGE_SHAPES = [(16, 1, 8, 12288), (0, 0, 0, 4096), (0, 5, 0, 4096), (48, 0, 40, 4096)]
EDGE_ROWS = 2043


def phase_device(need: int) -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"FAIL: JAX's default device is {devs[0].platform}, not a GPU")
    if len(devs) < need:
        raise SystemExit(f"FAIL: {need} GPUs needed, {len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return {"kind": devs[0].device_kind, "count": len(devs), "nvidia_smi": smi}


def _best(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _filter_inputs(B: int, L: int, p: int, T: int, seed: int):
    """Random rows with realistic widths: 24-bit samples, Q15 PARCOR and
    long-term taps, pitches over the analysis range with pitch-0 rows and
    the shortest legal pitch (3: a one-sample feedback lag at T = 5)."""
    import jax
    import jax.numpy as jnp

    k = jax.random.split(jax.random.key(seed), 4)
    data = jax.random.randint(k[0], (B, L), -(1 << 23), 1 << 23, jnp.int32)
    coef = jax.random.randint(k[1], (B, max(p, 1)), -(1 << 14), 1 << 14, jnp.int32)
    pitch = jax.random.randint(k[2], (B,), 20, 256, jnp.int32)
    pitch = pitch.at[::7].set(0).at[1::97].set(3)
    ltm = jax.random.randint(k[3], (B, max(T, 1)), -(1 << 13), 1 << 13, jnp.int32) << 16
    return data, coef[:, :p], pitch, ltm


def phase_kernels() -> dict:
    import jax.numpy as jnp

    from sla_tpu.kernels import gpu_filters as g
    from sla_tpu.pipeline import (
        _decode_stage_scan,
        _encode_stage1_scan,
        _encode_stage2_scan,
    )

    def check(B, p, T, M, L, seed, timed):
        d, c, pi, lt = _filter_inputs(B, L, p, T, seed)
        k1 = lambda: g.stage1(d, c, p)  # noqa: E731
        s1 = lambda: _encode_stage1_scan(d, c, p)  # noqa: E731
        r1 = s1()
        k2 = lambda: g.stage2(r1, pi, lt, T, M)  # noqa: E731
        s2 = lambda: _encode_stage2_scan(r1, pi, lt, T, M)  # noqa: E731
        r2 = s2()
        k3 = lambda: g.synth(r2, c, pi, lt, p, T, M)  # noqa: E731
        s3 = lambda: _decode_stage_scan(r2, c, pi, lt, p, T, M)  # noqa: E731
        name = f"p{p}_T{T}_M{M}_L{L}_B{B}"
        for kname, kern, ref in (("stage1", k1, r1), ("stage2", k2, r2),
                                 ("synth", k3, s3())):
            if not bool(jnp.array_equal(kern(), ref)):
                raise AssertionError(f"{kname} kernel != scan at {name}")
        if not bool(jnp.array_equal(k3(), d)):
            raise AssertionError(f"synth does not invert the encode at {name}")
        if not timed:
            return name, "exact"
        ms = lambda fn, n: round(_best(fn, n) * 1e3, 3)  # noqa: E731
        return name, {
            "stage1_ms": ms(k1, 3), "stage1_scan_ms": ms(s1, 1),
            "stage2_ms": ms(k2, 3), "stage2_scan_ms": ms(s2, 1),
            "synth_ms": ms(k3, 3), "synth_scan_ms": ms(s3, 1),
        }

    out = {}
    for i, (p, T, M, L) in enumerate(KERNEL_SHAPES):
        name, res = check(B_ROWS, p, T, M, L, seed=i, timed=True)
        out[name] = res
    for i, (p, T, M, L) in enumerate(EDGE_SHAPES):
        name, res = check(EDGE_ROWS, p, T, M, L, seed=10 + i, timed=False)
        out[name] = res
    return out


def hires_51(seconds: int = 60, rate: int = 96000) -> np.ndarray:
    """6-channel 24-bit test signal: per-channel tones + smoothed noise,
    canonical left-justified int32."""
    rng = np.random.default_rng(51)
    n = rate * seconds
    t = np.arange(n) / rate
    chans = []
    for c in range(6):
        tone = 0.2 * np.sin(2 * np.pi * (110 * (c + 1)) * t + c)
        noise = np.convolve(rng.normal(0, 0.01, n), np.ones(4) / 4, "same")
        chans.append(tone + noise)
    full = (1 << 23) - 1
    pcm = np.clip(np.stack(chans) * full, -full - 1, full).astype(np.int32)
    return pcm << 8


def _assert_kernels_ran(what: str) -> dict:
    """Every filter dispatch since DISPATCH was cleared took the GPU
    kernel, and each of the three stages ran. Returns the counts."""
    from sla_tpu.pipeline import DISPATCH

    calls = {f"{s}:{i}": n for (s, i), n in sorted(DISPATCH.items())}
    if any(i != "kernel" for (_, i) in DISPATCH) or not all(
        DISPATCH[s, "kernel"] for s in ("stage1", "stage2", "synth")
    ):
        raise AssertionError(f"{what}: the GPU kernels did not serve every stage: {calls}")
    return calls


def phase_files() -> dict:
    import bench
    import sla_tpu as sla
    from sla_tpu import native
    from sla_tpu.pipeline import DISPATCH

    # backend='host' must be the native C++ path the differential tests tie
    # to the reference binary, built here from sla_native.cpp
    if not native.available():
        raise AssertionError("the native host library did not build")

    cases = [
        ("cd_stereo_300s_p2", bench.make_signal(300), sla.WaveFormat(2, 16, 44100), 2),
        ("hires_51_60s_p4", hires_51(), sla.WaveFormat(6, 24, 96000), 4),
    ]
    out = {}
    for name, pcm, wf, preset in cases:
        ep = sla.preset_parameter(preset, wf.num_channels)

        def encode(backend, device_entropy="auto"):
            enc = sla.Encoder(sla.EncoderConfig(
                backend=backend, device_entropy=device_entropy))
            enc.set_wave_format(wf)
            enc.set_encode_parameter(ep)
            t0 = time.perf_counter()
            blob = enc.encode_whole(pcm)
            return blob, time.perf_counter() - t0

        def decode(blob, backend, device_entropy="auto"):
            dec = sla.Decoder(sla.DecoderConfig(
                backend=backend, device_entropy=device_entropy))
            t0 = time.perf_counter()
            _, got = dec.decode_whole(blob)
            return got, time.perf_counter() - t0

        res = {}
        host_blob, res["enc_host_first_s"] = encode("host")
        host_blob, res["enc_host_s"] = encode("host")
        DISPATCH.clear()
        for ent in ("auto", "off", "on"):
            blob, res[f"enc_device_ent_{ent}_first_s"] = encode("device", ent)
            if blob != host_blob:
                raise AssertionError(f"{name}: device encode (entropy {ent}) != host")
            blob, res[f"enc_device_ent_{ent}_s"] = encode("device", ent)
            if blob != host_blob:
                raise AssertionError(f"{name}: device encode (entropy {ent}) != host")
        for key in ("dec_host_first_s", "dec_host_s"):
            got, res[key] = decode(host_blob, "host")
            if not np.array_equal(got, pcm):
                raise AssertionError(f"{name}: host decode is not PCM-exact")
        for ent in ("auto", "off", "on"):
            got, res[f"dec_device_ent_{ent}_first_s"] = decode(host_blob, "device", ent)
            if not np.array_equal(got, pcm):
                raise AssertionError(f"{name}: device decode (entropy {ent}) not exact")
            got, res[f"dec_device_ent_{ent}_s"] = decode(host_blob, "device", ent)
            if not np.array_equal(got, pcm):
                raise AssertionError(f"{name}: device decode (entropy {ent}) not exact")
        res["dispatch"] = _assert_kernels_ran(name)
        res["row_samples"] = int(pcm.shape[0] * pcm.shape[1])
        res["ratio"] = round(len(host_blob) / (pcm.size * wf.bit_per_sample / 8), 4)
        out[name] = {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in res.items()}
    return out


def _corpus_files(root: pathlib.Path, n: int = 16, seconds: int = 30):
    import bench
    from sla_tpu import wavio

    base = bench.make_signal(seconds)
    files = []
    for i in range(n):
        # distinct content per file: rotate and scale the shared signal
        pcm = (np.roll(base, 977 * i, axis=1) >> 16) * (8 + i) // 16
        path = root / f"track{i:02d}.wav"
        wavio.write_wav(str(path), wavio.WavFile(2, 44100, 16, pcm.astype(np.int32) << 16))
        files.append(path)
    return files


def phase_corpus(backend: str) -> dict:
    import sla_tpu as sla
    from sla_tpu.corpus import decode_corpus, encode_corpus
    from sla_tpu.pipeline import DISPATCH

    out = {}
    with tempfile.TemporaryDirectory() as td:
        root = pathlib.Path(td)
        (root / "wav").mkdir()
        files = _corpus_files(root / "wav")
        runs = {}
        for be in ("host", backend):
            if be != "host":
                DISPATCH.clear()
            enc = encode_corpus(
                files, root / f"sla_{be}", filter_batch=16, resume=False,
                encoder_config=sla.EncoderConfig(backend=be),
            )
            slas = sorted((root / f"sla_{be}").glob("*.sla"))
            dec = decode_corpus(
                slas, root / f"wav_{be}", resume=False,
                decoder_config=sla.DecoderConfig(backend=be),
            )
            if enc.failed or dec.failed or len(slas) != len(files):
                raise AssertionError(f"corpus {be}: {enc.failed} encode / "
                                     f"{dec.failed} decode failures")
            runs[be] = slas
            out[f"enc_{be}_s"] = round(enc.seconds, 4)
            out[f"dec_{be}_s"] = round(dec.seconds, 4)
        for h, d in zip(runs["host"], runs[backend]):
            if h.name != d.name or h.read_bytes() != d.read_bytes():
                raise AssertionError(f"corpus: {d.name} differs from the host encode")
            wh = root / "wav_host" / (h.stem + ".wav")
            wd = root / f"wav_{backend}" / (d.stem + ".wav")
            if wh.read_bytes() != wd.read_bytes():
                raise AssertionError(f"corpus: {wd.name} differs from the host decode")
        out["dispatch"] = _assert_kernels_ran(f"corpus {backend}")
        out["files"] = len(files)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the corpus on a 4-card mesh (phase 4)")
    args = ap.parse_args()
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))

    findings = {}
    dev = phase_device(4 if args.four else 1)
    findings["device"] = dev
    print("phase 0 device:", json.dumps(dev), flush=True)
    import sla_tpu  # noqa: F401  (x64, compile cache)

    if args.four:
        from sla_tpu.parallel import make_mesh

        mesh = make_mesh(channel_parallel=1)
        if dict(mesh.shape) != {"blocks": 4, "channels": 1}:
            raise AssertionError(f"unexpected mesh {dict(mesh.shape)}")
        t0 = time.perf_counter()
        findings["corpus_mesh"] = phase_corpus("mesh")
        findings["corpus_mesh"]["mesh"] = dict(mesh.shape)
        findings["corpus_mesh"]["phase_s"] = round(time.perf_counter() - t0, 2)
        print("phase 4 corpus mesh:", json.dumps(findings["corpus_mesh"]), flush=True)
    else:
        for label, key, fn in (
            ("phase 1 kernels:", "kernels", phase_kernels),
            ("phase 2 files:", "files", phase_files),
            ("phase 3 corpus:", "corpus", lambda: phase_corpus("device")),
        ):
            t0 = time.perf_counter()
            findings[key] = fn()
            findings[key]["phase_s"] = round(time.perf_counter() - t0, 2)
            print(label, json.dumps(findings[key]), flush=True)

    import jax

    d0 = jax.devices()[0]
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / ("chip_smoke_four.json" if args.four else "chip_smoke.json")).write_text(
        json.dumps(findings, indent=1)
    )
    print(" ".join(dev["nvidia_smi"]))
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
