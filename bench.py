#!/usr/bin/env python
"""Benchmark: end-to-end SLA encode throughput, CD stereo 44.1 kHz/16-bit,
default preset 2 (reference src/main.c:63-76), against the single-core
reference C encoder (BASELINE.md measurement plan).

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "Msamples/s", "vs_baseline": N}

`value` counts PCM samples (frames x channels) per wall second of
`Encoder.encode_whole`, after a warmup run that absorbs JIT compilation. `vs_baseline` is the ratio to the reference C binary's
throughput measured on the same host when buildable, else to the stored
constant below.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# Reference C binary throughput on this config, measured on the build host
# (gcc -std=c89 -O3 -DNDEBUG, single core): 30 s CD stereo -> 1.57 s.
REF_BASELINE_MSPS = 1.685

SECONDS = 30
RATE = 44100


def make_signal(seconds: int = SECONDS) -> np.ndarray:
    """Correlated stereo test signal: tones + smoothed noise, realistic
    compressibility (reference ratio ~0.56 at preset 2)."""
    rng = np.random.default_rng(7)
    n = RATE * seconds
    t = np.arange(n) / RATE
    sig = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 1320 * t)
    noise = rng.normal(0, 0.02, (2, n))
    k = np.ones(8) / 8
    noise = np.stack([np.convolve(noise[0], k, "same"), np.convolve(noise[1], k, "same")])
    pcm = np.clip(
        (sig[None, :] * np.array([[1.0], [0.9]]) + noise) * 32767, -32768, 32767
    ).astype(np.int32)
    return pcm << 16  # canonical left-justified int32


def reference_binary() -> pathlib.Path | None:
    ref = REPO / "tools" / "sla_ref"
    if ref.exists():
        return ref
    src = pathlib.Path("/root/reference/src")
    if not src.exists():
        return None
    try:
        subprocess.run(
            ["gcc", "-std=c89", "-O3", "-DNDEBUG", "-o", str(ref)]
            + [str(p) for p in sorted(src.glob("*.c"))]
            + [f"-I{src}/include/public", f"-I{src}/include/private", "-lm"],
            check=True,
            capture_output=True,
        )
    except Exception:
        return None
    return ref


def time_reference_once(ref: pathlib.Path, wav_path: pathlib.Path) -> float | None:
    out = wav_path.parent / "bench_ref.sla"
    t0 = time.time()
    r = subprocess.run(
        [str(ref), "-e", "-q", "-m", "2", str(wav_path), str(out)],
        capture_output=True,
    )
    if r.returncode != 0:
        return None
    return time.time() - t0


def reference_overhead_floor(ref: pathlib.Path, tmp: pathlib.Path) -> float:
    """Wall-clock floor of a reference run that does ~no encoding work
    (process spawn + tiny WAV parse + tiny write): subtracted from the
    measured encode walls so the ratio compares encode cost against
    encode cost, not our in-memory call against spawn+IO. The ~10 MB
    input read is NOT captured here (a residual ~2% bias against us)."""
    import numpy as _np

    from sla_tpu import wavio as _wavio

    tiny = tmp / "bench_tiny.wav"
    _wavio.write_wav(str(tiny), _wavio.WavFile(
        2, RATE, 16, _np.zeros((2, 256), dtype=_np.int32)))
    floors = []
    for _ in range(3):
        t = time_reference_once(ref, tiny)
        if t is not None:
            floors.append(t)
    return min(floors) if floors else 0.0


def main() -> None:
    import sla_tpu as sla
    from sla_tpu import wavio

    data = make_signal()
    n = data.shape[1]

    enc = sla.Encoder()
    enc.set_wave_format(sla.WaveFormat(2, 16, RATE))
    enc.set_encode_parameter(sla.PRESETS[2])

    # warmup: compile every jitted stage
    enc.encode_whole(np.ascontiguousarray(data[:, : 4 * 12288]))

    tmp = pathlib.Path("/tmp")
    wav_path = tmp / "bench_cd.wav"
    wavio.write_wav(str(wav_path), wavio.WavFile(2, RATE, 16, data))
    ref = reference_binary()

    # interleaved best-of pairs: this host's timings swing under
    # noisy-neighbor load, so sample ours and the reference back to back
    # and take each side's best — load spikes then hit both measurements
    # instead of skewing the ratio
    spawn_floor = reference_overhead_floor(ref, tmp) if ref is not None else 0.0
    dt = None
    ref_dt = None
    for _ in range(5):  # best-of-5: this host's noisy-neighbor load swings ±20%
        t0 = time.time()
        blob = enc.encode_whole(data)
        t = time.time() - t0
        dt = t if dt is None else min(dt, t)
        if ref is not None:
            rt = time_reference_once(ref, wav_path)
            if rt is not None:
                ref_dt = rt if ref_dt is None else min(ref_dt, rt)
    msps = 2 * n / dt / 1e6

    # correctness gate: round-trip must be bit-exact
    dec = sla.Decoder()
    _, out = dec.decode_whole(blob)
    assert np.array_equal(out, data), "round-trip mismatch"

    if ref_dt:
        ref_dt = max(ref_dt - spawn_floor, 1e-6)
    ref_msps = 2 * n / ref_dt / 1e6 if ref_dt else REF_BASELINE_MSPS

    ratio = len(blob) / (4 * n)
    print(
        f"encode {dt:.2f}s  ratio {ratio:.4f}  ref {ref_msps:.3f} Msamples/s",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "encode_throughput_cd_stereo_preset2",
                "value": round(msps, 3),
                "unit": "Msamples/s",
                "vs_baseline": round(msps / ref_msps, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
