#!/usr/bin/env python
"""Re-exec a Python tool under ASan+UBSan with the instrumented native lib.

The native C++ (sla_native.cpp) parses untrusted streams; this wrapper turns
the corruption/identity fuzzers into memory-safety instruments:

    python tools/run_sanitized.py tools/fuzz_corruption.py 5000
    python tools/run_sanitized.py tools/fuzz_identity.py 100

ASan must own malloc from process start for redzones on the numpy buffers
the native code reads/writes, so we LD_PRELOAD libasan/libubsan and re-exec.
SLA_TPU_SANITIZE=1 makes sla_tpu.native build+load libsla_native_san.so
(same fp flags as the production lib — byte-identity holds under ASan, so
identity fuzz doubles as a sanitizer workload). Any finding aborts
(-fno-sanitize-recover + abort_on_error); a clean exit 0 is the deliverable
recorded in VALIDATION.md.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys


def _runtime(name: str) -> str:
    out = subprocess.run(
        ["g++", f"-print-file-name={name}"], capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    path = pathlib.Path(out)
    if not path.is_absolute() or not path.exists():
        raise SystemExit(f"sanitizer runtime {name} not found (got {out!r})")
    return str(path.resolve())


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    env = dict(os.environ)
    preload = [_runtime("libasan.so"), _runtime("libubsan.so")]
    if env.get("LD_PRELOAD"):
        preload.append(env["LD_PRELOAD"])
    env["LD_PRELOAD"] = ":".join(preload)
    env["SLA_TPU_SANITIZE"] = "1"
    # leak detection off: CPython/numpy hold allocations to exit by design;
    # the target class here is OOB read/write + UB, not leaks
    # detect_stack_use_after_return stays OFF: GCC's fake-stack rewriting
    # SEGVs on lms_rowsT's ~60 KB AVX-512 ring-buffer frame (reproducible,
    # ASan-only — the non-instrumented build and ASan-without-fake-stack
    # are clean). UAR is also the least relevant class here: every native
    # entry point writes into caller-owned numpy buffers, never returns
    # pointers to its own frame.
    env["ASAN_OPTIONS"] = (
        "detect_leaks=0:abort_on_error=1:strict_string_checks=1:"
        "detect_stack_use_after_return=0:check_initialization_order=1:"
        + env.get("ASAN_OPTIONS", "")
    )
    env["UBSAN_OPTIONS"] = "halt_on_error=1:print_stacktrace=1:" + env.get(
        "UBSAN_OPTIONS", ""
    )
    # fuzzing is a host-only workload: keep JAX on the CPU under ASan
    env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable] + sys.argv[1:]
    return subprocess.run(cmd, env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
