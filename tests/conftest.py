"""Test configuration: force the CPU backend with 8 virtual devices so
sharding tests exercise a multi-device mesh without accelerator hardware.
Tests marked `gpu` need the card; they skip here and run on it."""

import os

import jax
import pathlib
import subprocess

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
REF_BIN = REPO / "tools" / "sla_ref"


def pytest_configure(config):
    """Force CPU with 8 virtual devices regardless of ambient platform
    config (a config update before backend initialization wins over any
    installed accelerator plugin) — except for `-m gpu`, the run of the
    card's own tests, which keeps JAX's default platform."""
    if config.option.markexpr == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session")
def ref_binary() -> pathlib.Path:
    """Reference C binary for differential tests; built from the read-only
    reference sources into tools/ if not already present."""
    if not REF_BIN.exists():
        src = pathlib.Path("/root/reference/src")
        if not src.exists():
            pytest.skip("reference sources unavailable")
        REF_BIN.parent.mkdir(exist_ok=True)
        subprocess.run(
            # -O3 exactly like bench.py/the reference Makefile — one flag
            # set so the measured baseline can never drift between builders
            ["gcc", "-std=c89", "-O3", "-DNDEBUG", "-o", str(REF_BIN)]
            + [str(p) for p in sorted(src.glob("*.c"))]
            + [f"-I{src}/include/public", f"-I{src}/include/private", "-lm"],
            check=True,
        )
    return REF_BIN


@pytest.fixture(scope="session")
def a_wav() -> pathlib.Path:
    p = FIXTURES / "a.wav"
    if not p.exists():
        ref = pathlib.Path("/root/reference/test/a.wav")
        if not ref.exists():
            pytest.skip("a.wav fixture unavailable")
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(ref.read_bytes())
    return p


@pytest.fixture(scope="session")
def ref_custom() -> pathlib.Path:
    """Reference-LIBRARY harness (tools/ref_custom.c): encodes with encode
    parameters the reference CLI cannot express (Hann/Blackman/Vorbis
    windows, custom orders) for API-only byte-identity differentials."""
    bin_path = REF_BIN.parent / "sla_ref_custom"
    if not bin_path.exists():
        src = pathlib.Path("/root/reference/src")
        if not src.exists():
            pytest.skip("reference sources unavailable")
        subprocess.run(
            ["gcc", "-std=c89", "-O3", "-DNDEBUG", "-o", str(bin_path),
             str(REF_BIN.parent / "ref_custom.c")]
            + [str(p) for p in sorted(src.glob("*.c")) if p.name != "main.c"]
            + [f"-I{src}/include/public", f"-I{src}/include/private", "-lm"],
            check=True,
        )
    return bin_path
