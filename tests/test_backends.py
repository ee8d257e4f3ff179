"""Backend equivalence: 'host' (C++), 'device' (JAX pipeline), and 'auto'
must produce byte-identical streams and identical PCM."""

import numpy as np
import pytest

import sla_tpu as sla
from sla_tpu import native
from sla_tpu.pipeline import fetch_int32

from .test_encode_decode import gen_wave


@pytest.mark.parametrize("kind", ["chirp", "gauss"])
def test_encoder_backends_byte_identical(kind):
    pcm = gen_wave(kind, 20000, 2, 16, 0, seed=31)
    blobs = {}
    for backend in ["host", "device", "auto"]:
        if backend == "host" and not native.available():
            continue
        enc = sla.Encoder(sla.EncoderConfig(backend=backend))
        enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(sla.PRESETS[1])
        blobs[backend] = enc.encode_whole(pcm)
    vals = list(blobs.values())
    assert all(b == vals[0] for b in vals)


def test_decoder_backends_identical():
    import jax

    pcm = gen_wave("chirp", 20000, 2, 16, 0, seed=32)
    enc = sla.Encoder()
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[1])
    blob = enc.encode_whole(pcm)
    backends = ["host", "device", "auto"]
    if len(jax.devices()) >= 8:
        backends.append("mesh")
    for backend in backends:
        if backend == "host" and not native.available():
            continue
        dec = sla.Decoder(sla.DecoderConfig(backend=backend))
        _, out = dec.decode_whole(blob)
        assert np.array_equal(out, pcm), backend


def test_mesh_backend_byte_identical():
    """backend='mesh': end-to-end encode with rows sharded across the
    8-device virtual mesh produces the same stream as the host backend."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    pcm = gen_wave("chirp", 30000, 2, 16, 0, seed=33)

    def encode(backend):
        enc = sla.Encoder(sla.EncoderConfig(backend=backend))
        enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(sla.PRESETS[2])
        return enc.encode_whole(pcm)

    assert encode("mesh") == encode("host")


def test_fetch_int32_packing():
    import jax.numpy as jnp

    small = jnp.asarray(np.array([[-32768, 32767, 0, 5]], dtype=np.int32))
    out = fetch_int32(small)
    assert out.dtype == np.int32
    assert np.array_equal(out, np.asarray(small))
    big = jnp.asarray(np.array([[1 << 20, -(1 << 20)]], dtype=np.int32))
    out2 = fetch_int32(big)
    assert np.array_equal(out2, np.asarray(big))


# ---- backend policy ---------------------------------------------------------

def _policy_env(monkeypatch, live):
    from sla_tpu import pipeline

    monkeypatch.delenv("SLA_TPU_DEVICE_THRESHOLD", raising=False)
    monkeypatch.setattr(pipeline, "_live_platform", lambda: live)
    monkeypatch.setattr(native, "available", lambda: True)


@pytest.mark.parametrize(
    "platform,ndev,want",
    [("gpu", 1, "device"), ("gpu", 8, "mesh"), ("cpu", 1, "host"),
     ("cpu", 8, "mesh")],
)
def test_select_backend_live_platforms(platform, ndev, want, monkeypatch):
    """'auto' on a batch above the threshold: one GPU runs the device
    path, several the mesh; a lone CPU stays on the native host cascade,
    a multi-device CPU runtime shards."""
    from sla_tpu.pipeline import DEVICE_MIN_ROW_SAMPLES, select_backend

    _policy_env(monkeypatch, (platform, ndev))
    assert select_backend("auto", DEVICE_MIN_ROW_SAMPLES) == want
    assert select_backend("auto", DEVICE_MIN_ROW_SAMPLES - 1) == "host"


def test_select_backend_never_starts_a_backend(monkeypatch):
    """No live JAX backend: 'auto' stays on the host whatever the size (a
    CUDA client would reserve most of the card for a host-only run)."""
    from sla_tpu.pipeline import select_backend

    _policy_env(monkeypatch, None)
    assert select_backend("auto", 1 << 40) == "host"


@pytest.mark.parametrize("configured", ["host", "device", "mesh"])
def test_select_backend_explicit(configured, monkeypatch):
    from sla_tpu.pipeline import select_backend

    _policy_env(monkeypatch, ("gpu", 1))
    assert select_backend(configured, 1) == configured


def test_select_backend_threshold_knob_and_no_native(monkeypatch):
    from sla_tpu.pipeline import select_backend

    _policy_env(monkeypatch, ("gpu", 1))
    monkeypatch.setenv("SLA_TPU_DEVICE_THRESHOLD", "1000")
    assert select_backend("auto", 999) == "host"
    assert select_backend("auto", 1000) == "device"
    monkeypatch.setenv("SLA_TPU_DEVICE_THRESHOLD", "junk")
    assert select_backend("auto", 999) == "host"
    monkeypatch.setattr(native, "available", lambda: False)
    assert select_backend("auto", 1) == "device"


@pytest.mark.parametrize(
    "config,env,want",
    [("auto", "", False), ("off", "", False), ("on", "", True),
     ("auto", "1", True), ("on", "off", False)],
)
def test_device_entropy_policy(config, env, want, monkeypatch):
    """The host coder by default on every backend (it measured faster);
    'on' asks for the device coder; SLA_TPU_DEVICE_ENTROPY overrides."""
    from sla_tpu.pipeline import device_entropy_on

    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", env)
    cfg = sla.EncoderConfig(device_entropy=config)
    assert device_entropy_on(cfg) is want


@pytest.mark.parametrize("env_dir", [None, "/somewhere/cache"])
def test_compile_cache_dir_rule(env_dir, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins (the program sets no path); without
    it the cache sits at a fixed directory inside the checkout."""
    import pathlib

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(pathlib.Path(sla.__file__).resolve().parent.parent / ".jax_cache")
        assert sla.compile_cache_dir() == want
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert sla.compile_cache_dir() is None
