"""Mesh-sharded encode/decode on the 8-device virtual CPU mesh.

Matrix per VERDICT r3 item 7: channel_parallel x channels at the sharded
step level, rows not divisible by the mesh shape, mesh x segmented encode,
mesh decode, and the checkify-assert rejection/demotion paths — every test
asserts byte/bit identity against the unsharded or host path.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import sla_tpu as sla
from sla_tpu.errors import SLAError
from sla_tpu.parallel import (
    make_mesh,
    shard_batch,
    sharded_decode_step,
    sharded_encode_step,
)
from sla_tpu.pipeline import encode_filters, decode_stage


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _inputs(NB, NC, L, p, T, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(-(1 << 10), 1 << 10, (NB, NC, L), dtype=np.int32)
    coef = rng.integers(-(1 << 14), 1 << 14, (NB, NC, p), dtype=np.int32)
    pitch = rng.integers(0, 64, (NB, NC), dtype=np.int32)
    ltm = (rng.integers(-(1 << 14), 1 << 14, (NB, NC, T), dtype=np.int64) << 16).astype(
        np.int32
    )
    return data, coef, pitch, ltm


def _pcm(C, n, seed=3, width=16):
    """C-channel test signal in canonical left-justified int32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    chans = [
        0.25 * np.sin(2 * np.pi * (200 + 90 * c) * t / 44100.0)
        + rng.normal(0, 0.01, n)
        for c in range(C)
    ]
    full = (1 << (width - 1)) - 1
    pcm = np.clip(np.stack(chans) * full, -full - 1, full).astype(np.int32)
    return pcm << (32 - width)


def _encode(pcm, backend, width=16, preset=2):
    C = pcm.shape[0]
    ep = sla.PRESETS[preset]
    if C != 2:
        ep = sla.EncodeParameter(
            ep.parcor_order, ep.longterm_order, ep.lms_order_per_filter,
            sla.ChannelProcessMethod.NONE, ep.window_function_type,
            ep.max_num_block_samples,
        )
    enc = sla.Encoder(sla.EncoderConfig(backend=backend))
    enc.set_wave_format(sla.WaveFormat(C, width, 44100))
    enc.set_encode_parameter(ep)
    return enc.encode_whole(pcm)


# ---- sharded step level: channel_parallel x channels ------------------------

# every (channel_parallel, num_channels) combo with NC divisible by the
# channel axis (shard_map requires exact tiling; the full-pipeline encoder
# pads its batch instead — covered below)
@needs_8
@pytest.mark.parametrize(
    "channel_parallel,NC",
    [(1, 1), (1, 2), (1, 6), (1, 8), (2, 2), (2, 6), (2, 8), (4, 8)],
)
def test_sharded_step_matrix(channel_parallel, NC):
    mesh = make_mesh(jax.devices()[:8], channel_parallel=channel_parallel)
    p, T, M = 8, 1, 4
    NB, L = 2 * mesh.shape["blocks"], 256
    data, coef, pitch, ltm = _inputs(NB, NC, L, p, T, seed=NC)
    d = shard_batch(mesh, data, coef, ltm)
    d_pitch = shard_batch(mesh, pitch[..., None])[0][..., 0]
    res, abs_sum, gmax = sharded_encode_step(d[0], d[1], d_pitch, d[2], p, T, M, mesh)
    ref = np.asarray(
        encode_filters(
            jnp.asarray(data.reshape(NB * NC, L)),
            jnp.asarray(coef.reshape(NB * NC, p)),
            jnp.asarray(pitch.reshape(NB * NC)),
            jnp.asarray(ltm.reshape(NB * NC, T)),
            p, T, M,
        )
    )
    assert np.array_equal(np.asarray(res).reshape(NB * NC, L), ref)
    assert np.isfinite(float(np.asarray(gmax)))
    # decode mirror: sharded synthesis inverts the sharded residual exactly
    pcm = sharded_decode_step(res, d[1], d_pitch, d[2], p, T, M, mesh)
    assert np.array_equal(np.asarray(pcm), data)
    # and matches the unsharded synthesis of the same residual
    dec_ref = np.asarray(
        decode_stage(
            jnp.asarray(np.asarray(res).reshape(NB * NC, L)),
            jnp.asarray(coef.reshape(NB * NC, p)),
            jnp.asarray(pitch.reshape(NB * NC)),
            jnp.asarray(ltm.reshape(NB * NC, T)),
            p, T, M,
        )
    )
    assert np.array_equal(np.asarray(pcm).reshape(NB * NC, L), dec_ref)


# ---- full pipeline: mesh encode byte-identical to host ----------------------

@needs_8
@pytest.mark.parametrize("C", [2, 6])
def test_mesh_encode_byte_identical(C):
    # 3 blocks of rows: C * 3 rows is NOT a multiple of the 8-device block
    # axis for either C — exercises the encoder's internal batch padding
    pcm = _pcm(C, 30000, seed=C)
    assert _encode(pcm, "mesh") == _encode(pcm, "host")


@needs_8
def test_mesh_encode_single_block_row_padding(C=1):
    # one mono block: 1 row on an 8-device mesh (maximal padding)
    pcm = _pcm(1, 9000)
    assert _encode(pcm, "mesh") == _encode(pcm, "host")


@needs_8
def test_mesh_segmented_encode_byte_identical(monkeypatch):
    # rolling-window segmented encode (SLA_TPU_SEGMENT_SAMPLES) on the mesh
    # backend: segment boundaries must not change a single byte
    pcm = _pcm(2, 61000, seed=11)
    monkeypatch.setenv("SLA_TPU_SEGMENT_SAMPLES", "24576")
    seg = _encode(pcm, "mesh")
    monkeypatch.delenv("SLA_TPU_SEGMENT_SAMPLES")
    assert seg == _encode(pcm, "host")


# ---- full pipeline: mesh decode ---------------------------------------------

@needs_8
@pytest.mark.parametrize("C", [2, 6])
def test_mesh_decode_pcm_exact(C):
    pcm = _pcm(C, 30000, seed=20 + C)
    blob = _encode(pcm, "host")
    dec = sla.Decoder(sla.DecoderConfig(backend="mesh"))
    _, out = dec.decode_whole(blob)
    assert np.array_equal(out, pcm)


# ---- checkify assert mode ----------------------------------------------------

@needs_8
def test_assert_mode_rejected_on_sharded_step(monkeypatch):
    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    mesh = make_mesh(jax.devices()[:8])
    p, T, M = 8, 1, 4
    NB, NC, L = 2 * mesh.shape["blocks"], 1, 64
    data, coef, pitch, ltm = _inputs(NB, NC, L, p, T)
    d = shard_batch(mesh, data, coef, ltm)
    d_pitch = shard_batch(mesh, pitch[..., None])[0][..., 0]
    with pytest.raises(SLAError):
        sharded_encode_step(d[0], d[1], d_pitch, d[2], p, T, M, mesh)


@needs_8
def test_assert_mode_demotes_mesh_encoder(monkeypatch):
    # the encoder demotes backend='mesh' to the checkified single-device
    # path instead of raising; bytes must still match the host path
    pcm = _pcm(2, 15000, seed=31)
    host = _encode(pcm, "host")
    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    assert _encode(pcm, "mesh") == host


@needs_8
@pytest.mark.parametrize("C", [2, 6])
def test_mesh_decode_device_entropy_contrast(C):
    """backend='mesh' with DecoderConfig.device_entropy='on' decodes the
    recursive-Rice payloads ON the mesh; pin both sides of the contrast —
    on-mesh entropy and host entropy must produce the exact PCM."""
    pcm = _pcm(C, 30000, seed=40 + C)
    blob = _encode(pcm, "host")
    _, on = sla.Decoder(
        sla.DecoderConfig(backend="mesh", device_entropy="on")
    ).decode_whole(blob)
    _, off = sla.Decoder(
        sla.DecoderConfig(backend="mesh", device_entropy="off")
    ).decode_whole(blob)
    assert np.array_equal(on, pcm)
    assert np.array_equal(off, pcm)


# ---- channel-parallel meshes at the full-pipeline level ----------------------

@needs_8
def test_mesh_encode_channel_parallel_byte_identical(monkeypatch):
    """C=6 stream on a ('blocks'=4, 'channels'=2) mesh: each block's six
    channel rows split 3+3 over the channel axis; bytes must equal host."""
    pcm = _pcm(6, 30000, seed=61)
    host = _encode(pcm, "host")
    monkeypatch.setenv("SLA_TPU_MESH_CHANNELS", "2")
    assert _encode(pcm, "mesh") == host


@needs_8
def test_mesh_decode_channel_parallel_pcm_exact(monkeypatch):
    pcm = _pcm(6, 30000, seed=62)
    blob = _encode(pcm, "host")
    monkeypatch.setenv("SLA_TPU_MESH_CHANNELS", "2")
    dec = sla.Decoder(sla.DecoderConfig(backend="mesh"))
    _, out = dec.decode_whole(blob)
    assert np.array_equal(out, pcm)


@needs_8
def test_mesh_channel_parallel_indivisible_falls_back(monkeypatch):
    """C=3 cannot split over a 2-wide channel axis: the pipeline must fall
    back to pure block parallelism and stay byte/PCM-exact."""
    pcm = _pcm(3, 24000, seed=63)
    host = _encode(pcm, "host")
    monkeypatch.setenv("SLA_TPU_MESH_CHANNELS", "2")
    assert _encode(pcm, "mesh") == host
    dec = sla.Decoder(sla.DecoderConfig(backend="mesh"))
    _, out = dec.decode_whole(host)
    assert np.array_equal(out, pcm)


# ---- mesh x random access / salvage / long-stream grouping -------------------

@needs_8
def test_mesh_decode_range_exact():
    """decode_range on the mesh backend: indexed window == host window ==
    the decode_whole slice."""
    pcm = _pcm(2, 50000, seed=64)
    blob = _encode(pcm, "host")
    dm = sla.Decoder(sla.DecoderConfig(backend="mesh"))
    idx = dm.build_index(blob)
    for start, count in [(0, 5000), (12288, 12288), (20000, 25000), (49990, 100)]:
        _, win = dm.decode_range(blob, start, count, index=idx)
        want = pcm[:, start : min(start + count, 50000)]
        assert np.array_equal(win, want), (start, count)


@needs_8
def test_mesh_decode_salvage_matches_host():
    """decode_salvage on the mesh backend recovers the same segments as the
    host backend (same resync points, bit-exact PCM)."""
    pcm = _pcm(2, 60000, seed=65)
    blob = bytearray(_encode(pcm, "host"))
    blob[len(blob) // 2] ^= 0xFF  # corrupt one mid-stream block
    blob = bytes(blob)
    _, segs_host = sla.Decoder(sla.DecoderConfig(backend="host")).decode_salvage(blob)
    _, segs_mesh = sla.Decoder(sla.DecoderConfig(backend="mesh")).decode_salvage(blob)
    assert len(segs_host) == len(segs_mesh) >= 1
    for a, b in zip(segs_host, segs_mesh):
        assert a.byte_offset == b.byte_offset
        assert a.gap_before_bytes == b.gap_before_bytes
        assert a.sample_offset == b.sample_offset
        assert np.array_equal(a.pcm, b.pcm)


@needs_8
def test_mesh_segmented_long_stream_decode(monkeypatch):
    """Mesh decode over bounded synthesis groups (the long-stream path):
    force tiny groups so one stream spans several mesh dispatches."""
    import sla_tpu.decoder as dmod

    pcm = _pcm(2, 8 * 12288, seed=66)
    blob = _encode(pcm, "host")
    monkeypatch.setattr(dmod, "_synth_group_rows", lambda C, L: 2 * C)
    dec = sla.Decoder(sla.DecoderConfig(backend="mesh"))
    _, out = dec.decode_whole(blob)
    assert np.array_equal(out, pcm)


@needs_8
@pytest.mark.parametrize("channel_parallel,NC", [(1, 1), (2, 2)])
def test_mesh_bodies_gpu_kernels_match_scan(channel_parallel, NC, monkeypatch):
    """On a GPU mesh every shard runs the single-device GPU kernels: with
    the platform patched to 'gpu' and the kernels in interpret mode, the
    sharded stages must equal the scan bodies bit for bit, across
    block-only and channel-split meshes."""
    from sla_tpu import pipeline
    from sla_tpu.kernels import gpu_filters as g
    from sla_tpu.parallel import sharded_encode_stage1, sharded_encode_stage2

    mesh = make_mesh(jax.devices()[:8], channel_parallel=channel_parallel)
    p, T, M = 8, 3, 4
    NB, L = 2 * mesh.shape["blocks"], 256
    data, coef, _, ltm = _inputs(NB, NC, L, p, T, seed=11)
    pitch = np.random.default_rng(7).integers(3, 200, (NB, NC), dtype=np.int32)
    pitch[0, 0] = 0  # long-term off inside an otherwise-active shard
    d_data, d_coef, d_ltm = shard_batch(mesh, data, coef, ltm)
    d_pitch = shard_batch(mesh, pitch)[0]

    r1_ref = sharded_encode_stage1(d_data, d_coef, p, mesh)
    r2_ref = sharded_encode_stage2(r1_ref, d_pitch, d_ltm, T, M, mesh)

    for name in ("stage1", "stage2", "synth"):
        orig = getattr(g, name)

        def interp(*a, _o=orig, **k):
            return _o(*a, interpret=True, **k)

        monkeypatch.setattr(g, name, interp)
    monkeypatch.setattr(pipeline, "filter_impl", lambda platform: "kernel")
    monkeypatch.setattr(pipeline, "DISPATCH", pipeline.DISPATCH.__class__())

    r1 = sharded_encode_stage1(d_data, d_coef, p, mesh)
    assert np.array_equal(np.asarray(r1), np.asarray(r1_ref))
    r2 = sharded_encode_stage2(r1, d_pitch, d_ltm, T, M, mesh)
    assert np.array_equal(np.asarray(r2), np.asarray(r2_ref))
    pcm = sharded_decode_step(r2, d_coef, d_pitch, d_ltm, p, T, M, mesh)
    assert np.array_equal(np.asarray(pcm), data)
    assert dict(pipeline.DISPATCH) == {
        ("stage1", "kernel"): 1, ("stage2", "kernel"): 1, ("synth", "kernel"): 1,
    }
