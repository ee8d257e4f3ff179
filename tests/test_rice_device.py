"""Device entropy path: scan-coded symbol parts + host pack must be
byte-identical to the host recursive-Rice coder."""

import numpy as np
import pytest

import sla_tpu as sla
from sla_tpu import native, rice
from sla_tpu.rice_device import encode_block_payload_device

from .test_encode_decode import gen_wave

pytestmark = pytest.mark.skipif(not native.available(), reason="native build unavailable")


@pytest.mark.parametrize("scale", [20, 5000, 1 << 20, 1 << 30])
@pytest.mark.parametrize("channels", [1, 2, 8])
def test_device_payload_matches_host(scale, channels):
    rng = np.random.default_rng(scale % 97 + channels)
    N = int(rng.integers(500, 2500))
    data = rng.integers(-scale, scale, (channels, N)).astype(np.int32)
    init = rice.calculate_initial_params(list(data))
    assert encode_block_payload_device(data, init) == native.put_data_array(data, init)


def test_device_payload_golomb_branch_falls_back():
    """Tiny residuals select the static-Golomb branch (host path either way)."""
    rng = np.random.default_rng(0)
    data = rng.integers(-2, 3, (2, 1200)).astype(np.int32)
    init = rice.calculate_initial_params(list(data))
    assert encode_block_payload_device(data, init) == native.put_data_array(data, init)


def test_device_payload_extreme_values():
    data = np.array([[2**31 - 1, -(2**31), 0, 1, -1] * 300], dtype=np.int32)
    init = rice.calculate_initial_params(list(data))
    assert encode_block_payload_device(data, init) == native.put_data_array(data, init)


def test_encoder_with_device_entropy_env(monkeypatch):
    """Full encode with SLA_TPU_DEVICE_ENTROPY=1 stays byte-identical."""
    pcm = gen_wave("chirp", 15000, 2, 16, 0, seed=8)

    def encode():
        enc = sla.Encoder()
        enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(sla.PRESETS[1])
        return enc.encode_whole(pcm)

    base = encode()
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    assert encode() == base


def test_device_entropy_default_on_mesh_backend():
    """With the mesh filter backend the entropy symbols are coded on the
    host by default (the on-chip coder measured slower on an H100);
    device_entropy='on' attaches one batched on-device pass at filter
    time. Either way the stream stays byte-identical to the pure-host
    encode."""
    pcm = gen_wave("chirp", 30000, 2, 16, 0, seed=11)

    def encode(cfg):
        enc = sla.Encoder(cfg)
        enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(sla.PRESETS[2])
        blob = enc.encode_whole(pcm)
        return enc, blob

    _, host_blob = encode(sla.EncoderConfig(backend="host"))
    enc_mesh, mesh_blob = encode(sla.EncoderConfig(backend="mesh"))
    assert mesh_blob == host_blob
    assert not getattr(enc_mesh, "_device_entropy_active", False), (
        "the default should keep the host coder")
    enc_on, on_blob = encode(
        sla.EncoderConfig(backend="mesh", device_entropy="on"))
    assert on_blob == host_blob
    assert getattr(enc_on, "_device_entropy_active", False)


# ---- decode half (VERDICT r3 #3): on-chip recursive-Rice payload decode ----


def _host_payload_stream(rng, B, C, n_max, scale):
    """B recursive-Rice block payloads in one bitstream via the host coder
    (rice.put_recursive_rice), misaligned like real block payloads.
    Returns (data, offs, block_bits, counts, inits, expected)."""
    from sla_tpu.bitio import BitWriter
    from sla_tpu.rice import RiceState

    counts = rng.integers(1, n_max + 1, size=B).astype(np.int32)
    inits = np.zeros((B, C), dtype=np.uint32)
    w = BitWriter()
    w.put(0xAB, 8)
    w.put(3, 3)  # misalign: payload offsets are rarely byte-aligned
    offs, expected = [], []
    for b in range(B):
        n = int(counts[b])
        res = (
            rng.normal(0, scale, size=(C, n))
            .astype(np.int64)
            .clip(-(2**30), 2**30)
            .astype(np.int32)
        )
        ip = rice.calculate_initial_params([res[c] for c in range(C)])
        eff = [rice.effective_init_param(int(p)) for p in ip]
        if sum(eff) // C <= 8:  # force the recursive-Rice branch
            ip = [max(int(p), 40) for p in ip]
        inits[b] = ip
        offs.append(len(w._buf) * 8 + w._nacc)
        states = [RiceState(int(p)) for p in ip]
        for s in range(n):
            for ch in range(C):
                x = int(res[ch, s])
                rice.put_recursive_rice(
                    w, states[ch], (2 * x) if x >= 0 else (-2 * x - 1)
                )
        expected.append(res)
    w.flush()
    data = w.getvalue()
    bits = np.array(
        [(offs[b + 1] if b + 1 < B else len(data) * 8) - offs[b] for b in range(B)],
        dtype=np.int64,
    )
    return data, np.array(offs, dtype=np.int64), bits, counts, inits, expected


@pytest.mark.parametrize("channels,scale", [(1, 60), (2, 4000), (6, 200000), (8, 1 << 27)])
def test_device_decode_matches_host(channels, scale):
    """Batched on-chip decode == host get_recursive_rice, incl. the gamma
    escape (large scales), variable block lengths (frozen padded lanes),
    and channel-interleaved order (SLACoder.c:470-506 semantics)."""
    from sla_tpu.rice_device import decode_blocks_payload_device

    rng = np.random.default_rng(channels * 1000 + 17)
    n_max = 257
    data, offs, bits, counts, inits, expected = _host_payload_stream(
        rng, 7, channels, n_max, scale
    )
    res, bad = decode_blocks_payload_device(
        data, offs, bits, counts, inits, channels, n_max
    )
    res = np.asarray(res)
    assert not bad.any()
    for b in range(7):
        n = int(counts[b])
        assert np.array_equal(res[b, :, :n], expected[b]), b


def test_device_decode_flags_corrupt_payload():
    """A unary run past the escape threshold is impossible in a valid
    stream: the device decoder must flag the block (the decoder then
    re-decodes it on host for reference-identical corrupt behavior)."""
    from sla_tpu.rice_device import decode_blocks_payload_device

    rng = np.random.default_rng(5)
    data, offs, bits, counts, inits, _ = _host_payload_stream(rng, 2, 2, 64, 50)
    # zero a payload region: long zero runs read as quot > threshold
    data = bytearray(data)
    start = (int(offs[0]) >> 3) + 1
    data[start : start + 24] = b"\x00" * 24
    _, bad = decode_blocks_payload_device(
        bytes(data), offs, bits, counts, inits, 2, 64
    )
    assert bad[0]


def test_decoder_device_entropy_matches_host(monkeypatch):
    """Full decode with forced on-chip entropy (SLA_TPU_DEVICE_ENTROPY=1 +
    device synthesis backend) produces the exact host-path PCM."""
    pcm = gen_wave("chirp", 30000, 2, 16, 0, seed=21)
    enc = sla.Encoder()
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[2])
    blob = enc.encode_whole(pcm)
    _, host_pcm = sla.Decoder().decode_whole(blob)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    dec = sla.Decoder(sla.DecoderConfig(backend="device"))
    _, dev_pcm = dec.decode_whole(blob)
    assert np.array_equal(host_pcm, dev_pcm)
    assert np.array_equal(host_pcm, pcm)


def test_decoder_device_entropy_corrupt_falls_back_to_host(monkeypatch):
    """With CRC checking off, a corrupt payload must decode to the same
    deterministic garbage as the host path (the flagged block re-decodes
    on host), not device-lane garbage."""
    pcm = gen_wave("noise", 20000, 2, 16, 0, seed=22)
    enc = sla.Encoder()
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[2])
    blob = bytearray(enc.encode_whole(pcm))
    blob[len(blob) // 2] ^= 0xFF  # flip a payload byte mid-stream
    blob = bytes(blob)

    def decode(dev):
        cfg = sla.DecoderConfig(
            enable_crc_check=False, backend="device" if dev else "auto"
        )
        try:
            return sla.Decoder(cfg).decode_whole(blob)[1]
        except sla.SLAError as e:
            return repr(e)

    host = decode(False)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    dev = decode(True)
    if isinstance(host, str):
        assert host == dev
    else:
        assert np.array_equal(host, dev)


def test_decoder_device_entropy_forced_on_host_backend(monkeypatch):
    """SLA_TPU_DEVICE_ENTROPY=1 with the DEFAULT decoder (backend='auto'
    resolves to 'host' for small streams) is the documented force
    combination: the on-chip entropy batch must land once on host and feed
    the host synthesis cascade — regression for a crash where the device
    batch was dropped and the residuals stayed None."""
    pcm = gen_wave("chirp", 30000, 2, 16, 0, seed=23)
    enc = sla.Encoder()
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[2])
    blob = enc.encode_whole(pcm)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    _, out = sla.Decoder().decode_whole(blob)
    assert np.array_equal(out, pcm)


def test_decoder_device_entropy_mixed_golomb_group(monkeypatch):
    """A minority of static-Golomb blocks inside an otherwise loud stream
    must NOT knock the whole synthesis group off the on-chip entropy path:
    the stragglers re-decode on host and scatter into the device batch,
    and the PCM stays exact."""
    loud = gen_wave("noise", 50000, 2, 16, 0, seed=24)
    quiet = (np.random.default_rng(25).integers(-2, 3, size=(2, 12288))
             .astype(np.int32) << 16)
    pcm = np.concatenate([loud[:, :24576], quiet, loud[:, 24576:]], axis=1)
    enc = sla.Encoder()
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[2])
    blob = enc.encode_whole(pcm)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    dec = sla.Decoder(sla.DecoderConfig(backend="device"))
    header = dec._open_stream(blob)
    blocks = dec.scan_blocks(blob, header.num_samples)
    comp = [i for i, b in enumerate(blocks)
            if b.block_type == sla.BlockDataType.COMPRESSDATA]
    ep = header.encode_param
    grp_res = dec._device_entropy_group(
        blob, blocks, comp, ep.max_num_block_samples
    )
    from sla_tpu.rice import effective_init_param

    eff = [sum(effective_init_param(int(p)) for p in blocks[i].init_rice) // 2
           for i in comp]
    assert any(e <= 8 for e in eff), "fixture must contain a Golomb block"
    assert any(e > 8 for e in eff), "fixture must contain Rice blocks"
    assert grp_res is not None, "mixed group must stay on the device path"
    _, out = dec.decode_whole(blob)
    assert np.array_equal(out, pcm)


def test_device_entropy_env_value_parsing(monkeypatch):
    """SLA_TPU_DEVICE_ENTROPY=0 (or off/false/no) must force the path OFF —
    not force it on because the string '0' is truthy; unset/empty defers to
    the config."""
    from sla_tpu.pipeline import device_entropy_on

    cfg_auto = sla.DecoderConfig()
    cfg_off = sla.DecoderConfig(device_entropy="off")
    cfg_on = sla.DecoderConfig(device_entropy="on")
    for v in ("0", "off", "FALSE", "no"):
        monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", v)
        assert not device_entropy_on(cfg_on)
    for v in ("1", "on", "anything"):
        monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", v)
        assert device_entropy_on(cfg_off)
    for v in ("", "  "):
        monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", v)
        assert device_entropy_on(cfg_on)
        assert not device_entropy_on(cfg_auto)
        assert not device_entropy_on(cfg_off)


def test_decode_range_and_salvage_under_forced_device_entropy(monkeypatch):
    """decode_range and decode_salvage share _decode_blocks, so the forced
    on-chip entropy combination must leave their outputs sample-exact."""
    pcm = gen_wave("chirp", 60000, 2, 16, 0, seed=26)
    enc = sla.Encoder()
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[2])
    blob = enc.encode_whole(pcm)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    _, win = sla.Decoder().decode_range(blob, 15000, 20000)
    assert np.array_equal(win, pcm[:, 15000:35000])
    _, segs = sla.Decoder().decode_salvage(blob)
    assert len(segs) == 1 and segs[0].sample_offset == 0
    assert np.array_equal(segs[0].pcm, pcm)


def test_decoder_device_entropy_golomb_branch_falls_back(monkeypatch):
    """Quiet content selects the static-Golomb branch, which the device
    decoder does not implement: the group must fall back to the host coder
    and still decode exactly."""
    rng = np.random.default_rng(9)
    pcm = rng.integers(-2, 3, size=(2, 20000)).astype(np.int32) << 16
    enc = sla.Encoder()
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[2])
    blob = enc.encode_whole(pcm)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    dec = sla.Decoder(sla.DecoderConfig(backend="device"))
    _, out = dec.decode_whole(blob)
    assert np.array_equal(out, pcm)
