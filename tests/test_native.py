"""Native C++ entropy stage vs the pure-Python semantic reference.

The native module (sla_tpu/native/sla_native.cpp) must produce bit-identical
payloads to sla_tpu.rice / sla_tpu.bitio, which in turn interoperate with the
reference binary (test_differential.py)."""

import pathlib

import numpy as np
import pytest

from sla_tpu import native, rice
from sla_tpu.bitio import BitReader, BitWriter, zigzag_encode_array
from sla_tpu.crc16 import _TABLE  # noqa: F401  (keeps pure table importable)


pytestmark = pytest.mark.skipif(not native.available(), reason="native build unavailable")


@pytest.mark.parametrize("scale", [1, 4, 40, 5000, 1 << 20, 1 << 30])
@pytest.mark.parametrize("channels", [1, 2, 8])
def test_data_array_matches_python(scale, channels):
    rng = np.random.default_rng(scale * 31 + channels)
    N = int(rng.integers(500, 4000))
    data = rng.integers(-scale, scale, (channels, N)).astype(np.int32)
    init = rice.calculate_initial_params(list(data))
    assert native.initial_params(data) == init

    w = BitWriter()
    rice.put_data_array(w, init, list(data), N)
    w.flush()
    assert native.put_data_array(data, init) == w.getvalue()

    out = native.get_data_array(w.getvalue(), 0, channels, N, init)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("channels", [1, 2, 3, 5, 8])
def test_batched_decode_multichannel_lanes(channels):
    """get_data_arrays' 8-lane vector path now covers C=1..8; runs of
    eight adaptive blocks ride the lanes (incl. the mid-sample cache
    top-up for C>=3), the remainder takes the serial path, and the
    strided variant lands short tail blocks at row stride L natively."""
    rng = np.random.default_rng(97 + channels)
    W = 19  # two full v8 runs + 3 serial blocks
    ns = rng.integers(700, 1400, W).astype(np.int32)
    ns[-1] = 137  # short tail, exercises the strided scalar fallback
    blocks = [
        rng.integers(-3000, 3000, (channels, int(n))).astype(np.int32)
        for n in ns
    ]
    inits, payloads = [], []
    for blk in blocks:
        init = rice.calculate_initial_params(list(blk))
        inits.append(init)
        payloads.append(native.put_data_array(blk, init))
    sizes = np.array([len(p) for p in payloads], dtype=np.int64)
    offs = np.zeros(W, dtype=np.int64)
    np.cumsum(sizes[:-1] * 8, out=offs[1:])
    stream = b"".join(payloads)
    init_arr = np.array(inits, dtype=np.uint32).reshape(W, channels)

    outs = native.get_data_arrays(stream, offs, ns, init_arr)
    for got, want in zip(outs, blocks):
        assert np.array_equal(got, want)

    L = int(ns.max())
    _, views = native.get_data_arrays_strided(stream, offs, ns, init_arr, L)
    for got, want in zip(views, blocks):
        assert np.array_equal(got, want)


def test_data_array_nonaligned_offset():
    """Payload parked mid-stream at a byte-aligned but nonzero offset."""
    rng = np.random.default_rng(0)
    data = rng.integers(-100, 100, (2, 777)).astype(np.int32)
    init = rice.calculate_initial_params(list(data))
    payload = native.put_data_array(data, init)
    stream = b"\xAB\xCD\xEF" + payload
    out = native.get_data_array(stream, 24, 2, 777, init)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("bits", [[3], [17, 18], [8, 9, 8, 9, 8, 9, 8, 9]])
def test_raw_roundtrip(bits):
    rng = np.random.default_rng(len(bits))
    C = len(bits)
    N = 513
    data = np.stack(
        [rng.integers(-(1 << (b - 1)), 1 << (b - 1), N).astype(np.int32) for b in bits]
    )
    blob = native.put_raw(data, bits)
    # python cross-check: interleaved zigzag at per-channel widths
    w = BitWriter()
    zz = [zigzag_encode_array(data[ch]) for ch in range(C)]
    for s in range(N):
        for ch in range(C):
            w.put(int(zz[ch][s]), bits[ch])
    w.flush()
    assert blob == w.getvalue()
    out = native.get_raw(blob, 0, C, N, bits)
    assert np.array_equal(out, data)


def test_crc16_matches_table(a_wav):
    blob = a_wav.read_bytes()
    # golden value from the reference test suite (test_SLAUtility.c:71)
    assert native.crc16(np.frombuffer(blob, dtype=np.uint8)) == 0xA611


def test_bulk_header_parse_matches_python():
    """native.parse_block_headers == Decoder.parse_block_header per block."""
    import sla_tpu as sla
    from .test_encode_decode import gen_wave

    pcm = gen_wave("chirp", 30000, 2, 16, 0, seed=12)
    enc = sla.Encoder()
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[2])
    blob = enc.encode_whole(pcm)
    hdr, _ = sla.decode_header(blob)
    dec = sla.Decoder()
    dec.set_wave_format(hdr.wave_format)
    dec.set_encode_parameter(hdr.encode_param)
    res = native.parse_block_headers(
        blob, 43, hdr.num_samples, 2, hdr.encode_param.parcor_order,
        hdr.encode_param.longterm_order, 16, True,
    )
    assert res["error"] == 0 and res["num_blocks"] == hdr.num_blocks
    offset = 43
    for i in range(res["num_blocks"]):
        blk = dec.parse_block_header(blob, offset)
        assert res["offsets"][i] == offset
        assert res["sizes"][i] == blk.block_size
        assert res["num_samples"][i] == blk.num_samples
        assert res["types"][i] == int(blk.block_type)
        assert res["payload_bits"][i] == blk.payload_bit_offset
        if blk.parcor_coef is not None:
            assert np.array_equal(res["coef"][i], blk.parcor_coef)
            assert np.array_equal(res["pitch"][i], blk.pitch)
            assert np.array_equal(res["ltm"][i], blk.ltm_coef)
            assert [int(v) for v in res["init_rice"][i]] == blk.init_rice
        offset += blk.block_size


def test_golomb_low_param_path():
    """Payload with tiny residuals exercises the static Golomb branch
    (mean initial param <= 8, SLACoder.c:450-466)."""
    rng = np.random.default_rng(5)
    data = rng.integers(-2, 3, (2, 1500)).astype(np.int32)
    init = rice.calculate_initial_params(list(data))
    eff = [rice.effective_init_param(p) for p in init]
    assert sum(eff) // 2 <= 8  # sanity: hits the Golomb path
    w = BitWriter()
    rice.put_data_array(w, init, list(data), 1500)
    w.flush()
    assert native.put_data_array(data, init) == w.getvalue()
    assert np.array_equal(native.get_data_array(w.getvalue(), 0, 2, 1500, init), data)


def test_native_scratch_capacity_checks():
    """C-side entry points validate caller-supplied sizes instead of
    trusting Python config defaults (stack scratch arrays)."""
    data = np.zeros((65, 4), dtype=np.int32)
    with pytest.raises(ValueError):
        native.put_data_array(data, [1] * 65)
    with pytest.raises(ValueError):
        native.get_data_array(b"\x00" * 64, 0, 65, 4, [1] * 65)
    # span_autocorr scratch holds 2*S boundaries, capacity 4096
    sig = np.zeros((1, 8192), dtype=np.float64)
    positions = np.arange(0, 8192, 2, dtype=np.int64)
    nv = positions.size
    spans = np.stack(
        [np.zeros(2049, dtype=np.int64), np.full(2049, nv - 1, dtype=np.int64)], axis=1
    )
    with pytest.raises(ValueError):
        native.span_autocorr(sig, positions, spans, 4)


def test_lpc_analyze_rows_order_bound():
    data = np.zeros((2, 128), dtype=np.float64)
    with pytest.raises(ValueError):
        native.lpc_analyze_rows(data, 65, 16)


def test_hostref_zero_run_matches_native():
    """The pure-Python zero-fill reader must count over-read zero runs
    exactly like the native BitReader (run to real end, pos = total + 1)."""
    from sla_tpu.hostref import _ZeroFillReader

    r = _ZeroFillReader(b"\x00", 0)
    assert r.get_zero_run() == 8
    assert r._bitpos == 9  # over-read marker
    r2 = _ZeroFillReader(b"\x00\x20", 0)
    assert r2.get_zero_run() == 10  # zeros up to the 1 bit at position 10
    assert r2._bitpos == 11


def test_convert_ms_matches_numpy():
    """Fused native conversion == the NumPy reference path, MS and plain,
    including int32 wrap on the side channel and the exact double scale."""
    from sla_tpu.dsp.channel import lr_to_ms_double, lr_to_ms_int32

    rng = np.random.default_rng(11)
    data = rng.integers(-(1 << 31), 1 << 31, (2, 777), dtype=np.int64).astype(np.int32)
    data[:, :5] = np.array([[2**31 - 1, -(2**31), 1, -1, 0]] * 2, dtype=np.int32)
    for ms in (False, True):
        for sa, sb in ((16, 16), (16, 20), (8, 0)):
            out_a, out_b, out_d = native.convert_ms(data, sa, sb, ms=ms)
            ref_a = (data >> sa).astype(np.int32)
            ref_b = (data >> sb).astype(np.int32)
            ref_d = data.astype(np.float64) * 2.0**-31
            if ms:
                ref_a[0], ref_a[1] = lr_to_ms_int32(ref_a[0], ref_a[1])
                ref_b[0], ref_b[1] = lr_to_ms_int32(ref_b[0], ref_b[1])
                ref_d[0], ref_d[1] = lr_to_ms_double(ref_d[0], ref_d[1])
            assert np.array_equal(out_a, ref_a)
            if sa == sb:
                assert out_b is None
            else:
                assert np.array_equal(out_b, ref_b)
            assert np.array_equal(out_d, ref_d)
    # MS demands exactly 2 channels
    with pytest.raises(ValueError):
        native.convert_ms(np.zeros((3, 8), np.int32), 16, ms=True)


def test_span_autocorr_multi_matches_single():
    """The batched multi-window call must match per-window span_autocorr
    calls: bit-exactly on the per-lag variant (order > 19), and to float-
    association precision on the one-pass FMA variant (order <= 19) —
    whose drift the partition near-tie guard dwarfs by ~10 orders."""
    from sla_tpu.analysis.partition import _window_geometry

    rng = np.random.default_rng(3)
    C, N, wl = 2, 4 * 4096, 4096
    base = rng.normal(0, 0.2, (C, N))
    V, positions, spans, _sl = _window_geometry(wl, 2048, wl, 1024)
    offs = np.array([0, 4096, 8192, 12288], dtype=np.int64)
    # per-lag variant: exact
    multi25 = native.span_autocorr_multi(base, offs, wl, positions, spans, 25)
    for w, off in enumerate(offs):
        single = native.span_autocorr(base[:, off : off + wl], positions, spans, 25)
        assert np.array_equal(multi25[w], single)
    # one-pass variant: same sums to association precision
    multi8 = native.span_autocorr_multi(base, offs, wl, positions, spans, 8)
    for w, off in enumerate(offs):
        single = native.span_autocorr(base[:, off : off + wl], positions, spans, 8)
        np.testing.assert_allclose(multi8[w], single, rtol=1e-11, atol=1e-9)


def test_threaded_entropy_stages_match_serial(monkeypatch):
    """SLA_TPU_THREADS>1 shards block serialization/decode across worker
    threads; outputs must equal the serial path byte for byte (this host
    has one core, so this exercises correctness, not speed)."""
    import os
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "sys.path.insert(0, %r)\n"
        "import numpy as np\n"
        "import sla_tpu as sla\n"
        "from test_encode_decode import gen_wave\n"
        "pcm = gen_wave('chirp', 120000, 2, 16, 0, seed=21)\n"
        "enc = sla.Encoder()\n"
        "enc.set_wave_format(sla.WaveFormat(2, 16, 44100))\n"
        "enc.set_encode_parameter(sla.PRESETS[2])\n"
        "blob = enc.encode_whole(pcm)\n"
        "dec = sla.Decoder()\n"
        "_, out = dec.decode_whole(blob)\n"
        "assert np.array_equal(out, pcm)\n"
        "sys.stdout.buffer.write(blob)\n"
    ) % (str(pathlib.Path(__file__).resolve().parent.parent),
         str(pathlib.Path(__file__).resolve().parent))
    outs = {}
    for threads in ("1", "4"):
        env = dict(os.environ)
        env["SLA_TPU_THREADS"] = threads
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, timeout=300)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        outs[threads] = r.stdout
    assert outs["1"] == outs["4"] and len(outs["1"]) > 1000


def test_threaded_filter_cascades_byte_identical(monkeypatch):
    """SLA_TPU_THREADS>1 threads the row-group filter cascades (stage1,
    stage2, synthesis) over a pool; disjoint outputs + GIL-released ctypes
    calls make any schedule byte-identical to the serial loop."""
    import numpy as np

    import sla_tpu as sla
    from tests.test_encode_decode import gen_wave

    pcm = gen_wave("chirp", 60000, 2, 16, 0, seed=77)

    def run():
        enc = sla.Encoder(sla.EncoderConfig(backend="host"))
        enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(sla.PRESETS[2])
        blob = enc.encode_whole(pcm)
        dec = sla.Decoder(sla.DecoderConfig(backend="host"))
        return blob, dec.decode_whole(blob)[1]

    monkeypatch.delenv("SLA_TPU_THREADS", raising=False)
    base_blob, base_pcm = run()
    monkeypatch.setenv("SLA_TPU_THREADS", "4")
    blob4, pcm4 = run()
    assert blob4 == base_blob
    assert np.array_equal(pcm4, base_pcm)


def test_synth_rows_fused_matches_unfused():
    """synth_rows_fused (lattice store straight into the PCM buffer with MS
    inverse + shift fused) must equal synth_rows followed by the NumPy MS
    inverse + shift — including mixed-length lane groups, singles, and the
    leftover scatter, across channel counts and orders."""
    import numpy as np

    from sla_tpu import native
    from sla_tpu.dsp.channel import ms_to_lr_int32

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    for trial, (C, p, T, M, ms, shift, nblocks) in enumerate([
        (2, 16, 1, 8, True, 16, 9),     # CD preset-2 shape
        (2, 32, 5, 8, True, 8, 3),      # preset-4 orders
        (1, 8, 1, 4, False, 24, 5),     # mono preset-0
        (6, 16, 1, 8, False, 8, 4),     # 5.1
        (2, 16, 1, 8, True, 0, 17),     # pool/singles stress (odd lengths)
    ]):
        L = 4096
        lens_blocks = rng.integers(64, L + 1, nblocks)
        if trial == 4:  # force many distinct lengths -> mixed groups + tail
            lens_blocks = rng.integers(64, 512, nblocks)
        B = nblocks * C
        lengths = np.repeat(lens_blocks, C).astype(np.int64)
        residual = rng.integers(-(2**15), 2**15, (B, L)).astype(np.int32)
        coef = rng.integers(-32768, 32768, (B, p)).astype(np.int32)
        pitch = rng.choice([0, 40, 120, 255], B).astype(np.int32)
        ltm = rng.integers(-(2**30), 2**30, (B, T)).astype(np.int32)
        N = int(lens_blocks.sum())
        # unfused reference: synth_rows + NumPy MS inverse + shift
        ref_rows = native.synth_rows(
            residual.copy(), coef, pitch, ltm, T, M, lengths
        )
        want = np.empty((C, N), dtype=np.int32)
        off = 0
        for bi, n in enumerate(lens_blocks):
            rows = ref_rows[bi * C : (bi + 1) * C, :n]
            if ms:
                left, right = ms_to_lr_int32(rows[0], rows[1])
                rows = np.stack([left, right])
            with np.errstate(over="ignore"):
                want[:, off : off + n] = rows << np.int32(shift)
            off += n
        # fused path
        got = np.full((C, N), -12345, dtype=np.int32)
        dest_offs = np.zeros(B, dtype=np.int64)
        off = 0
        for bi, n in enumerate(lens_blocks):
            for ch in range(C):
                dest_offs[bi * C + ch] = ch * N + off
            off += int(n)
        native.synth_rows_fused(
            residual.copy(), coef, pitch, ltm, T, M, lengths,
            got, dest_offs, ms, shift,
        )
        assert np.array_equal(got, want), (trial, C, p, ms)


def test_i32_source_fills_match_materialized():
    """The int32-source partition sweep and analysis fill must produce
    BIT-identical float64 results to the materialized-double calls (the
    conversion steps are exact, so this is equality, not tolerance)."""
    import numpy as np

    from sla_tpu import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(21)
    for ms in (False, True):
        C = 2
        N = 40960
        data = (rng.integers(-(2**15), 2**15, (C, N)).astype(np.int32) << 16)
        dbl = data.astype(np.float64) * 2.0**-31
        if ms:
            dbl[0], dbl[1] = (dbl[0] + dbl[1]) / 2.0, dbl[0] - dbl[1]
        win_len = 12288
        offs = np.asarray([0, 12288, 24576], dtype=np.int64)
        V = win_len // 1024 + 1
        positions = np.minimum(np.arange(V) * 1024, win_len).astype(np.int64)
        ii, jj = np.triu_indices(V, k=1)
        spans = np.stack([ii, jj], axis=1).astype(np.int64)
        for order in (16, 32):  # onepass and per-lag variants
            R_dbl = native.span_autocorr_multi(
                dbl, offs, win_len, positions, spans, order
            )
            R_i32 = native.span_autocorr_multi_i32(
                data, ms, offs, win_len, positions, spans, order
            )
            assert np.array_equal(R_dbl, R_i32), (ms, order)
        # analysis fill: mid/side (or raw) rows with window + emphasis
        from sla_tpu.native import make_window

        n = 8192
        window = make_window(2, n)  # hann-ish; any type works
        boffs = np.asarray([0, 8192, 16384, 24576], dtype=np.int64)
        if ms:
            offs_rows = np.repeat(boffs, C)
            modes = np.asarray([1, 2] * len(boffs), dtype=np.int32)
            dbl_offs = np.asarray(
                [ch * N + o for o in boffs for ch in range(C)], dtype=np.int64
            )
        else:
            offs_rows = np.asarray(
                [ch * N + o for o in boffs for ch in range(C)], dtype=np.int64
            )
            modes = np.zeros(len(boffs) * C, dtype=np.int32)
            dbl_offs = offs_rows
        pc_d, len_d = native.lpc_analyze_rows_at(
            dbl, dbl_offs, n, 16, 16, window=window, emphasis=True
        )
        pc_i, len_i = native.lpc_analyze_rows_at_i32(
            data, offs_rows, modes, n, 16, 16, window=window, emphasis=True
        )
        assert np.array_equal(pc_d, pc_i) and np.array_equal(len_d, len_i), ms


def test_stage1_rows_at_matches_batch():
    """In-place stage-1 input rows must equal the assembled-batch kernel."""
    import numpy as np

    from sla_tpu import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(22)
    C, N, L = 2, 50000, 4096
    base = rng.integers(-(2**15), 2**15, (C, N)).astype(np.int32)
    boffs = [0, 4096, 8192, 12288, 20000, 30000]  # last two: short rows
    lens_b = [4096, 4096, 4096, 4096, 3000, 1500]
    B = len(boffs) * C
    lengths = np.repeat(lens_b, C).astype(np.int64)
    coefs = rng.integers(-32768, 32768, (B, 16)).astype(np.int32)
    offs = np.asarray(
        [ch * N + o for o in boffs for ch in range(C)], dtype=np.int64
    )
    batch = np.zeros((B, L), dtype=np.int32)
    for b in range(B):
        batch[b, : lengths[b]] = base.reshape(-1)[offs[b] : offs[b] + lengths[b]]
    want = native.predict_stage1_rows(batch, coefs, lengths)
    got = native.predict_stage1_rows_at(base, offs, coefs, lengths, L)
    assert np.array_equal(want, got)


def test_partial_read_overrun_marker():
    """Over-reading a truncated payload must terminate with the cursor past
    the end (the INSUFFICIENT_DATA_SIZE signal upstream), never crash — a
    prior escape can leave the reader in the over-read marker state and the
    NEXT channel's fast-path attempt must reject it (the UBSan-found
    ncache=-1 shift, sla_native.cpp try_sym_regs guard)."""
    if not native.available():
        pytest.skip("native library unavailable")
    for C in (1, 2, 6):
        cur = native.PayloadCursor([5] * C, C, 0)
        buf = np.frombuffer(b"\xa7\x01\x33", dtype=np.uint8)
        out = cur.read(buf, 400)
        assert out.shape == (C, 400)
        assert int(cur.bit_pos.value) > 8 * buf.size  # over-read surfaced


def test_concurrent_first_load_single_build(tmp_path, monkeypatch):
    """Concurrent first-touch from many threads must produce one usable
    library (the build/load section is serialized; the .so publishes
    atomically)."""
    import concurrent.futures as cf
    import os

    from sla_tpu import native as nat

    if not nat.available():
        pytest.skip("needs a toolchain")
    # force the next _load to rebuild: reset module state and backdate the .so
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_load_failed", False)
    lib_path = nat._LIB
    old = lib_path.stat().st_mtime
    os.utime(lib_path, (old - 10_000, old - 10_000))
    with cf.ThreadPoolExecutor(8) as ex:
        results = list(ex.map(lambda _: nat.crc16(b"123456789"), range(8)))
    assert all(r == results[0] for r in results)
    assert nat.available()


def test_malformed_device_threshold_falls_back(monkeypatch):
    from sla_tpu.pipeline import select_backend

    monkeypatch.setenv("SLA_TPU_DEVICE_THRESHOLD", "16e6")
    assert select_backend("auto", 1000) in ("host", "device", "mesh")


def test_native_wrappers_reject_bad_geometry():
    """The Python wrappers must reject what the native kernels reject
    (num_taps > 8) instead of returning partial/uninitialized output, and
    must surface any nonzero native return code."""
    import numpy as np
    import pytest
    from sla_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    res = np.zeros((2, 64), dtype=np.int32)
    coef = np.zeros((2, 8), dtype=np.int32)
    pitch = np.full(2, 50, dtype=np.int32)
    ltm = np.zeros((2, 9), dtype=np.int32)
    with pytest.raises(ValueError):
        native.synth_rows(res, coef, pitch, ltm, num_taps=9, lms_order=8)
    with pytest.raises(ValueError):
        native.predict_stage2_rows(res, pitch, ltm, 9, 8)


def test_native_crc16_strided_view():
    """A non-contiguous uint8 view must CRC its logical bytes, not the raw
    underlying buffer span."""
    import numpy as np
    from sla_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, 1024, dtype=np.uint8)
    view = raw[::2]
    assert native.crc16(view) == native.crc16(np.ascontiguousarray(view))
    assert native.crc16(view) == native.crc16(view.tobytes())
