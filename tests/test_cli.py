"""CLI application behavior (reference: src/main.c:31-537)."""

import numpy as np
import pytest

import sla_tpu as sla
from sla_tpu import wavio
from sla_tpu.cli import main

from .test_encode_decode import gen_wave


@pytest.fixture
def wav_file(tmp_path):
    pcm = gen_wave("chirp", 20000, 2, 16, 0, seed=9)
    p = tmp_path / "in.wav"
    wavio.write_wav(str(p), wavio.WavFile(2, 44100, 16, pcm))
    return p, pcm


def test_encode_decode_roundtrip(wav_file, tmp_path, capsys):
    wav_path, pcm = wav_file
    sla_path = tmp_path / "out.sla"
    dec_path = tmp_path / "dec.wav"
    assert main(["sla", "-e", "-q", "-m", "1", str(wav_path), str(sla_path)]) == 0
    assert sla_path.exists()
    assert main(["sla", "-d", "-q", str(sla_path), str(dec_path)]) == 0
    out = wavio.read_wav(str(dec_path))
    assert np.array_equal(out.data, pcm)


def test_streaming_decode_flag(wav_file, tmp_path):
    wav_path, pcm = wav_file
    sla_path = tmp_path / "out.sla"
    dec_path = tmp_path / "dec.wav"
    assert main(["sla", "-e", "-q", str(wav_path), str(sla_path)]) == 0
    assert main(["sla", "-d", "-s", "-q", str(sla_path), str(dec_path)]) == 0
    assert np.array_equal(wavio.read_wav(str(dec_path)).data, pcm)


def test_crc_check_flag(wav_file, tmp_path):
    wav_path, pcm = wav_file
    sla_path = tmp_path / "out.sla"
    assert main(["sla", "-e", "-q", str(wav_path), str(sla_path)]) == 0
    blob = bytearray(sla_path.read_bytes())
    blob[60] ^= 0xFF  # corrupt the first block
    bad = tmp_path / "bad.sla"
    bad.write_bytes(bytes(blob))
    dec_path = tmp_path / "dec.wav"
    # CRC on: detected
    assert main(["sla", "-d", "-q", str(bad), str(dec_path)]) == 1
    # CRC off: decodes without the check (output is garbage but no error)
    assert main(["sla", "-d", "-q", "-c", "no", str(bad), str(dec_path)]) in (0, 1)


def test_help_version(capsys):
    assert main(["sla", "-h"]) == 0
    assert "options:" in capsys.readouterr().out
    assert main(["sla", "-v"]) == 0
    assert sla.SLA_VERSION_STRING in capsys.readouterr().out


def test_error_paths(tmp_path, capsys):
    assert main(["sla"]) == 1  # no args -> usage
    assert main(["sla", "-e", "a"]) == 1  # missing output
    assert main(["sla", "a", "b"]) == 1  # neither -e nor -d
    assert main(["sla", "-e", "-d", "a", "b"]) == 1  # both modes
    assert main(["sla", "-e", "-m", "9", "a", "b"]) == 1  # preset out of range
    assert main(["sla", "-x", "a", "b"]) == 1  # unknown option
    assert main(["sla", "-e", "-q", str(tmp_path / "nope.wav"), "o"]) == 1


def test_preset_out_of_range_message(capsys):
    main(["sla", "-e", "-m", "5", "a", "b"])
    assert "out of range" in capsys.readouterr().err


def test_corpus_batch_mode(tmp_path):
    """-b: INPUT is a directory of WAVs, OUTPUT a directory (corpus mode)."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    pcms = {}
    for i, kind in enumerate(["sine", "noise"]):
        pcm = gen_wave(kind, 7000, 2, 16, 0, seed=i)
        pcms[kind] = pcm
        wavio.write_wav(str(in_dir / f"{kind}.wav"), wavio.WavFile(2, 44100, 16, pcm))
    out_dir = tmp_path / "out"
    assert main(["sla", "-e", "-b", "-q", "-m", "1", str(in_dir), str(out_dir)]) == 0
    for kind, pcm in pcms.items():
        dec_path = tmp_path / f"{kind}_dec.wav"
        assert main(["sla", "-d", "-q", str(out_dir / f"{kind}.sla"), str(dec_path)]) == 0
        assert np.array_equal(wavio.read_wav(str(dec_path)).data, pcm)
    # resume: second run skips everything
    assert main(["sla", "-e", "-b", "-q", "-m", "1", str(in_dir), str(out_dir)]) == 0
    import json

    manifest = json.loads((out_dir / "manifest_0.json").read_text())
    assert manifest["result"]["skipped"] == 2


def test_mono_ms_preset_downgrades(tmp_path):
    """MS presets apply NONE to non-stereo sources (main.c:124-130)."""
    pcm = gen_wave("sine", 9000, 1, 16, 0, seed=2)
    wav_path = tmp_path / "mono.wav"
    wavio.write_wav(str(wav_path), wavio.WavFile(1, 44100, 16, pcm))
    sla_path = tmp_path / "mono.sla"
    assert main(["sla", "-e", "-q", "-m", "2", str(wav_path), str(sla_path)]) == 0
    dec_path = tmp_path / "mono_dec.wav"
    assert main(["sla", "-d", "-q", str(sla_path), str(dec_path)]) == 0
    assert np.array_equal(wavio.read_wav(str(dec_path)).data, pcm)


def test_verbose_stage_timers(capsys):
    """Verbose mode surfaces per-stage timers on both encode and decode
    (SURVEY §5 observability: per-stage analysis/filter/entropy timing)."""
    import numpy as np

    import sla_tpu as sla
    from .test_encode_decode import gen_wave

    pcm = gen_wave("sine", 9000, 1, 16, 0, seed=9)
    enc = sla.Encoder(sla.EncoderConfig(verbose=True))
    enc.set_wave_format(sla.WaveFormat(1, 16, 44100))
    enc.set_encode_parameter(
        sla.EncodeParameter(8, 1, 4, sla.ChannelProcessMethod.NONE,
                            sla.PRESETS[0].window_function_type, 4096)
    )
    blob = enc.encode_whole(pcm)
    out = capsys.readouterr().out
    assert "partition" in out and "analysis" in out and "entropy" in out
    assert set(enc.stage_times) >= {"partition", "analysis", "filters", "entropy"}

    dec = sla.Decoder(sla.DecoderConfig(verbose=True))
    _, got = dec.decode_whole(blob)
    out = capsys.readouterr().out
    assert "progress:" in out and "synthesis" in out
    assert np.array_equal(got, pcm)
    assert set(dec.stage_times) >= {"headers", "entropy", "synthesis"}


def test_debug_assert_mode_roundtrip(monkeypatch):
    """SLA_TPU_DEBUG_ASSERTS=1 (checkify on-device asserts) leaves streams
    unchanged on legal input."""
    import numpy as np

    import sla_tpu as sla
    from .test_encode_decode import gen_wave

    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    pcm = gen_wave("chirp", 9000, 2, 16, 0, seed=10)
    enc = sla.Encoder(sla.EncoderConfig(backend="device"))
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[1])
    blob = enc.encode_whole(pcm)
    dec = sla.Decoder(sla.DecoderConfig(backend="device"))
    _, got = dec.decode_whole(blob)
    assert np.array_equal(got, pcm)


def test_debug_assert_mode_traps_overflow():
    """A forced LMS tap overflow raises through the checkified scan."""
    import os

    import jax.numpy as jnp
    import pytest as _pytest

    from sla_tpu import debug
    from sla_tpu.kernels.lms import LmsState, _lms_scan

    os.environ["SLA_TPU_DEBUG_ASSERTS"] = "1"
    try:
        B, M = 1, 4
        st = LmsState(
            jnp.full((B, M), 2**30, jnp.int32), jnp.zeros((B, M), jnp.int32),
            jnp.full((B, M), 2**30, jnp.int32), jnp.zeros((B, M), jnp.int32),
            jnp.full((B,), M, jnp.int32),
        )
        data = jnp.full((B, 4), 2**20, jnp.int32)
        with _pytest.raises(Exception, match="LMS tap product overflows"):
            debug.run_checked(_lms_scan, data, st, num_coef=M, synthesize=False)
    finally:
        del os.environ["SLA_TPU_DEBUG_ASSERTS"]


def test_cli_corpus_filter_batch(tmp_path):
    """-b -f N fuses N files per filter dispatch; outputs match -b alone."""
    import numpy as np

    from sla_tpu.cli import main as cli_main
    from sla_tpu import wavio
    from .test_encode_decode import gen_wave

    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i in range(3):
        pcm = gen_wave("sine", 4000 + i * 777, 1, 16, 0, seed=i)
        wavio.write_wav(str(in_dir / f"t{i}.wav"), wavio.WavFile(1, 44100, 16, pcm))
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    assert cli_main(["prog", "-e", "-q", "-b", "-m", "0", str(in_dir), str(out_a)]) == 0
    assert cli_main(["prog", "-e", "-q", "-b", "-f", "3", "-m", "0",
                     str(in_dir), str(out_b)]) == 0
    for i in range(3):
        assert (out_a / f"t{i}.sla").read_bytes() == (out_b / f"t{i}.sla").read_bytes()


def test_api_result_codes_match_reference_header():
    """ApiResult's numeric values must track SLAApiResult (SLA.h:26-43)
    positionally — callers porting from the C API rely on the codes.
    (The reference's INVAILD_CHPROCESSMETHOD typo is intentionally fixed
    in our name; the value is what carries.)"""
    import pathlib
    import re

    from sla_tpu.errors import ApiResult

    hdr = pathlib.Path("/root/reference/src/include/public/SLA.h")
    if not hdr.exists():
        import pytest

        pytest.skip("reference source unavailable")
    names = re.findall(r"SLA_APIRESULT_([A-Z_]+)", hdr.read_text())
    seen = []
    for n in names:
        if n not in seen:
            seen.append(n)
    assert len(seen) == len(ApiResult)
    for value, name in enumerate(seen):
        ours = ApiResult(value).name
        assert ours == name or (name, ours) == (
            "INVAILD_CHPROCESSMETHOD", "INVALID_CHPROCESSMETHOD"
        ), (value, name, ours)


def test_debug_assert_traps_lattice_overflow():
    """A forced lattice stage-product overflow raises through the
    checkified scan (VERDICT r2 #6: assert breadth beyond LMS)."""
    import os

    import jax.numpy as jnp
    import pytest as _pytest

    from sla_tpu import debug
    from sla_tpu.kernels.lattice import lattice_synthesize

    os.environ["SLA_TPU_DEBUG_ASSERTS"] = "1"
    try:
        B, p = 1, 4
        # the only q15 corner that overflows: c = -2^15 and v = INT32_MIN
        # ((c*v + 2^14) >> 15 == 2^31 > INT32_MAX)
        coef = jnp.full((B, p), -32768, jnp.int32)
        state = jnp.full((B, p + 1), -(2**31), jnp.int32)
        data = jnp.full((B, 4), 1, jnp.int32)
        with _pytest.raises(Exception, match="lattice synth stage product"):
            debug.run_checked(lattice_synthesize, data, coef, state)
    finally:
        del os.environ["SLA_TPU_DEBUG_ASSERTS"]


def test_debug_assert_traps_longterm_overflow():
    """A forced long-term prediction overflow raises through the
    checkified scan."""
    import os

    import jax.numpy as jnp
    import pytest as _pytest

    from sla_tpu import debug
    from sla_tpu.kernels.longterm import longterm_init_state, longterm_synthesize

    os.environ["SLA_TPU_DEBUG_ASSERTS"] = "1"
    try:
        B = 1
        pitch = jnp.full((B,), 8, jnp.int32)
        # the overflowing corner: q15 = -2^15 with history = INT32_MIN
        coef = jnp.full((B, 1), -(2**31), jnp.int32)  # q15 (>>16) = -32768
        hist, _t = longterm_init_state(B)
        hist = jnp.full_like(hist, -(2**31))
        res = jnp.full((B, 16), 0, jnp.int32)
        state = (hist, jnp.full((B,), 1000, jnp.int32))  # past warmup

        def run(r, p, c, s):
            return longterm_synthesize(r, p, c, 1, s, chunk=1)

        with _pytest.raises(Exception, match="long-term prediction overflows"):
            debug.run_checked(run, res, pitch, coef, state)
    finally:
        del os.environ["SLA_TPU_DEBUG_ASSERTS"]


def test_native_debug_build_roundtrip_and_trap(tmp_path):
    """SLA_TPU_NATIVE_DEBUG=1 builds the -DSLA_TPU_DEBUG native lib whose
    cascades carry the reference's SLA_Assert-equivalent checks: a normal
    encode/decode round-trip passes, and a seeded LMS tap overflow aborts
    the process (caught at subprocess level, like assert())."""
    import os
    import subprocess
    import sys

    env = {**os.environ, "SLA_TPU_NATIVE_DEBUG": "1", "JAX_PLATFORMS": "cpu"}
    ok_src = (
        "import numpy as np, sla_tpu as sla\n"
        "from tests.test_encode_decode import gen_wave\n"
        "pcm = gen_wave('chirp', 9000, 2, 16, 0, seed=4)\n"
        "enc = sla.Encoder(); enc.set_wave_format(sla.WaveFormat(2, 16, 44100))\n"
        "enc.set_encode_parameter(sla.PRESETS[1])\n"
        "blob = enc.encode_whole(pcm)\n"
        "dec = sla.Decoder()\n"
        "assert np.array_equal(dec.decode_whole(blob)[1], pcm)\n"
        "print('debug-build round-trip ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", ok_src], capture_output=True,
                       text=True, timeout=600, env=env, cwd="/root/repo")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "round-trip ok" in r.stdout

    trap_src = (
        # constant huge residuals: the sign-sign LMS coefficients grow ~15
        # per sample, so by sample ~150 the fir tap product tops int32
        "import numpy as np\n"
        "from sla_tpu import native\n"
        "res = np.full((16, 512), 2**30, np.int32)\n"
        "coef = np.zeros((16, 4), np.int32)\n"
        "pitch = np.zeros(16, np.int32)\n"
        "ltm = np.zeros((16, 1), np.int32)\n"
        "native.synth_rows(res, coef, pitch, ltm, 1, 8)\n"
        "print('should have aborted')\n"
    )
    r = subprocess.run([sys.executable, "-c", trap_src], capture_output=True,
                       text=True, timeout=600, env=env, cwd="/root/repo")
    assert r.returncode != 0 and "should have aborted" not in r.stdout
    assert "SLA debug assert failed" in r.stderr, r.stderr[-2000:]


def test_encode_verify_flag(tmp_path, a_wav):
    """-V: encode-time self-check decodes the stream and compares."""
    out = tmp_path / "v.sla"
    from sla_tpu.cli import main
    assert main(["sla", "-e", "-V", "-q", str(a_wav), str(out)]) == 0
    assert out.exists() and out.stat().st_size > 43


def test_encode_verify_catches_mismatch(monkeypatch):
    import numpy as np
    import sla_tpu as sla
    from sla_tpu import decoder as dec_mod
    from sla_tpu.errors import SLAError

    pcm = (np.arange(2 * 9000, dtype=np.int32).reshape(2, 9000) % 251 - 125) << 16
    enc = sla.Encoder(sla.EncoderConfig(verify=True))
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[1])
    orig = dec_mod.Decoder.decode_whole

    def corrupted(self, blob):
        h, out = orig(self, blob)
        out = out.copy()
        out[0, 100] ^= 4
        return h, out

    monkeypatch.setattr(dec_mod.Decoder, "decode_whole", corrupted)
    with pytest.raises(SLAError):
        enc.encode_whole(pcm)


def test_salvage_cli_recovers(tmp_path, a_wav):
    """-d -r: recover a damaged stream to a zero-gap-filled WAV."""
    import numpy as np
    from sla_tpu import wavio
    from sla_tpu.cli import main
    from sla_tpu.decoder import Decoder
    from sla_tpu.format import decode_header

    sla_path = tmp_path / "x.sla"
    assert main(["sla", "-e", "-q", str(a_wav), str(sla_path)]) == 0
    blob = bytearray(sla_path.read_bytes())
    header, _ = decode_header(bytes(blob))
    dec = Decoder()
    dec.set_wave_format(header.wave_format)
    dec.set_encode_parameter(header.encode_param)
    blocks = dec.scan_blocks(bytes(blob), header.num_samples)
    assert len(blocks) >= 3
    victim = blocks[1]
    blob[victim.data_offset + 20] ^= 0x3C
    bad_path = tmp_path / "bad.sla"
    bad_path.write_bytes(bytes(blob))
    out_path = tmp_path / "rec.wav"
    # plain decode fails on the corruption; -r recovers
    assert main(["sla", "-d", "-q", str(bad_path), str(out_path)]) == 1
    assert main(["sla", "-d", "-r", "-q", str(bad_path), str(out_path)]) == 0
    orig = wavio.read_wav(str(a_wav)).data
    rec = wavio.read_wav(str(out_path)).data
    assert rec.shape == orig.shape
    n0 = blocks[0].num_samples
    lost = victim.num_samples
    assert np.array_equal(rec[:, :n0], orig[:, :n0])
    assert np.array_equal(rec[:, n0 : n0 + lost], np.zeros_like(rec[:, :lost]))
    assert np.array_equal(rec[:, n0 + lost :], orig[:, n0 + lost :])


def test_encode_verify_segmented_path(monkeypatch):
    """verify=True must also cover the segmented long-stream encode."""
    import numpy as np
    import sla_tpu as sla

    monkeypatch.setenv("SLA_TPU_SEGMENT_SAMPLES", "1")  # floor: 4 windows
    pcm = gen_wave("chirp", 60000, 2, 16, 0, seed=5)
    enc = sla.Encoder(sla.EncoderConfig(verify=True))
    enc.set_wave_format(sla.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla.PRESETS[1])
    blob = enc.encode_whole(pcm)
    _, out = sla.Decoder().decode_whole(blob)
    assert np.array_equal(out, pcm)



def test_streaming_cli_corrupt_and_truncated_header(wav_file, tmp_path):
    """The -s path must handle header-stage damage like the -d path: a
    truncated file or a header CRC mismatch prints a clean error (exit 1),
    never a traceback, and header CRC respects -c no."""
    wav_path, _ = wav_file
    sla_path = tmp_path / "out.sla"
    assert main(["sla", "-e", "-q", str(wav_path), str(sla_path)]) == 0
    blob = bytearray(sla_path.read_bytes())
    dec_path = tmp_path / "dec.wav"
    # truncated: shorter than the 43-byte stream header
    trunc = tmp_path / "trunc.sla"
    trunc.write_bytes(bytes(blob[:20]))
    assert main(["sla", "-d", "-s", "-q", str(trunc), str(dec_path)]) == 1
    # header CRC mismatch (flip a benign declared-field byte: num_samples
    # low bits live past the CRC field and are covered by it)
    bad = bytearray(blob)
    bad[20] ^= 0x01
    badf = tmp_path / "badhdr.sla"
    badf.write_bytes(bytes(bad))
    assert main(["sla", "-d", "-s", "-q", str(badf), str(dec_path)]) == 1
    # same verdict as the bulk path
    assert main(["sla", "-d", "-q", str(badf), str(dec_path)]) == 1


def test_cli_corrupt_enum_header_clean_error(wav_file, tmp_path):
    """A corrupt ch_process_method byte in the stream header must produce a
    clean exit-1 on every decode subcommand — decode_header maps the bad
    enum to a structured SLAError, never a ValueError traceback."""
    wav_path, _ = wav_file
    sla_path = tmp_path / "out.sla"
    assert main(["sla", "-e", "-q", str(wav_path), str(sla_path)]) == 0
    from sla_tpu.crc16 import crc16
    from sla_tpu.errors import SLAError
    from sla_tpu.format import decode_header

    blob = bytearray(sla_path.read_bytes())
    # find the ch_process_method byte by probing: setting it to 7 (invalid)
    # with a re-stamped CRC must flip decode_header into the SLAError
    crafted = None
    for off in range(10, 43):
        probe = bytearray(blob)
        probe[off] = 7
        probe[8:10] = crc16(bytes(probe[10:43])).to_bytes(2, "big")
        try:
            decode_header(bytes(probe))
        except SLAError:
            crafted = bytes(probe)
            break
    assert crafted is not None, "could not locate the ch_process_method field"
    bad = tmp_path / "badenum.sla"
    bad.write_bytes(crafted)
    dec_path = tmp_path / "dec.wav"
    assert main(["sla", "-d", "-q", str(bad), str(dec_path)]) == 1
    assert main(["sla", "-d", "-s", "-q", str(bad), str(dec_path)]) == 1
    assert main(["sla", "-d", "-r", "-q", str(bad), str(dec_path)]) == 1


def test_corpus_isolates_malformed_wav(tmp_path):
    """One malformed WAV (fmt chunk truncated) must be recorded as failed
    without aborting the corpus run."""
    from .test_encode_decode import gen_wave as gw

    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    pcm = gw("sine", 4000, 1, 16, 0, seed=3)
    wavio.write_wav(str(in_dir / "good.wav"),
                    wavio.WavFile(1, 44100, 16, pcm))
    # RIFF/WAVE with a 2-byte fmt body: used to leak struct.error
    bad = b"RIFF" + (30).to_bytes(4, "little") + b"WAVE" + b"fmt " + \
        (2).to_bytes(4, "little") + b"\x01\x00"
    (in_dir / "bad.wav").write_bytes(bad)
    from sla_tpu.corpus import encode_corpus

    res = encode_corpus(sorted(in_dir.glob("*.wav")), out_dir, preset=0)
    assert res.encoded == 1
    assert res.failed == 1
    assert (out_dir / "good.sla").exists()


def test_corpus_cli_honors_verify_flag(tmp_path, monkeypatch):
    """-e -b -V must thread verify=True into the corpus encoders (it was
    silently dropped): a decoder forced to lie makes every file fail."""
    from .test_encode_decode import gen_wave as gw

    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    for i in range(2):
        pcm = gw("sine", 3000, 1, 16, 0, seed=i)
        wavio.write_wav(str(in_dir / f"f{i}.wav"),
                        wavio.WavFile(1, 44100, 16, pcm))
    # verification passes normally…
    assert main(["sla", "-e", "-q", "-b", "-V", str(in_dir), str(out_dir)]) == 0
    # …and is really running: a sabotaged verify decode fails the run
    import shutil
    shutil.rmtree(out_dir)
    import sla_tpu.decoder as dec_mod

    def lie(self, blob):
        import numpy as np
        from sla_tpu.format import decode_header as dh
        h, _ = dh(blob)
        return h, np.zeros((h.wave_format.num_channels, h.num_samples),
                           dtype=np.int32) + 12345

    monkeypatch.setattr(dec_mod.Decoder, "decode_whole", lie)
    assert main(["sla", "-e", "-q", "-b", "-V", str(in_dir), str(out_dir)]) == 1


def test_window_decode_cli(tmp_path, a_wav):
    """-d -w START:COUNT: random-access window decode to a WAV."""
    import numpy as np
    from sla_tpu import wavio
    from sla_tpu.cli import main

    sla_path = tmp_path / "x.sla"
    assert main(["sla", "-e", "-q", str(a_wav), str(sla_path)]) == 0
    out_path = tmp_path / "win.wav"
    assert main(["sla", "-d", "-q", "-w", "5000:3000", str(sla_path), str(out_path)]) == 0
    orig = wavio.read_wav(str(a_wav)).data
    win = wavio.read_wav(str(out_path)).data
    assert np.array_equal(win, orig[:, 5000:8000])
    # window clamped at the stream tail
    n = orig.shape[1]
    assert main(["sla", "-d", "-q", "-w", f"{n - 100}:500", str(sla_path), str(out_path)]) == 0
    win = wavio.read_wav(str(out_path)).data
    assert np.array_equal(win, orig[:, n - 100 :])
    # malformed / negative / combined with -r all rejected
    assert main(["sla", "-d", "-q", "-w", "oops", str(sla_path), str(out_path)]) == 1
    assert main(["sla", "-d", "-q", "-w", "-5:10", str(sla_path), str(out_path)]) == 1
    assert main(["sla", "-d", "-q", "-r", "-w", "0:10", str(sla_path), str(out_path)]) == 1


def test_info_cli(tmp_path, a_wav, capsys):
    """-i: stream information from one header walk, no output file needed."""
    from sla_tpu.cli import main

    sla_path = tmp_path / "x.sla"
    assert main(["sla", "-e", "-q", str(a_wav), str(sla_path)]) == 0
    assert main(["sla", "-i", str(sla_path)]) == 0
    out = capsys.readouterr().out
    assert "240000" in out          # sample count of a.wav
    assert "1ch 48000 Hz 8-bit" in out
    assert "compression:" in out
    assert "CRC16 verified" in out
    # corrupt a block -> info fails the CRC walk; -c no skips it
    blob = bytearray(sla_path.read_bytes())
    blob[120] ^= 0x40
    bad = tmp_path / "bad.sla"
    bad.write_bytes(bytes(blob))
    assert main(["sla", "-i", str(bad)]) == 1
    assert main(["sla", "-i", "-c", "no", str(bad)]) == 0
    # not a stream at all
    assert main(["sla", "-i", str(a_wav)]) == 1


def test_info_rejects_mode_combination(tmp_path, a_wav):
    from sla_tpu.cli import main

    sla_path = tmp_path / "x.sla"
    assert main(["sla", "-e", "-q", str(a_wav), str(sla_path)]) == 0
    assert main(["sla", "-e", "-i", str(a_wav), str(sla_path)]) == 1
    assert main(["sla", "-d", "-i", str(sla_path), "out.wav"]) == 1


def test_window_decode_cli_sidecar_index(tmp_path, a_wav):
    """-d -w ... -x FILE: first call builds and saves the sidecar index,
    the second loads it; both produce the exact window. A corrupt sidecar
    fails structurally."""
    import numpy as np
    from sla_tpu import wavio
    from sla_tpu.cli import main

    sla_path = tmp_path / "x.sla"
    assert main(["sla", "-e", "-q", str(a_wav), str(sla_path)]) == 0
    orig = wavio.read_wav(str(a_wav)).data
    idx_path = tmp_path / "x.slix"
    out_path = tmp_path / "win.wav"
    assert main(["sla", "-d", "-q", "-w", "5000:3000", "-x", str(idx_path),
                 str(sla_path), str(out_path)]) == 0
    assert idx_path.exists()
    assert np.array_equal(wavio.read_wav(str(out_path)).data, orig[:, 5000:8000])
    # second run loads the sidecar (delete the output to prove it re-wrote)
    out_path.unlink()
    assert main(["sla", "-d", "-q", "-w", "9000:100", "-x", str(idx_path),
                 str(sla_path), str(out_path)]) == 0
    assert np.array_equal(wavio.read_wav(str(out_path)).data, orig[:, 9000:9100])
    # corrupt/stale sidecar: the cache self-heals (rebuild + overwrite),
    # and the repaired file loads cleanly afterwards
    good = idx_path.read_bytes()
    blob = bytearray(good)
    blob[10] ^= 0x80
    idx_path.write_bytes(bytes(blob))
    assert main(["sla", "-d", "-q", "-w", "0:10", "-x", str(idx_path),
                 str(sla_path), str(out_path)]) == 0
    assert idx_path.read_bytes() == good
    assert np.array_equal(wavio.read_wav(str(out_path)).data, orig[:, 0:10])
    # unusable index path: structured failure, no crash, no tmp litter
    bad_dir = tmp_path / "isadir"
    bad_dir.mkdir()
    assert main(["sla", "-d", "-q", "-w", "0:10", "-x", str(bad_dir),
                 str(sla_path), str(out_path)]) == 1
    assert not list(tmp_path.glob("*.tmp*"))
    # -x outside -e / -d -w is rejected, not silently ignored
    assert main(["sla", "-d", "-q", "-x", str(idx_path),
                 str(sla_path), str(out_path)]) == 1


def test_encode_emits_sidecar_index(tmp_path, a_wav):
    """-e -x FILE writes the seek-index sidecar at encode time; a later
    -d -w -x loads it unchanged."""
    import numpy as np
    from sla_tpu import wavio
    from sla_tpu.cli import main

    sla_path = tmp_path / "x.sla"
    idx_path = tmp_path / "x.slix"
    assert main(["sla", "-e", "-q", "-x", str(idx_path),
                 str(a_wav), str(sla_path)]) == 0
    assert idx_path.exists()
    before = idx_path.read_bytes()
    out_path = tmp_path / "win.wav"
    assert main(["sla", "-d", "-q", "-w", "5000:3000", "-x", str(idx_path),
                 str(sla_path), str(out_path)]) == 0
    assert idx_path.read_bytes() == before  # loaded, not rebuilt
    orig = wavio.read_wav(str(a_wav)).data
    assert np.array_equal(wavio.read_wav(str(out_path)).data, orig[:, 5000:8000])
    # corpus mode rejects -x
    in_dir = tmp_path / "corp"; in_dir.mkdir()
    assert main(["sla", "-e", "-q", "-b", "-x", str(idx_path),
                 str(in_dir), str(tmp_path / "outd")]) == 1
