"""CLI application: encode/decode/streaming-decode WAV <-> .sla.

Same flags, presets, and exit behavior as the reference CLI
(src/main.c:31-537): ``-e`` encode, ``-d`` decode, ``-d -s`` streaming
decode (debug, 120 Hz ticks), ``-m 0..4`` preset, ``-c yes|no`` CRC check,
``-p``/``-q`` verbosity, ``-h`` help, ``-v`` version.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

from . import PRESETS, preset_parameter, wavio
from .constants import SLA_HEADER_SIZE, SLA_VERSION_STRING
from .command_line import (
    OptionSpec,
    ParserResult,
    get_argument_string,
    get_option_acquired,
    parse_arguments,
    print_description,
)
from .decoder import Decoder, DecoderConfig
from .encoder import Encoder, EncoderConfig
from .errors import ApiResult, SLAError
from .format import WaveFormat, decode_header


def _make_spec() -> list[OptionSpec]:
    """Option table (reference src/main.c:31-60)."""
    return [
        OptionSpec("e", "encode", False, "Encode mode"),
        OptionSpec("d", "decode", False, "Decode mode"),
        OptionSpec("m", "mode", True,
                   "Specify compress mode: 0(fast decode), ..., 4(high compression) default:2"),
        OptionSpec("p", "verpose", False, "Verpose mode(try to display all information)"),
        OptionSpec("q", "quiet", False, "Quiet mode(suppress outputs)"),
        OptionSpec("c", "crc-check", True,
                   "Whether to check CRC16 at decoding(yes or no) default:yes"),
        OptionSpec("h", "help", False, "Show command help message"),
        OptionSpec("v", "version", False, "Show version information"),
        OptionSpec("s", "streaming", False, "Use streaming decode(for debug; 120fps)"),
        OptionSpec("t", "trace", True,
                   "Write a JAX profiler trace to the given directory"),
        OptionSpec("b", "batch", False,
                   "Corpus mode: INPUT is a directory of WAVs (-e) or SLAs (-d), "
                   "OUTPUT a directory"),
        OptionSpec("f", "filter-batch", True,
                   "Corpus mode: fuse N files' blocks per filter dispatch default:1"),
        OptionSpec("V", "verify", False,
                   "Verify after encoding (decode the stream, compare with the input)"),
        OptionSpec("r", "recover", False,
                   "Decode mode: salvage a damaged stream (resync past corrupt blocks)"),
        OptionSpec("O", "optimize", True,
                   "Encode mode: search encode parameters for the smallest stream "
                   "(1:sampled trials, 2:full-file trials)"),
        OptionSpec("w", "window", True,
                   "Decode mode: decode only the sample window START:COUNT "
                   "(random access; only overlapping blocks are read)"),
        OptionSpec("i", "info", False,
                   "Print stream information (header + block summary) without decoding"),
        OptionSpec("x", "index", True,
                   "Sidecar seek-index file: with -d -w, loaded if it exists "
                   "(else built and saved); with -e, emitted after encoding"),
    ]


DEFAULT_PRESET = 2


def do_encode(in_file: str, out_file: str, preset_no: int, verbose: bool,
              trace_dir: str | None = None, verify: bool = False,
              optimize: int | None = None,
              index_file: str | None = None) -> int:
    try:
        wav = wavio.read_wav(in_file)
    except Exception as e:
        print(f"Failed to open {in_file} ({e})", file=sys.stderr)
        return 1
    wf = WaveFormat(wav.num_channels, wav.bits_per_sample, wav.sampling_rate)
    config = EncoderConfig(verbose=verbose, verify=verify)
    param = preset_parameter(preset_no, wav.num_channels)

    def run() -> bytes:
        if optimize:
            from .optimize import optimize_encode

            blob, _ = optimize_encode(
                wav.data, wf, start=param, effort=optimize,
                encoder_config=config,
            )
            return blob
        enc = Encoder(config)
        enc.set_wave_format(wf)
        enc.set_encode_parameter(param)
        return enc.encode_whole(wav.data)

    try:
        if trace_dir:
            import jax

            with jax.profiler.trace(trace_dir):
                blob = run()
        else:
            blob = run()
    except SLAError as e:
        print(f"Encoding error! {e}", file=sys.stderr)
        return 1
    pathlib.Path(out_file).write_bytes(blob)
    if index_file:
        # emit the seek-index sidecar at encode time (-e -x FILE): later
        # -d -w ... -x seeks skip even their first whole-stream walk
        import os

        ip = pathlib.Path(index_file)
        tmp = ip.with_name(ip.name + f".tmp{os.getpid()}")
        try:
            side = Decoder().build_index(blob).to_bytes()
            tmp.write_bytes(side)
            tmp.replace(ip)
        except Exception as e:
            tmp.unlink(missing_ok=True)
            print(f"Failed to write index {index_file} ({e})", file=sys.stderr)
            return 1
        if verbose:
            print(f"index: saved to {ip}")
    if verbose:
        in_size = pathlib.Path(in_file).stat().st_size
        print(f"Encode succuess! size:{in_size} -> {len(blob)}")
    return 0


def do_decode(in_file: str, out_file: str, enable_crc_check: bool, verbose: bool) -> int:
    try:
        blob = pathlib.Path(in_file).read_bytes()
    except Exception as e:
        print(f"Failed to open {in_file} ({e})", file=sys.stderr)
        return 1
    dec = Decoder(DecoderConfig(enable_crc_check=enable_crc_check, verbose=verbose))
    try:
        header, pcm = dec.decode_whole(blob)
    except SLAError as e:
        print(f"Decoding error! {e}", file=sys.stderr)
        return 1
    wf = header.wave_format
    if verbose:
        print(f"num_channels:{wf.num_channels} sampling_rate:{wf.sampling_rate} "
              f"bit_per_sample:{wf.bit_per_sample} num_samples:{header.num_samples} "
              f"num_blocks:{header.num_blocks} max_block_size:{header.max_block_size}")
    wavio.write_wav(
        out_file, wavio.WavFile(wf.num_channels, wf.sampling_rate, wf.bit_per_sample, pcm)
    )
    return 0


def do_streaming_decode(in_file: str, out_file: str, enable_crc_check: bool,
                        verbose: bool) -> int:
    """Streaming decode at simulated 120 Hz ticks (main.c:278-423): data is
    fed in minimal fragments and pulled in 1/120 s sample batches."""
    from .streaming import StreamingDecoder, StreamingDecoderConfig

    try:
        blob = pathlib.Path(in_file).read_bytes()
    except Exception as e:
        print(f"Failed to open {in_file} ({e})", file=sys.stderr)
        return 1
    try:
        header, status = decode_header(blob)
        # same header CRC gate as Decoder._open_stream (the -d path)
        if status == ApiResult.DETECT_DATA_CORRUPTION and enable_crc_check:
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION, "header CRC mismatch")
        wf = header.wave_format
        sd = StreamingDecoder(
            StreamingDecoderConfig(
                core=DecoderConfig(enable_crc_check=enable_crc_check, verbose=verbose),
                decode_interval_hz=120.0,
                # a crafted header can declare < 8 bits; the config requires
                # [8, 32] (capacity only — the stream's real depth still rules)
                max_bit_per_sample=max(8, wf.bit_per_sample),
            )
        )
        sd.set_wave_format(wf)
        sd.set_encode_parameter(header.encode_param)
    except SLAError as e:
        print(f"Decoding error! {e}", file=sys.stderr)
        return 1
    pos = SLA_HEADER_SIZE
    out = np.zeros((wf.num_channels, header.num_samples), dtype=np.int32)
    # per-tick samples land directly at the stream position of the output
    # array (the reference's Decode writes through a buffer+offset pointer
    # the same way, main.c:370-410)
    total = header.num_samples
    done = 0
    try:
        while done < total:
            need = sd.estimate_minimum_necessary_data_size()
            if pos < len(blob) and sd.remaining_data_size() < need:
                take = min(need, len(blob) - pos)
                sd.append_data_fragment(blob[pos : pos + take])
                pos += take
            n = sd.decode_into(out, done, max_samples=total - done)
            if n == 0:
                if pos >= len(blob):
                    break
                # entropy payload locally denser than the average-rate
                # estimate: feed another fragment to guarantee progress
                take = min(need, len(blob) - pos)
                sd.append_data_fragment(blob[pos : pos + take])
                pos += take
            done += n
            sd.collect_data_fragments()
    except SLAError as e:
        print(f"Decoding error! {e}", file=sys.stderr)
        return 1
    if done != header.num_samples:
        print("Streaming decode ended early", file=sys.stderr)
        return 1
    wavio.write_wav(
        out_file, wavio.WavFile(wf.num_channels, wf.sampling_rate, wf.bit_per_sample, out)
    )
    if verbose:
        print(f"Streaming decode success! {done} samples")
    return 0


def do_window_decode(in_file: str, out_file: str, window: str,
                     enable_crc_check: bool, verbose: bool,
                     index_file: str | None = None) -> int:
    """Random-access decode (-d -w START:COUNT): decode only the blocks
    overlapping the requested sample window (Decoder.decode_range) and
    write that window as a WAV. The reference CLI can only decode whole
    streams; this seeks into long files at O(window) cost. With -x FILE
    the seek index persists as a sidecar: loaded when the file exists
    (the whole-stream header walk is skipped entirely), built once and
    saved atomically otherwise."""
    try:
        start_s, count_s = window.split(":", 1)
        start, count = int(start_s), int(count_s)
    except ValueError:
        print("window must be START:COUNT (sample numbers)", file=sys.stderr)
        return 1
    if start < 0 or count < 0:
        print("window START and COUNT must be non-negative", file=sys.stderr)
        return 1
    try:
        blob = pathlib.Path(in_file).read_bytes()
    except Exception as e:
        print(f"Failed to open {in_file} ({e})", file=sys.stderr)
        return 1
    dec = Decoder(DecoderConfig(enable_crc_check=enable_crc_check, verbose=verbose))
    idx = None
    if index_file:
        from .decoder import StreamIndex

        def save(ix) -> None:
            # the sidecar is an optimization: a failure to persist it
            # (read-only dir, disk full, ...) must not abort the decode —
            # the freshly built index is already in memory and usable
            import os

            tmp = ip.with_name(ip.name + f".tmp{os.getpid()}")
            try:
                tmp.write_bytes(ix.to_bytes())
                tmp.replace(ip)  # atomic, like the corpus .done markers
            except Exception as e:
                tmp.unlink(missing_ok=True)
                print(f"index: could not save sidecar {ip} ({e}); "
                      "continuing with the in-memory index", file=sys.stderr)

        ip = pathlib.Path(index_file)
        try:
            if ip.exists():
                try:
                    idx = StreamIndex.from_bytes(
                        ip.read_bytes(), blob, enable_crc_check=enable_crc_check
                    )
                except SLAError as e:
                    # the sidecar is a CACHE: stale (stream re-encoded) or
                    # corrupt entries rebuild and overwrite, never dead-end
                    print(f"index: rebuilding {ip} ({e})", file=sys.stderr)
                    idx = dec.build_index(blob)
                    save(idx)
            else:
                idx = dec.build_index(blob)
                save(idx)
                if verbose:
                    print(f"index: built and saved to {ip}")
        except SLAError as e:
            print(f"Decoding error! {e}", file=sys.stderr)
            return 1
        except Exception as e:
            print(f"Failed to use index {index_file} ({e})", file=sys.stderr)
            return 1
    try:
        header, pcm = dec.decode_range(blob, start, count, index=idx)
    except SLAError as e:
        print(f"Decoding error! {e}", file=sys.stderr)
        return 1
    wf = header.wave_format
    lo = min(start, header.num_samples)  # decode_range clamps the same way
    if count > 0 and pcm.shape[1] == 0:
        print(f"window [{start}:{count}] is past the end of the stream "
              f"({header.num_samples} samples); writing an empty WAV",
              file=sys.stderr)
    if verbose:
        print(f"window decode: samples [{lo}, {lo + pcm.shape[1]}) of "
              f"{header.num_samples}")
    wavio.write_wav(
        out_file, wavio.WavFile(wf.num_channels, wf.sampling_rate, wf.bit_per_sample, pcm)
    )
    return 0


def do_info(in_file: str, enable_crc_check: bool) -> int:
    """Stream information (-i): header fields + a block summary from one
    CRC-verified header walk (Decoder.build_index) — no payload is
    entropy-decoded. The reference CLI has no equivalent (its verbose
    decode prints header fields, but only while decoding everything)."""
    from .constants import BlockDataType

    try:
        blob = pathlib.Path(in_file).read_bytes()
    except Exception as e:
        print(f"Failed to open {in_file} ({e})", file=sys.stderr)
        return 1
    dec = Decoder(DecoderConfig(enable_crc_check=enable_crc_check))
    try:
        idx = dec.build_index(blob)
    except SLAError as e:
        print(f"Stream error! {e}", file=sys.stderr)
        return 1
    h, wf, ep = idx.header, idx.header.wave_format, idx.header.encode_param
    dur = h.num_samples / wf.sampling_rate if wf.sampling_rate else 0.0
    raw = h.num_samples * wf.num_channels * wf.bit_per_sample // 8
    counts = {t: 0 for t in BlockDataType}
    bs = [b.num_samples for b in idx.blocks]
    for b in idx.blocks:
        counts[b.block_type] += 1
    print(f"file:            {in_file} ({len(blob)} bytes)")
    print(f"format:          {wf.num_channels}ch {wf.sampling_rate} Hz "
          f"{wf.bit_per_sample}-bit (offset_lshift {wf.offset_lshift})")
    print(f"samples:         {h.num_samples} ({dur:.3f} s)")
    print(f"parameters:      parcor {ep.parcor_order}, longterm {ep.longterm_order}, "
          f"lms {ep.lms_order_per_filter}, ch_process {ep.ch_process_method.name}, "
          f"max_block {ep.max_num_block_samples}")
    if bs:
        print(f"blocks:          {len(idx.blocks)} "
              f"(compress {counts[BlockDataType.COMPRESSDATA]}, "
              f"silent {counts[BlockDataType.SILENT]}, "
              f"raw {counts[BlockDataType.RAWDATA]}); "
              f"samples/block min {min(bs)} max {max(bs)}")
    else:
        print("blocks:          0")
    print(f"declared:        num_blocks {h.num_blocks}, max_block_size {h.max_block_size}, "
          f"max_bit_per_second {h.max_bit_per_second}")
    if raw:
        print(f"compression:     {len(blob)}/{raw} = {len(blob) / raw:.4f}")
    crc = "verified" if enable_crc_check else "skipped (-c no)"
    print(f"integrity:       header + {len(idx.blocks)} block CRC16 {crc}")
    return 0


def do_salvage_decode(in_file: str, out_file: str, enable_crc_check: bool,
                      verbose: bool) -> int:
    """Best-effort decode of a damaged stream (-d -r): recover every intact
    block run via Decoder.decode_salvage, place the segments in a
    zero-filled buffer of the declared length (first run exact; the last
    run tail-anchored when a single gap makes its position certain; runs
    between gaps placed sequentially, best effort), and report the gaps."""
    try:
        blob = pathlib.Path(in_file).read_bytes()
    except Exception as e:
        print(f"Failed to open {in_file} ({e})", file=sys.stderr)
        return 1
    dec = Decoder(DecoderConfig(enable_crc_check=enable_crc_check, verbose=verbose))
    try:
        header, segs = dec.decode_salvage(blob)
    except SLAError as e:
        print(f"Salvage error! {e}", file=sys.stderr)
        return 1
    wf = header.wave_format
    out = np.zeros((wf.num_channels, header.num_samples), dtype=np.int32)
    recovered = 0
    pos = 0
    gaps = sum(1 for s_ in segs if s_.gap_before_bytes)
    for i, seg in enumerate(segs):
        n = seg.pcm.shape[1]
        if seg.sample_offset is not None:
            pos = seg.sample_offset
        elif i == len(segs) - 1 and gaps == 1:
            # the stream's single gap precedes this final run (it is the
            # only segment with an unknown offset), so the run must end at
            # the declared total — tail-anchor it. Covers both the
            # head-gap single-segment case and the prefix+gap+tail case;
            # with >=2 gaps no position is certain and sequential
            # placement stays best-effort.
            pos = header.num_samples - n
        take = min(n, header.num_samples - pos)
        if take > 0:
            out[:, pos : pos + take] = seg.pcm[:, :take]
            recovered += take
        pos += n
    if verbose or len(segs) != 1 or segs[0].gap_before_bytes:
        print(
            f"salvage: {recovered}/{header.num_samples} samples recovered in "
            f"{len(segs)} segment(s), {gaps} gap(s)",
            file=sys.stderr,
        )
    wavio.write_wav(
        out_file, wavio.WavFile(wf.num_channels, wf.sampling_rate, wf.bit_per_sample, out)
    )
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = argv[0] if argv else "sla_tpu"
    spec = _make_spec()
    if len(argv) == 1:
        print(f"Usage: {prog} [options] INPUT_FILE_NAME OUTPUT_FILE_NAME")
        return 1
    positional: list[str | None] = [None, None]
    if parse_arguments(spec, argv, positional) != ParserResult.OK:
        return 1
    if get_option_acquired(spec, "help"):
        print(f"Usage: {prog} [options] INPUT_FILE_NAME OUTPUT_FILE_NAME")
        print("options:")
        print_description(spec)
        return 0
    if get_option_acquired(spec, "version"):
        print(f"SLA - Solitary Lossless Audio Compressor Version {SLA_VERSION_STRING}")
        return 0
    if positional[0] is None:
        print(f"{prog}: input file must be specified.", file=sys.stderr)
        return 1
    if get_option_acquired(spec, "info"):
        if get_option_acquired(spec, "encode") or get_option_acquired(spec, "decode"):
            print(f"{prog}: -i cannot combine with -e or -d.", file=sys.stderr)
            return 1
        # info mode reads one stream and prints; no output file needed
        enable_crc = True
        if get_option_acquired(spec, "crc-check"):
            enable_crc = get_argument_string(spec, "crc-check") == "yes"
        return do_info(positional[0], enable_crc)
    if positional[1] is None:
        print(f"{prog}: output file must be specified.", file=sys.stderr)
        return 1
    if get_option_acquired(spec, "decode") and get_option_acquired(spec, "encode"):
        print(f"{prog}: encode and decode mode cannot specify simultaneously.", file=sys.stderr)
        return 1
    if get_option_acquired(spec, "index") and not (
        get_option_acquired(spec, "encode")
        or (get_option_acquired(spec, "decode") and get_option_acquired(spec, "window"))
    ):
        # silently ignoring -x would let a user believe a sidecar was
        # written; reject like the other invalid mode combinations
        print(f"{prog}: -x requires -e (emit) or -d -w (use).", file=sys.stderr)
        return 1
    verbose = True
    if get_option_acquired(spec, "verpose"):
        verbose = True
    elif get_option_acquired(spec, "quiet"):
        verbose = False

    if get_option_acquired(spec, "decode"):
        enable_crc = True
        if get_option_acquired(spec, "crc-check"):
            # parity: the reference treats ANY value other than "yes" as
            # "no" (main.c:499-503 strcmp ternary) — do not "fix" this to
            # reject typos, it would diverge from the reference CLI
            enable_crc = get_argument_string(spec, "crc-check") == "yes"
        if get_option_acquired(spec, "batch"):
            if (get_option_acquired(spec, "window")
                    or get_option_acquired(spec, "recover")
                    or get_option_acquired(spec, "streaming")):
                print(f"{prog}: -b cannot combine with -w, -r or -s.",
                      file=sys.stderr)
                return 1
            from .corpus import decode_corpus

            in_dir = pathlib.Path(positional[0])
            files = sorted(
                p for p in in_dir.iterdir()
                if p.is_file() and p.suffix.lower() == ".sla"
            )
            if not files:
                print(f"{prog}: no SLA files in {in_dir}.", file=sys.stderr)
                return 1
            res = decode_corpus(
                files, positional[1], verbose=verbose,
                decoder_config=DecoderConfig(enable_crc_check=enable_crc),
            )
            if verbose:
                print(
                    f"corpus: {res.encoded} decoded, {res.skipped} resumed, "
                    f"{res.failed} failed, {res.seconds:.1f}s"
                )
            return 1 if res.failed else 0
        if get_option_acquired(spec, "window"):
            if get_option_acquired(spec, "recover") or get_option_acquired(spec, "streaming"):
                print(f"{prog}: -w cannot combine with -r or -s.", file=sys.stderr)
                return 1
            index_file = (get_argument_string(spec, "index")
                          if get_option_acquired(spec, "index") else None)
            if do_window_decode(positional[0], positional[1],
                                get_argument_string(spec, "window"),
                                enable_crc, verbose, index_file) != 0:
                print(f"{prog}: failed to decode {positional[0]}.", file=sys.stderr)
                return 1
        elif get_option_acquired(spec, "recover"):
            if do_salvage_decode(positional[0], positional[1], enable_crc, verbose) != 0:
                print(f"{prog}: failed to salvage {positional[0]}.", file=sys.stderr)
                return 1
        elif get_option_acquired(spec, "streaming"):
            if do_streaming_decode(positional[0], positional[1], enable_crc, verbose) != 0:
                print(f"{prog}: failed to streaming decode {positional[0]}.", file=sys.stderr)
                return 1
        else:
            if do_decode(positional[0], positional[1], enable_crc, verbose) != 0:
                print(f"{prog}: failed to decode {positional[0]}.", file=sys.stderr)
                return 1
    elif get_option_acquired(spec, "encode"):
        preset_no = DEFAULT_PRESET
        if get_option_acquired(spec, "mode"):
            try:
                preset_no = int(get_argument_string(spec, "mode"))
            except ValueError:
                preset_no = -1
            if not 0 <= preset_no < len(PRESETS):
                print(f"{prog}: encode preset number is out of range.", file=sys.stderr)
                return 1
        optimize = None
        if get_option_acquired(spec, "optimize"):
            try:
                optimize = int(get_argument_string(spec, "optimize"))
            except ValueError:
                optimize = -1
            if optimize not in (1, 2):
                print(f"{prog}: optimize effort must be 1 or 2.", file=sys.stderr)
                return 1
        if get_option_acquired(spec, "batch"):
            if optimize:
                print(f"{prog}: optimize is not supported in corpus mode.",
                      file=sys.stderr)
                return 1
            if get_option_acquired(spec, "index"):
                # the sidecar names ONE stream; corpus outputs are many
                print(f"{prog}: -x is not supported in corpus mode.",
                      file=sys.stderr)
                return 1
            from .corpus import encode_corpus

            in_dir = pathlib.Path(positional[0])
            # one pass with a case-insensitive suffix filter: two globs
            # double-list every file on case-insensitive filesystems and
            # still miss mixed-case extensions like .Wav
            files = sorted(
                p for p in in_dir.iterdir()
                if p.is_file() and p.suffix.lower() == ".wav"
            )
            if not files:
                print(f"{prog}: no WAV files in {in_dir}.", file=sys.stderr)
                return 1
            fb = 1
            if get_option_acquired(spec, "filter-batch"):
                try:
                    fb = max(int(get_argument_string(spec, "filter-batch")), 1)
                except ValueError:
                    print(f"{prog}: invalid filter-batch value.", file=sys.stderr)
                    return 1
            # corpus mode honors -V like the single-file path (the batch
            # encoder runs the same _maybe_verify self-check per file)
            res = encode_corpus(
                files, positional[1], preset=preset_no, verbose=verbose,
                filter_batch=fb,
                encoder_config=EncoderConfig(
                    verify=get_option_acquired(spec, "verify"),
                ),
            )
            if verbose:
                print(
                    f"corpus: {res.encoded} encoded, {res.skipped} resumed, "
                    f"{res.failed} failed, ratio {res.ratio:.4f}, {res.seconds:.1f}s"
                )
            return 1 if res.failed else 0
        trace_dir = get_argument_string(spec, "trace") if get_option_acquired(spec, "trace") else None
        index_file = (get_argument_string(spec, "index")
                      if get_option_acquired(spec, "index") else None)
        if do_encode(positional[0], positional[1], preset_no, verbose, trace_dir,
                     verify=get_option_acquired(spec, "verify"),
                     optimize=optimize, index_file=index_file) != 0:
            return 1
    else:
        print(f"{prog}: decode(-d) or encode(-e) option must be specified.", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
