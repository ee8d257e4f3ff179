"""sla_tpu — a JAX lossless audio codec framework.

A ground-up JAX/XLA rebuild of the SLA (Solitary Lossless Audio) codec:
same container format and bit-exact interoperability with the reference C
implementation, with the per-sample filter stack re-architected as batched
device stages over a (blocks x channels) grid (GPU kernels on a GPU,
`lax.scan` elsewhere) and the bit-serial entropy stage on host.
"""

import os as _os

import jax as _jax

# Keep large scratch buffers in the heap across frees: the codec churns
# through multi-hundred-MB conversion/filter/analysis buffers per encode,
# and glibc's default returns every >128 KB block to the OS on free — each
# reuse then page-faults the whole buffer back in (microseconds per page on
# virtualized hosts; ~1 s per 200 MB measured). Raising the mmap/trim
# thresholds makes malloc recycle the heap instead. Trades steady-state RSS
# (the peak working set stays resident) for allocation speed; opt out with
# SLA_TPU_NO_MALLOPT.
if not _os.environ.get("SLA_TPU_NO_MALLOPT"):
    try:
        import ctypes as _ctypes

        _libc = _ctypes.CDLL("libc.so.6")
        _libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        _libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:
        pass

# The long-term predictor accumulates in 64-bit integers
# (SLAPredictor.c:1040-1085); enable wide types before any tracing.
_jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str | None:
    """Where the persistent compilation cache goes: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself and the program
    sets no path), else a fixed directory inside the checkout. The path is
    part of the cache key, so it must not move between runs."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


# Persistent compilation cache: the filter-stage programs are recompiled for
# every (batch, block-length) shape; caching them across processes makes
# repeated CLI/test invocations start warm. Opt out with SLA_TPU_NO_JIT_CACHE.
if not _os.environ.get("SLA_TPU_NO_JIT_CACHE"):
    if compile_cache_dir() is not None:
        _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .constants import (  # noqa: E402,F401
    SLA_FORMAT_VERSION,
    SLA_VERSION_STRING,
    BlockDataType,
    ChannelProcessMethod,
    WindowFunctionType,
)
from .decoder import Decoder, DecoderConfig, SalvageSegment, StreamIndex  # noqa: E402,F401
from .encoder import Encoder, EncoderConfig  # noqa: E402,F401
from .errors import ApiResult, SLAError  # noqa: E402,F401
from .streaming import (  # noqa: E402,F401
    DataPacketQueue,
    StreamingDecoder,
    StreamingDecoderConfig,
)
from .format import (  # noqa: E402,F401
    EncodeParameter,
    HeaderInfo,
    WaveFormat,
    decode_header,
    encode_header,
)

__version__ = SLA_VERSION_STRING

# Encode presets 0..4 (reference: src/main.c:63-70)
PRESETS = (
    EncodeParameter(8, 1, 4, ChannelProcessMethod.NONE, WindowFunctionType.RECTANGULAR, 4096),
    EncodeParameter(8, 1, 8, ChannelProcessMethod.STEREO_MS, WindowFunctionType.SIN, 12288),
    EncodeParameter(16, 1, 8, ChannelProcessMethod.STEREO_MS, WindowFunctionType.SIN, 12288),
    EncodeParameter(32, 3, 8, ChannelProcessMethod.STEREO_MS, WindowFunctionType.SIN, 12288),
    EncodeParameter(32, 3, 8, ChannelProcessMethod.STEREO_MS, WindowFunctionType.SIN, 16384),
)
DEFAULT_PRESET = 2


from .optimize import optimize_encode  # noqa: E402,F401


def preset_parameter(preset_no: int, num_channels: int) -> EncodeParameter:
    """Preset's encode parameter for a given channel count: MS only applies
    to actual stereo sources (reference main.c:124-130)."""
    p = PRESETS[preset_no]
    ch_method = (
        p.ch_process_method if num_channels == 2 else ChannelProcessMethod.NONE
    )
    return EncodeParameter(
        p.parcor_order, p.longterm_order, p.lms_order_per_filter,
        ch_method, p.window_function_type, p.max_num_block_samples,
    )
