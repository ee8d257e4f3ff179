"""Jitted device pipelines: batched filter stages over a (blocks*channels, L)
grid.

The reference runs its per-sample filters serially per channel per block
(SLAEncoder.c:531-672, SLADecoder.c:494-537). Here every block and channel is
one row of a batch. Stage split on the encode side exists because the
long-term (pitch) analysis is a host-side float64 FFT step that needs the
PARCOR residual as input (SLAEncoder.c:620):

    stage1: pre-emphasis -> lattice predict              (device)
    pitch analysis                                        (host, analysis/)
    stage2: long-term predict -> LMS predict              (device)

Decode is one fused device stage: LMS synth -> long-term synth -> lattice
synth -> de-emphasis.

Each stage has two bit-identical implementations: the GPU kernels of
kernels/gpu_filters.py (one thread per row, sample loop inside), chosen
for arrays that live on a GPU, and the batched `lax.scan` twins of
kernels/{emphasis,lattice,lms,longterm}.py, which serve every other
platform and are the reference the kernels are tested against. `DISPATCH`
counts which one each call took.
"""

from __future__ import annotations

import collections
import functools

import jax
import jax.numpy as jnp

from .kernels import gpu_filters
from .kernels.emphasis import de_emphasis, pre_emphasis
from .kernels.lattice import lattice_init_state, lattice_predict, lattice_synthesize
from .kernels.lms import lms_init_state, lms_predict, lms_synthesize
from .kernels.longterm import longterm_init_state, longterm_predict, longterm_synthesize

# Row-samples (rows x block length) from which backend='auto' moves a
# filter batch off the native host cascade onto a live GPU. On one H100
# (400 W limit) CD-stereo preset-2 files from 2 s to 320 s (0.18M-28.2M
# row-samples) showed no crossover: the host path encoded as fast or
# faster (1.0-1.4x) and decoded ~2x faster at every size (PERF.md, "Kernel
# findings"). So the threshold sits past every batch the encoder forms
# (filter chunks stay under ~22M) and any file short of ~6.8 hours of CD
# stereo. SLA_TPU_DEVICE_THRESHOLD overrides it.
DEVICE_MIN_ROW_SAMPLES = 1 << 31

# (stage, implementation) -> calls, e.g. ("synth", "kernel"): which
# implementation each dispatch picked in this process.
DISPATCH: collections.Counter = collections.Counter()


@jax.jit
def _fits_i16(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.all((x >= -32768) & (x <= 32767))


@jax.jit
def _to_i16(x: jnp.ndarray) -> jnp.ndarray:
    return x.astype(jnp.int16)


def fetch_int32(x_dev) -> "np.ndarray":
    """Fetch a device int32 array, halving the transfer when every value
    fits in int16 (residuals usually do). One extra scalar round-trip for
    the range check."""
    import numpy as np

    if bool(_fits_i16(x_dev)):
        return np.asarray(_to_i16(x_dev)).astype(np.int32)
    return np.asarray(x_dev)


def _platform(x) -> str:
    """Platform of the device a (concrete) array lives on."""
    return next(iter(x.devices())).platform


def filter_impl(platform: str) -> str:
    """'kernel' (kernels/gpu_filters.py) on a GPU, 'scan' elsewhere."""
    return "kernel" if platform == "gpu" else "scan"


@functools.partial(jax.jit, static_argnames=("parcor_order",))
def _encode_stage1_scan(data: jnp.ndarray, parcor_coef: jnp.ndarray, parcor_order: int):
    B = data.shape[0]
    emphasized, _ = pre_emphasis(data, jnp.zeros((B,), jnp.int32))
    residual, _ = lattice_predict(emphasized, parcor_coef, lattice_init_state(B, parcor_order))
    return residual


def stage1_rows(data, parcor_coef, parcor_order: int, impl: str):
    """Stage 1 with a given implementation; traceable (the mesh bodies
    call it per shard)."""
    if impl == "kernel":
        return gpu_filters.stage1(data, parcor_coef, parcor_order)
    return _encode_stage1_scan(data, parcor_coef, parcor_order)


def encode_stage1(data: jnp.ndarray, parcor_coef: jnp.ndarray, parcor_order: int):
    """data: (B, L) int32, parcor_coef: (B, p) int32 (orders 1..p).

    Returns the PARCOR residual (B, L)."""
    from . import debug

    if debug.asserts_enabled():
        # the lattice kernel's debug checks (kernels/lattice.py) need the
        # checkify functionalization, like stage 2 / decode below
        return debug.run_checked(
            _encode_stage1_scan, data, parcor_coef, parcor_order=parcor_order
        )
    impl = filter_impl(_platform(data))
    DISPATCH["stage1", impl] += 1
    return stage1_rows(data, parcor_coef, parcor_order, impl)


def _longterm_predict_gated(residual, pitch, ltm_coef, num_taps):
    """Shared long-term predict prelude of the encode stage-2 scan: rows
    with pitch == 0 pass through unchanged (the gating pattern every
    backend shares bit-identically — the GPU kernel and the native
    cascade gate the same way)."""
    if num_taps <= 0:
        return residual
    B = residual.shape[0]
    lt_res, _ = longterm_predict(
        residual, pitch, ltm_coef, num_taps, jnp.zeros((B,), jnp.int32)
    )
    return jnp.where((pitch > 0)[:, None], lt_res, residual)


@functools.partial(jax.jit, static_argnames=("num_taps", "lms_order"))
def _encode_stage2_scan(
    residual: jnp.ndarray,
    pitch: jnp.ndarray,
    ltm_coef: jnp.ndarray,
    num_taps: int,
    lms_order: int,
):
    B = residual.shape[0]
    residual = _longterm_predict_gated(residual, pitch, ltm_coef, num_taps)
    out, _ = lms_predict(residual, lms_init_state(B, lms_order), lms_order)
    return out


def stage2_rows(residual, pitch, ltm_coef, num_taps: int, lms_order: int,
                impl: str):
    """Stage 2 with a given implementation; traceable."""
    if impl == "kernel":
        return gpu_filters.stage2(residual, pitch, ltm_coef, num_taps, lms_order)
    return _encode_stage2_scan(residual, pitch, ltm_coef, num_taps, lms_order)


def encode_stage2(
    residual: jnp.ndarray,
    pitch: jnp.ndarray,
    ltm_coef: jnp.ndarray,
    num_taps: int,
    lms_order: int,
):
    """residual: (B, L) PARCOR residual; pitch: (B,) int32 (0 disables the
    long-term stage for that row); ltm_coef: (B, T) int32 Q31.

    Returns the final residual (B, L) handed to the entropy coder."""
    from . import debug

    if debug.asserts_enabled():
        return debug.run_checked(
            _encode_stage2_scan, residual, pitch, ltm_coef,
            num_taps=num_taps, lms_order=lms_order,
        )
    impl = filter_impl(_platform(residual))
    DISPATCH["stage2", impl] += 1
    return stage2_rows(residual, pitch, ltm_coef, num_taps, lms_order, impl)


@functools.partial(jax.jit, static_argnames=("parcor_order", "num_taps", "lms_order"))
def encode_filters(
    data: jnp.ndarray,
    parcor_coef: jnp.ndarray,
    pitch: jnp.ndarray,
    ltm_coef: jnp.ndarray,
    parcor_order: int,
    num_taps: int,
    lms_order: int,
):
    """Full encode-side filter cascade in one compiled program: pre-emphasis
    -> lattice predict -> long-term predict -> LMS predict, as scans. The
    reference for the sharded encode step when pitch/long-term
    coefficients are already known.

    data: (B, L) int32; parcor_coef: (B, p); pitch: (B,); ltm_coef: (B, T).
    Returns the final residual handed to the entropy coder.
    """
    residual = _encode_stage1_scan(data, parcor_coef, parcor_order)
    return _encode_stage2_scan(residual, pitch, ltm_coef, num_taps, lms_order)


@functools.partial(
    jax.jit, static_argnames=("parcor_order", "num_taps", "lms_order", "lt_chunk")
)
def _decode_stage_scan(
    residual: jnp.ndarray,
    parcor_coef: jnp.ndarray,
    pitch: jnp.ndarray,
    ltm_coef: jnp.ndarray,
    parcor_order: int,
    num_taps: int,
    lms_order: int,
    lt_chunk: int = 1,
):
    B = residual.shape[0]
    out, _ = lms_synthesize(residual, lms_init_state(B, lms_order), lms_order)
    if num_taps > 0:
        lt_out, _ = longterm_synthesize(
            out, pitch, ltm_coef, num_taps, longterm_init_state(B), chunk=lt_chunk
        )
        out = jnp.where((pitch > 0)[:, None], lt_out, out)
    out, _ = lattice_synthesize(out, parcor_coef, lattice_init_state(B, parcor_order))
    out, _ = de_emphasis(out, jnp.zeros((B,), jnp.int32))
    return out


def synth_rows(residual, parcor_coef, pitch, ltm_coef, parcor_order: int,
               num_taps: int, lms_order: int, impl: str, lt_chunk: int = 1):
    """The decode cascade with a given implementation; traceable. lt_chunk
    applies to the scan only (see _longterm_chunk)."""
    if impl == "kernel":
        return gpu_filters.synth(
            residual, parcor_coef, pitch, ltm_coef, parcor_order, num_taps,
            lms_order,
        )
    return _decode_stage_scan(
        residual, parcor_coef, pitch, ltm_coef, parcor_order, num_taps,
        lms_order, lt_chunk=lt_chunk,
    )


def decode_stage(
    residual: jnp.ndarray,
    parcor_coef: jnp.ndarray,
    pitch: jnp.ndarray,
    ltm_coef: jnp.ndarray,
    parcor_order: int,
    num_taps: int,
    lms_order: int,
):
    """Full synthesis chain for a batch of compressed blocks.

    residual: (B, L) int32 entropy-decoded residual. Returns PCM rows prior
    to the MS inverse / final left shift."""
    from . import debug

    if debug.asserts_enabled():
        return debug.run_checked(
            _decode_stage_scan, residual, parcor_coef, pitch, ltm_coef,
            parcor_order=parcor_order, num_taps=num_taps, lms_order=lms_order,
        )
    impl = filter_impl(_platform(residual))
    DISPATCH["synth", impl] += 1
    lt_chunk = (
        _longterm_chunk(pitch, num_taps, residual.shape[1]) if impl == "scan" else 1
    )
    return synth_rows(
        residual, parcor_coef, pitch, ltm_coef, parcor_order, num_taps,
        lms_order, impl, lt_chunk=lt_chunk,
    )


def _live_platform() -> tuple[str, int] | None:
    """(platform, device count) of the default JAX backend if one is
    already initialized in this process, else None — without starting one."""
    try:
        from jax._src import xla_bridge

        if not xla_bridge._backends:
            return None
    except Exception:
        return None
    return jax.default_backend(), len(jax.devices())


def select_backend(configured: str, row_samples: int) -> str:
    """Shared filter-backend selection for the encoder and decoder handles:
    'host' (native C++ cascade) for batches too small to amortize device
    dispatch, 'device' (one GPU) / 'mesh' (several, or a multi-device CPU
    runtime) for big batches.

    'auto' never starts a JAX backend itself: the device tiers are
    considered only when one is already live in this process. A CUDA
    client reserves most of the card's memory when it starts, so a CLI run
    that stays on the host must not grab the card."""
    import os

    from . import native

    if configured != "auto":
        return configured
    if not native.available():
        return "device"
    try:
        threshold = int(
            os.environ.get("SLA_TPU_DEVICE_THRESHOLD", DEVICE_MIN_ROW_SAMPLES)
        )
    except ValueError:  # malformed knob: fall back like SLA_TPU_THREADS
        threshold = DEVICE_MIN_ROW_SAMPLES
    if row_samples < threshold:
        return "host"
    live = _live_platform()
    if live is None:
        return "host"
    plat, ndev = live
    if plat == "gpu":
        return "mesh" if ndev > 1 else "device"
    if plat == "cpu" and ndev > 1:
        # multi-device CPU runtime (xla_force_host_platform_device_count or
        # a real multi-host CPU mesh): shard the batch
        return "mesh"
    return "host"


def device_entropy_on(config) -> bool:
    """Shared device-entropy policy for the Encoder and Decoder handles
    (one definition so the two sides cannot drift). The host coder is the
    default on every backend: on an H100 the on-chip symbol coder
    (rice_device.py, a per-symbol `lax.scan`) made device encode and
    decode several times slower end to end than the native host coder, at
    every file size measured (PERF.md, "Kernel findings").
    config.device_entropy='on' asks for the on-chip coder ('auto' and
    'off' keep the host coder); SLA_TPU_DEVICE_ENTROPY overrides the config
    on any backend (both directions then land/lift the batch across the
    host/device boundary themselves). The env value is parsed:
    '0'/'off'/'false'/'no' force it OFF, anything else non-empty forces it
    ON, unset/empty defers to the config."""
    import os

    v = os.environ.get("SLA_TPU_DEVICE_ENTROPY", "").strip().lower()
    if v:
        return v not in ("0", "off", "false", "no")
    return getattr(config, "device_entropy", "auto") == "on"


def _longterm_chunk(pitch, num_taps: int, length: int) -> int:
    """Largest power-of-two scan chunk (<= 64) that every active row's
    feedback lag permits: the shallowest read is max_delay - (num_taps-1)
    = pitch + num_taps//2 - num_taps + 1 samples back, so any chunk <=
    the batch's minimum active lag only ever reads carried history.
    Called outside jit — pitch is concrete; batches without long-term
    rows take the cap.

    The chunked scan's per-row dynamic slices win ~30x over the
    per-sample scan on CPU, the only platform the scan decodes on in
    production (a GPU runs kernels/gpu_filters.synth)."""
    if num_taps <= 0:
        return 1
    import numpy as np

    if isinstance(pitch, jax.core.Tracer):
        return 1  # under an outer jit the pitches aren't concrete
    p = np.asarray(pitch)
    active = p[p > 0]
    lag = (
        int(active.min()) + num_taps // 2 - (num_taps - 1) if active.size else 64
    )
    chunk = 64
    while chunk > 1 and (lag < chunk or length % chunk):
        chunk >>= 1
    return chunk
