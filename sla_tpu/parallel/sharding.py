"""Multi-chip sharding of the codec over a `jax.sharding.Mesh`.

The reference encoder iterates two serial axes in one thread: blocks
(SLAEncoder.c:846 `while (encode_offset_sample < num_samples)`) and channels
(SLAEncoder.c:531 `for (ch = 0; ...)`). Here those axes become mesh axes:

    mesh ('blocks', 'channels')   batch rows = blocks x channels

* **blocks** is the sequence-parallel axis: the format resets every filter at
  block start (SLADecoder.c:637-639), so blocks are fully independent — this
  is data parallelism over the sample dimension with zero halo exchange.
* **channels** shards the per-block channel grid (and, at corpus scale, whole
  files round-robin).

The only cross-shard coordination the format requires is the header
statistics — `max_block_size` / `max_bit_per_second` are maxima over all
blocks (SLAEncoder.c:890-898) — and the stream-offset prefix sum over encoded
block byte lengths (SLAEncoder.c:887). Both ride one collective here
(`jax.lax.pmax` / cumulative sum), instead of being serial loop state.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCK_AXIS = "blocks"
CHANNEL_AXIS = "channels"


def make_mesh(devices=None, channel_parallel: int | None = None) -> Mesh:
    """Build a ('blocks', 'channels') mesh over the given devices.

    `channel_parallel` devices are assigned to the channel axis; the rest go
    to the (always larger) block axis. None reads SLA_TPU_MESH_CHANNELS
    (default 1, pure block parallelism) — the knob the full-pipeline
    backend='mesh' paths honor when the stream's channel count divides it.
    """
    if channel_parallel is None:
        import os

        channel_parallel = max(int(os.environ.get("SLA_TPU_MESH_CHANNELS", "1")), 1)
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % channel_parallel != 0:
        raise ValueError(f"{n} devices not divisible by channel_parallel={channel_parallel}")
    grid = np.asarray(devices).reshape(n // channel_parallel, channel_parallel)
    return Mesh(grid, (BLOCK_AXIS, CHANNEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (num_blocks, num_channels, L) batches: blocks and
    channels across the mesh, samples replicated within a row (the sample
    scan is sequential inside each block — SURVEY §7)."""
    return NamedSharding(mesh, P(BLOCK_AXIS, CHANNEL_AXIS, None))


def _mesh_impl(mesh: Mesh) -> str:
    """The filter implementation every shard runs: the GPU kernels on a GPU
    mesh, the scans elsewhere (pipeline.filter_impl)."""
    from ..pipeline import filter_impl

    return filter_impl(mesh.devices.flat[0].platform)


def _reject_assert_mode() -> None:
    """checkify.check calls embedded by SLA_TPU_DEBUG_ASSERTS=1 cannot be
    functionalized through shard_map; fail with a clear message (at trace
    time) instead of the cryptic 'cannot abstractly evaluate' error. The
    encoder demotes mesh to the checkified single-device path
    automatically."""
    from .. import debug

    if debug.asserts_enabled():
        from ..errors import ApiResult, SLAError

        raise SLAError(
            ApiResult.INVALID_ARGUMENT,
            "SLA_TPU_DEBUG_ASSERTS is not supported on the mesh path",
        )


_ROWS = P(BLOCK_AXIS, CHANNEL_AXIS, None)  # (NB, NC, ...) per-row arrays
_ROW = P(BLOCK_AXIS, CHANNEL_AXIS)  # (NB, NC) per-row scalars


def _rows_map(local, mesh: Mesh, in_specs, out_specs):
    """shard_map over (blocks, channels). The bodies run the single-device
    stage functions per shard, whose scan carries and kernel outputs carry
    no varying-axes annotation, so the check is off."""
    return jax.shard_map(
        local, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )


def _flat(x):
    """(nb, nc, ...) shard -> (nb*nc, ...) rows."""
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


@functools.partial(
    jax.jit,
    static_argnames=("parcor_order", "num_taps", "lms_order", "mesh", "impl"),
)
def _encode_step(data, parcor_coef, pitch, ltm_coef, parcor_order, num_taps,
                 lms_order, mesh, impl):
    from ..pipeline import stage1_rows, stage2_rows

    def local(data, parcor_coef, pitch, ltm_coef):
        nb, nc, L = data.shape
        r1 = stage1_rows(_flat(data), _flat(parcor_coef), parcor_order, impl)
        out = stage2_rows(
            r1, _flat(pitch), _flat(ltm_coef), num_taps, lms_order, impl
        )
        # zigzag magnitude sum -> initial Rice parameter numerator
        zz = jnp.where(out < 0, -2 * out.astype(jnp.int64) - 1, 2 * out.astype(jnp.int64))
        abs_sum = zz.sum(axis=1)
        # crude per-row bit-length estimate: 2 + log2(mean) bits/sample
        mean = jnp.maximum(abs_sum // L, 1)
        bits = (2 + jnp.log2(mean.astype(jnp.float32))) * L
        local_max = jnp.max(bits)
        # header statistic: global max over every shard (one collective)
        gmax = jax.lax.pmax(jax.lax.pmax(local_max, BLOCK_AXIS), CHANNEL_AXIS)
        return out.reshape(nb, nc, L), abs_sum.reshape(nb, nc), gmax

    return _rows_map(
        local, mesh, (_ROWS, _ROWS, _ROW, _ROWS), (_ROWS, _ROW, P())
    )(data, parcor_coef, pitch, ltm_coef)


def sharded_encode_step(
    data: jnp.ndarray,
    parcor_coef: jnp.ndarray,
    pitch: jnp.ndarray,
    ltm_coef: jnp.ndarray,
    parcor_order: int,
    num_taps: int,
    lms_order: int,
    mesh: Mesh,
):
    """One sharded encode filter step over the whole mesh.

    data: (NB, NC, L) int32 sharded (blocks, channels); parcor_coef:
    (NB, NC, p); pitch: (NB, NC); ltm_coef: (NB, NC, T).

    Returns (residual (NB, NC, L), abs_sum (NB, NC), global_max_bitlen ()):
    the final residual, the per-row zigzag magnitude sum (the initial Rice
    parameter numerator, SLACoder.c:361-385), and the globally reduced
    maximum estimated payload bit length: a crude 2+log2(mean) finiteness
    statistic over the PADDED row length (demonstrating the cross-shard
    pmax collective; zero padding dilutes the mean) — NOT the exact
    `max_block_size` header field, which the host computes from the real
    encoded block sizes (SLAEncoder.c:890-898). Callers use it only as a
    sharded-reduction smoke value.
    """
    _reject_assert_mode()
    return _encode_step(data, parcor_coef, pitch, ltm_coef, parcor_order,
                        num_taps, lms_order, mesh, _mesh_impl(mesh))


@functools.partial(jax.jit, static_argnames=("parcor_order", "mesh", "impl"))
def _encode_stage1(data, parcor_coef, parcor_order, mesh, impl):
    from ..pipeline import stage1_rows

    def local(data, parcor_coef):
        out = stage1_rows(_flat(data), _flat(parcor_coef), parcor_order, impl)
        return out.reshape(data.shape)

    return _rows_map(local, mesh, (_ROWS, _ROWS), _ROWS)(data, parcor_coef)


def sharded_encode_stage1(
    data: jnp.ndarray, parcor_coef: jnp.ndarray, parcor_order: int, mesh: Mesh
):
    """Mesh-sharded pre-emphasis + lattice predict over (NB, NC, L) batches
    (the first half of the encode cascade; pitch analysis sits between the
    stages on host, so full-file encode needs the split)."""
    from ..pipeline import DISPATCH

    _reject_assert_mode()
    impl = _mesh_impl(mesh)
    DISPATCH["stage1", impl] += 1
    return _encode_stage1(data, parcor_coef, parcor_order, mesh, impl)


@functools.partial(
    jax.jit, static_argnames=("num_taps", "lms_order", "mesh", "impl")
)
def _encode_stage2(residual, pitch, ltm_coef, num_taps, lms_order, mesh, impl):
    from ..pipeline import stage2_rows

    def local(residual, pitch, ltm_coef):
        out = stage2_rows(
            _flat(residual), _flat(pitch), _flat(ltm_coef), num_taps,
            lms_order, impl,
        )
        return out.reshape(residual.shape)

    return _rows_map(local, mesh, (_ROWS, _ROW, _ROWS), _ROWS)(
        residual, pitch, ltm_coef
    )


def sharded_encode_stage2(
    residual: jnp.ndarray,
    pitch: jnp.ndarray,
    ltm_coef: jnp.ndarray,
    num_taps: int,
    lms_order: int,
    mesh: Mesh,
):
    """Mesh-sharded long-term + LMS predict (second half of the cascade)."""
    from ..pipeline import DISPATCH

    _reject_assert_mode()
    impl = _mesh_impl(mesh)
    DISPATCH["stage2", impl] += 1
    return _encode_stage2(residual, pitch, ltm_coef, num_taps, lms_order,
                          mesh, impl)


@functools.partial(
    jax.jit,
    static_argnames=(
        "parcor_order", "num_taps", "lms_order", "mesh", "impl", "lt_chunk",
    ),
)
def _decode_step(residual, parcor_coef, pitch, ltm_coef, parcor_order,
                 num_taps, lms_order, mesh, impl, lt_chunk):
    from ..pipeline import synth_rows

    def local(residual, parcor_coef, pitch, ltm_coef):
        out = synth_rows(
            _flat(residual), _flat(parcor_coef), _flat(pitch),
            _flat(ltm_coef), parcor_order, num_taps, lms_order, impl,
            lt_chunk=lt_chunk,
        )
        return out.reshape(residual.shape)

    return _rows_map(local, mesh, (_ROWS, _ROWS, _ROW, _ROWS), _ROWS)(
        residual, parcor_coef, pitch, ltm_coef
    )


def sharded_decode_step(
    residual: jnp.ndarray,
    parcor_coef: jnp.ndarray,
    pitch: jnp.ndarray,
    ltm_coef: jnp.ndarray,
    parcor_order: int,
    num_taps: int,
    lms_order: int,
    mesh: Mesh,
    lt_chunk: int = 1,
):
    """Mesh-sharded synthesis: the decode mirror of sharded_encode_step.

    lt_chunk: samples per long-term scan step on the scan path; the caller
    derives it from the batch's concrete pitches (pipeline._longterm_chunk).

    residual: (NB, NC, L) int32 sharded (blocks, channels). Returns PCM rows
    prior to the MS inverse / final left shift. Blocks decode with zero
    cross-shard communication — the format's reset-at-block-start invariant
    (SLADecoder.c:637-639) is what makes the whole stream embarrassingly
    block-parallel."""
    from ..pipeline import DISPATCH

    _reject_assert_mode()
    impl = _mesh_impl(mesh)
    DISPATCH["synth", impl] += 1
    return _decode_step(residual, parcor_coef, pitch, ltm_coef, parcor_order,
                        num_taps, lms_order, mesh, impl,
                        lt_chunk if impl == "scan" else 1)


def shard_batch(mesh: Mesh, *arrays):
    """Device-put each (NB, NC, ...) array with the mesh batch sharding."""
    out = []
    for a in arrays:
        spec = P(BLOCK_AXIS, CHANNEL_AXIS, *([None] * (a.ndim - 2)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)
