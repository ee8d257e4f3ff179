"""Device-side recursive-Rice coding: per-symbol bit patterns and lengths
as a batched scan, leaving the host only a branch-free (value, length) pack.

This is the BASELINE.json north-star split for the entropy stage: the
per-symbol work — zigzag, the two-stage recursive Rice code with its
fixed-point parameter adaptation (SLACoder.c:26-31, 224-318), the gamma
escape — is data-parallel across (blocks x channels) rows and sequential
only in the tiny parameter state, so it runs as one `lax.scan` over the
sample axis on device. The host-side bit emission collapses to a dumb
concatenation of (value, length) parts with no per-symbol branching
(native `sla_pack_parts`).

Each symbol is emitted as up to 4 parts, each <= 33 bits so values fit
uint32 even for pathological residuals:

    part 0: the unary run   — `quot` zero bits then a 1   (quot <= 16)
    part 1: gamma zeros     — (ndigit-1) zero bits        (escape only)
    part 2: gamma value     — `ndigit` bits of v+1        (escape only)
    part 3: Rice remainder  — log2(k) low bits

The fixed-point parameters are uint64 in the reference; values stay well
under 2^53, so the scan carries them as float64-free uint64 under
jax_enable_x64 (a handful of integer ops per symbol).

The coder is a plain `lax.scan` that XLA compiles; on an H100 it made
device encode and decode several times slower end to end than the native
host coder (PERF.md), so the codec uses it only when asked
(EncoderConfig/DecoderConfig device_entropy='on', or
SLA_TPU_DEVICE_ENTROPY=1). Byte-identity with the host coder is asserted
in tests; it reads the residual already resident in device memory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .constants import (
    CODER_LOW_THRESHOLD_PARAMETER,
    CODER_NUM_RECURSIVE_RICE_PARAMETER,
    CODER_QUOTPART_THRESHOLD,
)

_FRAC = 8
_HALF = jnp.uint64(1 << (_FRAC - 1))
_M32 = jnp.uint64(0xFFFFFFFF)


def _u32(x):
    return jnp.bitwise_and(x.astype(jnp.uint64), _M32)


def _bit_length_u32(x: jnp.ndarray) -> jnp.ndarray:
    """bit_length of a uint32-valued array (0 -> 0)."""
    x32 = x.astype(jnp.uint32)
    return (32 - jax.lax.clz(x32)).astype(jnp.int32)



def _param_update(p: jnp.ndarray, code: jnp.ndarray) -> jnp.ndarray:
    """p <- (119 p + 9 * u32(code << 8) + 64) >> 7 with the uint32 wrap of
    the 9*(code<<8) term (rice.py param_update)."""
    term = _u32(jnp.uint64(9) * _u32(code.astype(jnp.uint64) << jnp.uint64(_FRAC)))
    return (jnp.uint64(119) * p + term + jnp.uint64(64)) >> jnp.uint64(7)


def _rice_param(p: jnp.ndarray) -> jnp.ndarray:
    """roundup_pow2(max(round(p/2), 1)) with the x86 shift masking
    (rice.py rice_param)."""
    h = jnp.maximum(_u32(((p >> jnp.uint64(1)) + _HALF) >> jnp.uint64(_FRAC)), jnp.uint64(1))
    bl = _bit_length_u32((h - jnp.uint64(1)).astype(jnp.uint32))
    return (jnp.uint64(1) << (bl.astype(jnp.uint64) & jnp.uint64(31)))


@functools.partial(jax.jit, static_argnames=())
def rice_encode_parts(residual: jnp.ndarray, init_params: jnp.ndarray):
    """Per-symbol code parts for a (B, L) residual batch.

    residual: (B, L) int32; init_params: (B,) uint32 initial parameters.
    Returns (values (L, B, 4) uint32, lengths (L, B, 4) int32), sample-major
    so the host pack walks symbols in stream order per row.

    Implements the 2-stage recursive Rice encoder exactly (rice.py
    put_recursive_rice); the static-Golomb low-parameter branch is decided
    per block on host and does not use this path.
    """
    assert CODER_NUM_RECURSIVE_RICE_PARAMETER == 2
    B = residual.shape[0]
    p0 = init_params.astype(jnp.uint64) << jnp.uint64(_FRAC)
    init = (_u32(p0), _u32(p0))

    def step(state, x):
        pa, pb = state  # (B,) uint64 fixed-point params
        # zigzag
        u = jnp.where(x < 0, (-2 * x.astype(jnp.int64) - 1), 2 * x.astype(jnp.int64))
        u = u.astype(jnp.uint64)
        k0 = _rice_param(pa)
        k1 = _rice_param(pb)
        in_stage0 = u < k0
        reduced = jnp.where(in_stage0, u, u - k0)
        # stage-0 symbol: unary(0)='1', rest = reduced & (k0-1) in log2(k0) bits
        k0_bits = _bit_length_u32(k0.astype(jnp.uint32)) - 1  # log2 (k0 pow2)
        k1_bits = _bit_length_u32(k1.astype(jnp.uint32)) - 1
        tail_quot = jnp.where(in_stage0, jnp.uint64(0), jnp.uint64(1) + reduced // k1)
        escape = jnp.logical_and(~in_stage0, tail_quot >= CODER_QUOTPART_THRESHOLD)
        # part 0: unary run (quot zeros + 1)
        quot = jnp.where(
            in_stage0, jnp.uint64(0),
            jnp.minimum(tail_quot, jnp.uint64(CODER_QUOTPART_THRESHOLD)),
        )
        v0 = jnp.uint32(1)
        l0 = (quot + jnp.uint64(1)).astype(jnp.int32)
        # parts 1+2: gamma(tail_quot - 16) when escaping
        gv = jnp.where(escape, tail_quot - jnp.uint64(CODER_QUOTPART_THRESHOLD), jnp.uint64(0))
        ndigit = _bit_length_u32((gv + jnp.uint64(1)).astype(jnp.uint32))  # log2ceil(gv+2)
        l1 = jnp.where(escape, ndigit - 1, 0).astype(jnp.int32)  # zeros
        v1 = jnp.uint32(0)
        l2 = jnp.where(escape, ndigit, 0).astype(jnp.int32)
        v2 = jnp.where(escape, (gv + jnp.uint64(1)).astype(jnp.uint32), jnp.uint32(0))
        # part 3: remainder bits of the landing stage
        k_land_bits = jnp.where(in_stage0, k0_bits, k1_bits)
        k_land = jnp.where(in_stage0, k0, k1)
        l3 = k_land_bits.astype(jnp.int32)  # 0 when k == 1
        v3 = (reduced & (k_land - jnp.uint64(1))).astype(jnp.uint32)
        # parameter adaptation: stage 0 always sees u; stage 1 sees u - k0
        # only when reached (rice.py put_recursive_rice update order)
        pa2 = _param_update(pa, u)
        pb2 = jnp.where(in_stage0, pb, _param_update(pb, reduced))
        values = jnp.stack([jnp.broadcast_to(v0, x.shape).astype(jnp.uint32),
                            jnp.broadcast_to(v1, x.shape).astype(jnp.uint32),
                            v2, v3], axis=-1)
        lengths = jnp.stack([l0, l1, l2, l3], axis=-1)
        return (pa2, pb2), (values, lengths)

    (_, _), (values, lengths) = jax.lax.scan(step, init, jnp.swapaxes(residual, 0, 1))
    return values, lengths  # (L, B, 4)


_M32J = jnp.uint64(0xFFFFFFFF)
_QUOT_T = CODER_QUOTPART_THRESHOLD  # 16


@functools.partial(jax.jit, static_argnames=("C", "n_max"))
def rice_decode_blocks(words, start_bits, counts, init_params, C, n_max):
    """Decode B independent recursive-Rice block payloads on device.

    The decode half of the BASELINE.json entropy split (mirror of
    SLACoder.c:470-506 semantics via rice.py get_recursive_rice): blocks
    are independent bitstreams, so B bit cursors advance in lanes of one
    batched `lax.scan` over the sample axis; within a sample the C
    channel symbols decode sequentially (channel-interleaved stream
    order), exactly like the host loop.

    words: (B, W) uint32 — per-block windows of the stream, each word the
        big-endian 32-bit group it occupies in the byte stream.
    start_bits: (B,) int32 bit offset of each payload within its window.
    counts: (B,) int32 sample count per block (rows shorter than n_max
        freeze their cursor/params once exhausted).
    init_params: (B, C) uint32 initial Rice parameters.
    Returns (residual (B, C, n_max) int32, bad (B,) bool). A `bad` block
    saw something no valid stream produces (unary run past the escape
    threshold, gamma with > 32 digits, or a cursor past the window): its
    lanes are garbage and the caller must re-decode it on host. Valid
    streams never set it, and every consumed bit / parameter update is
    value-identical to the host coder.
    """
    assert CODER_NUM_RECURSIVE_RICE_PARAMETER == 2
    B, W = words.shape
    wbits = jnp.int32(W * 32)

    def window(bp):
        """64-bit big-endian window starting at bit bp, zero-padded wish:
        out-of-range word indexes clamp (the garbage is never consumed —
        symbols end at the block boundary; clamping only keeps the gather
        in bounds)."""
        wi = bp >> 5
        off = bp & 31
        idx = jnp.clip(
            jnp.stack([wi, wi + 1, wi + 2], axis=1), 0, W - 1
        )
        g = jnp.take_along_axis(words, idx, axis=1).astype(jnp.uint64)
        hi = (g[:, 0] << jnp.uint64(32)) | g[:, 1]
        sh = off.astype(jnp.uint64)
        lo = g[:, 2] >> (jnp.uint64(32) - jnp.minimum(sh, jnp.uint64(32)))
        return (hi << sh) | jnp.where(off > 0, lo, jnp.uint64(0))

    def sym(bp, p0, p1):
        """One get_recursive_rice symbol per lane from bit cursor bp.
        Returns (bp', p0', p1', value uint64 (<= 2^32-1), bad)."""
        k0 = _rice_param(p0)
        k1 = _rice_param(p1)
        k0b = _bit_length_u32(k0.astype(jnp.uint32)) - 1  # log2 (pow2)
        k1b = _bit_length_u32(k1.astype(jnp.uint32)) - 1
        w1 = window(bp)
        quot = jax.lax.clz(w1).astype(jnp.int32)  # zero run (w1==0 -> 64)
        bp1 = bp + quot + 1
        stage1 = quot >= 1
        esc = quot >= _QUOT_T
        # gamma (rice.py get_gamma): run gz zeros, a 1, then gz value bits;
        # (1 << gz) + rest - 1 covers the gz == 0 -> 0 case too
        w2 = window(bp1)
        gz = jnp.minimum(jax.lax.clz(w2).astype(jnp.int32), 63)
        gzu = gz.astype(jnp.uint64)
        grest = jnp.where(
            gz > 0,
            (w2 >> (jnp.uint64(63) -
                    2 * jnp.minimum(gzu, jnp.uint64(31)))) &
            ((jnp.uint64(1) << gzu) - jnp.uint64(1)),
            jnp.uint64(0),
        )
        gamma = (jnp.uint64(1) << gzu) + grest - jnp.uint64(1)
        quot_u = quot.astype(jnp.uint64) + jnp.where(esc, gamma, jnp.uint64(0))
        bp2 = bp1 + jnp.where(esc, 2 * gz + 1, 0)
        # remainder bits of the landing stage
        kb_land = jnp.where(stage1, k1b, k0b)
        w3 = window(bp2)
        rest = jnp.where(
            kb_land > 0,
            w3 >> (jnp.uint64(64) -
                   jnp.maximum(kb_land, 1).astype(jnp.uint64)),
            jnp.uint64(0),
        )
        bp3 = bp2 + kb_land
        # val = k0 + k1*(quot-1) + rest on stage 1, rest on stage 0; the
        # uint64 intermediates are exact (< 2^63), the mask replicates the
        # host's uint32 wrap
        val = jnp.where(
            stage1, k0 + k1 * (quot_u - jnp.uint64(1)) + rest, rest
        ) & _M32J
        # adaptation (get_recursive_rice tail): stage 0 updates p0 with
        # val; stage 1 updates p0 with val and p1 with val - k0 (uint64
        # wrap of a corrupt negative matches the host's python semantics
        # mod 2^32; valid streams have val >= k0 here)
        p0n = _u32(_param_update(p0, val))
        p1n = jnp.where(stage1, _u32(_param_update(p1, val - k0)), p1)
        bad = (quot > _QUOT_T) | (esc & (gz > 31)) | (bp3 > wbits)
        return bp3, p0n, p1n, val, bad

    p0fix = _u32(init_params.astype(jnp.uint64) << jnp.uint64(_FRAC))
    params0 = jnp.stack([p0fix, p0fix], axis=-1)  # (B, C, 2)
    init = (
        start_bits.astype(jnp.int32),
        params0,
        jnp.zeros((B,), dtype=bool),
    )

    def step(carry, si):
        bp, params, bad = carry
        alive = si < counts
        outs = []
        for ch in range(C):  # channel-interleaved stream order
            p0 = params[:, ch, 0]
            p1 = params[:, ch, 1]
            bp_n, p0n, p1n, val, bd = sym(bp, p0, p1)
            bp = jnp.where(alive, bp_n, bp)
            params = params.at[:, ch, 0].set(jnp.where(alive, p0n, p0))
            params = params.at[:, ch, 1].set(jnp.where(alive, p1n, p1))
            bad = bad | (alive & bd)
            u = val.astype(jnp.uint32)  # unzigzag
            res = (
                (u >> jnp.uint32(1)) ^ (jnp.uint32(0) - (u & jnp.uint32(1)))
            ).astype(jnp.int32)
            outs.append(jnp.where(alive, res, 0))
        return (bp, params, bad), jnp.stack(outs, axis=-1)

    (_, _, bad), ys = jax.lax.scan(step, init, jnp.arange(n_max))
    return jnp.transpose(ys, (1, 2, 0)), bad  # (B, C, n_max), (B,)


def stream_words(data: bytes) -> np.ndarray:
    """Big-endian uint32 view of a whole stream, zero-padded so the final
    word is all-zero. Group-invariant: build it ONCE per decode call and
    pass it to decode_blocks_payload_device for every synthesis group —
    rebuilding it per group copies the entire stream each time (CLAUDE.md
    invariant 5: large per-call numpy temps page-fault at ~5µs/4KB)."""
    pad = (-len(data)) % 4
    arr = np.frombuffer(bytes(data) + b"\x00" * (4 + pad), dtype=">u4")
    # native-endian uint32 (values preserved): the per-group gather result
    # feeds jnp.asarray, which rejects non-native byte orders
    return arr.astype(np.uint32)


def decode_blocks_payload_device(
    data: bytes,
    bit_offsets: np.ndarray,
    block_bits: np.ndarray,
    counts: np.ndarray,
    init_params: np.ndarray,
    C: int,
    n_max: int,
    words_arr: np.ndarray | None = None,
):
    """Host wrapper: window packing + device decode + host fallback.

    data: the whole stream; bit_offsets: (B,) payload bit offsets;
    block_bits: (B,) payload-region sizes in bits (to the block end);
    counts: (B,) samples; init_params: (B, C) uint32 (raw header values);
    words_arr: optional stream_words(data) result, reused across groups.
    Returns (residual (B, C, n_max) int32 JAX device array, bad (B,) bool
    np) — the residual stays device-resident on purpose so the synthesis
    batch never round-trips through host memory (callers np.asarray it if
    they need host access); only `bad` is converted. `bad` blocks contain
    garbage and must be host-decoded by the caller (the decoder does, via
    native.get_data_array)."""
    B = len(bit_offsets)
    word_start = (np.asarray(bit_offsets, dtype=np.int64) // 32).astype(np.int64)
    start_bits = (np.asarray(bit_offsets, dtype=np.int64) - 32 * word_start).astype(np.int32)
    end_word = -(-(np.asarray(bit_offsets, dtype=np.int64) +
                   np.asarray(block_bits, dtype=np.int64)) // 32)
    W = int(np.max(end_word - word_start)) + 2  # window slack for reads past end
    W = -(-W // 512) * 512  # bucket the window width (2 KB granularity) so
    # successive groups with slightly different largest blocks share one
    # shape-specialized rice_decode_blocks compilation
    arr = stream_words(data) if words_arr is None else words_arr
    # one vectorized gather; mode='clip' lands out-of-range indexes on the
    # final word, which stream_words guarantees is all-zero padding
    dt = np.int32 if len(arr) + W < 2**31 else np.int64
    idx = word_start.astype(dt)[:, None] + np.arange(W, dtype=dt)
    words = np.take(arr, idx, mode="clip")
    res, bad = rice_decode_blocks(
        jnp.asarray(words),
        jnp.asarray(start_bits),
        jnp.asarray(np.asarray(counts, dtype=np.int32)),
        jnp.asarray(np.asarray(init_params, dtype=np.uint32)),
        C,
        n_max,
    )
    return res, np.asarray(bad)


def encode_block_payload_device(
    residual: np.ndarray,
    init_params: list[int],
    parts: tuple[np.ndarray, np.ndarray] | None = None,
) -> bytes:
    """Full device-coded payload for one block: returns the byte-aligned
    channel-interleaved payload, byte-identical to the host coder.

    residual: (C, n) int32. Falls back to the host coder for the static
    Golomb branch (cross-channel mean parameter <= 8). parts: optional
    precomputed ((n, C, 4) values, lengths) from a batched on-chip pass
    over the whole filter chunk (encoder._attach_device_parts) — then no
    per-block device dispatch happens at all."""
    from . import native, rice

    eff = [rice.effective_init_param(p) for p in init_params]
    if sum(eff) // len(eff) <= CODER_LOW_THRESHOLD_PARAMETER:
        return native.put_data_array(residual, init_params)
    C, n = residual.shape
    if parts is None:
        values, lengths = rice_encode_parts(
            jnp.asarray(residual), jnp.asarray(init_params, dtype=np.uint32)
        )
        v_np, l_np = np.asarray(values), np.asarray(lengths)
    else:
        v_np, l_np = parts
    # (n, C, 4) sample-major with channel-minor order == stream order
    v = np.ascontiguousarray(v_np).reshape(n * C * 4)
    l = np.ascontiguousarray(l_np).reshape(n * C * 4)
    return native.pack_parts(v, l)
