"""Long-term (pitch) prediction filter.

Reference semantics (src/SLAPredictor.c:1031-1130): with pitch period P and
T taps (odd), max_delay = P + T//2, Q31 coefficients and rounding constant
1<<30 in a 64-bit accumulator:

    pred[n] = (2^30 + sum_j coef[j] * hist[n - P - T//2 + j]) >> 31
    predict:    out[n] = in[n] - pred[n],  hist = in
    synthesize: out[n] = in[n] + pred[n],  hist = out
    first max_delay samples pass through unchanged (state warmup);
    pitch 0 = passthrough.

Because encoder coefficients are Q15 values shifted left 16
(SLAEncoder.c:634-640, SLADecoder.c:400-404), the bottom 16 bits of every
coefficient are zero, so the Q31 accumulation reduces exactly to

    pred[n] = (sum_j q15[j] * hist[...] + 2^14) >> 15

with q15 = coef >> 16 — one 64-bit dot product of <= 5 terms.

Batched shape: *prediction* history is the input signal, so the whole filter is
a short FIR — fully vectorized, no scan. *Synthesis* is recurrent (history is
the output); it runs as a scan carrying a (B, max_delay) ring, with the tap
pattern pre-scattered into a dense kernel so each step is one masked dot.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import LONGTERM_MAX_PERIOD

_MAX_DELAY = LONGTERM_MAX_PERIOD + 2  # pitch < 256, taps <= 5 -> delay <= 258


def _q15(coef: jnp.ndarray) -> jnp.ndarray:
    return (coef >> 16).astype(jnp.int64)


def longterm_predict(
    data: jnp.ndarray,
    pitch: jnp.ndarray,
    coef: jnp.ndarray,
    num_taps: int,
    processed: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FIR residual computation, vectorized over samples.

    data: (B, N) int32; pitch: (B,) int32 (0 = passthrough);
    coef: (B, T) int32 Q31; processed: (B,) int32 count of samples already
    seen — ONLY the warmup gate (samples before max_delay pass through);
    the tap history is read from THIS chunk alone (zero-filled before
    position 0), so a resumed call with processed > 0 does NOT see the
    previous chunk's samples. Whole-block calls (every current caller
    passes zeros) are exact; chunked resumption would need carried
    history like the native resumable cascade. Returns (residual, count).
    """
    B, N = data.shape
    q = _q15(coef)  # (B, T)
    max_delay = pitch + (num_taps // 2)  # (B,)
    acc = jnp.zeros((B, N), dtype=jnp.int64)
    n_idx = jnp.arange(N, dtype=jnp.int32)[None, :]
    for j in range(num_taps):
        # hist index: n - pitch - T//2 + j ; realized by per-row dynamic roll
        delay = max_delay - j  # (B,)
        shifted = _delay_rows(data, delay).astype(jnp.int64)
        acc = acc + q[:, j : j + 1] * shifted
    pred = ((acc + (1 << 14)) >> 15).astype(jnp.int32)
    pos = processed[:, None] + n_idx  # absolute sample index within the block
    active = (pitch[:, None] > 0) & (pos >= max_delay[:, None])
    out = jnp.where(active, data - pred, data)
    return out, processed + N


def _delay_rows(x: jnp.ndarray, delay: jnp.ndarray) -> jnp.ndarray:
    """Shift each row right by its own delay, zero-filling: out[b, n] =
    x[b, n - delay[b]] (0 where n < delay[b]).

    Realized as a vmapped dynamic slice of the zero-padded row: the
    row-constant shift makes the gather formulation (take_along_axis)
    needless."""
    B, N = x.shape
    pad = jnp.concatenate([jnp.zeros((B, _MAX_DELAY), x.dtype), x], axis=1)
    start = (_MAX_DELAY - delay).astype(jnp.int32)  # delay <= _MAX_DELAY
    return jax.vmap(
        lambda row, st: jax.lax.dynamic_slice_in_dim(row, st, N)
    )(pad, start)


def longterm_synthesize(
    residual: jnp.ndarray,
    pitch: jnp.ndarray,
    coef: jnp.ndarray,
    num_taps: int,
    state: tuple[jnp.ndarray, jnp.ndarray],
    chunk: int = 1,
) -> tuple[jnp.ndarray, tuple[jnp.ndarray, jnp.ndarray]]:
    """Recurrent synthesis via scan.

    residual: (B, N) int32; state = (hist, processed): hist (B, _MAX_DELAY)
    holds the last samples, newest at index -1; processed (B,) int32.

    chunk (static): samples per scan step. The feedback lag of an active
    row is max_delay - (num_taps - 1) = pitch - num_taps//2, so any
    chunk <= the batch's minimum active lag reads only carried history —
    the caller certifies that bound (decode_stage computes it host-side).
    Per-sample arithmetic is identical for any chunk (exact int64 sums).
    """
    B, N = residual.shape
    if chunk > 1 and N % chunk == 0:
        return _longterm_synthesize_chunked(
            residual, pitch, coef, num_taps, state, chunk
        )
    q = _q15(coef)  # (B, T)
    max_delay = (pitch + (num_taps // 2)).astype(jnp.int32)  # (B,)
    hist, processed = state
    D = hist.shape[1]
    if num_taps == 1:
        # Single-tap fast path (the default preset): the dense history dot
        # reduces to an int32 one-hot select — the sum has exactly one
        # nonzero term, so it is exact in int32, and the only int64
        # arithmetic is the q * sample product per row — no int64 dense
        # dot. Bit-identical.
        d_idx = jnp.arange(D, dtype=jnp.int32)[None, :]
        mask = (d_idx == (D - max_delay)[:, None]).astype(jnp.int32)  # (B, D)
        active_row1 = pitch > 0
        q0 = q[:, 0]

        from .. import debug

        embed_asserts = debug.asserts_enabled()

        def step1(carry, r):
            h, t = carry  # h: (B, D) int32
            sel = jnp.sum(mask * h, axis=1)  # single nonzero -> exact
            pred64 = (q0 * sel.astype(jnp.int64) + (1 << 14)) >> 15
            if embed_asserts:
                # the reference computes the prediction in int64 and casts
                # to int32 (SLAPredictor.c:1083-1087, cast at the update);
                # assert the cast is value-preserving, mirroring the LMS
                # overflow asserts' intent (SLAPredictor.c:1265-1271)
                debug.check(
                    jnp.all((pred64 <= jnp.int64(2**31 - 1))
                            & (pred64 >= jnp.int64(-(2**31)))),
                    "long-term prediction overflows int32",
                )
            pred = pred64.astype(jnp.int32)
            use = active_row1 & (t >= max_delay)
            out = jnp.where(use, r + pred, r)
            h = jnp.concatenate([h[:, 1:], out[:, None]], axis=1)
            return (h, t + 1), out

        (hist, processed), out_t = jax.lax.scan(
            step1, (hist, processed), jnp.swapaxes(residual, 0, 1)
        )
        return jnp.swapaxes(out_t, 0, 1), (hist, processed)
    # Dense kernel over history positions: hist[:, D-1-k] is the sample k+1
    # steps back; tap j reads n - (max_delay - j) -> k+1 = max_delay - j.
    d_idx = jnp.arange(D, dtype=jnp.int32)[None, :]  # position from the end
    kern = jnp.zeros((B, D), dtype=jnp.int64)
    for j in range(num_taps):
        back = max_delay - j  # samples back (>= 1)
        pos = D - back  # index into hist
        kern = kern.at[jnp.arange(B), pos].add(q[:, j])
    active_row = pitch > 0

    from .. import debug

    embed_asserts = debug.asserts_enabled()

    def step(carry, r):
        h, t = carry  # h: (B, D) int64, t: (B,) int32
        s = jnp.sum(kern * h, axis=1)
        pred64 = (s + (1 << 14)) >> 15
        if embed_asserts:
            debug.check(
                jnp.all((pred64 <= jnp.int64(2**31 - 1))
                        & (pred64 >= jnp.int64(-(2**31)))),
                "long-term prediction overflows int32",
            )
        pred = pred64.astype(jnp.int32)
        use = active_row & (t >= max_delay)
        out = jnp.where(use, r + pred, r)
        h = jnp.concatenate([h[:, 1:], out[:, None].astype(jnp.int64)], axis=1)
        return (h, t + 1), out

    (hist, processed), out_t = jax.lax.scan(
        step, (hist.astype(jnp.int64), processed), jnp.swapaxes(residual, 0, 1)
    )
    return jnp.swapaxes(out_t, 0, 1), (hist.astype(jnp.int32), processed)


def _longterm_synthesize_chunked(
    residual: jnp.ndarray,
    pitch: jnp.ndarray,
    coef: jnp.ndarray,
    num_taps: int,
    state: tuple[jnp.ndarray, jnp.ndarray],
    chunk: int,
) -> tuple[jnp.ndarray, tuple[jnp.ndarray, jnp.ndarray]]:
    """chunk samples per scan step: every read of an active row reaches at
    least `chunk` samples back (caller-certified), so a whole chunk's
    predictions come from the carried ring — num_taps vmapped dynamic
    slices + multiplies per step instead of a dense history dot per
    sample. Inactive rows (pitch 0) pass through; their clipped reads are
    discarded by the `use` mask."""
    B, N = residual.shape
    q = _q15(coef)  # (B, T)
    max_delay = (pitch + (num_taps // 2)).astype(jnp.int32)  # (B,)
    hist, processed = state
    D = hist.shape[1]
    c_idx = jnp.arange(chunk, dtype=jnp.int32)[None, :]
    # start of the slice for tap j: position of the sample (max_delay - j)
    # steps before the chunk, clipped in-bounds for inactive rows
    starts = [
        jnp.clip(D - (max_delay - j), 0, D - chunk).astype(jnp.int32)
        for j in range(num_taps)
    ]
    slice_rows = jax.vmap(
        lambda row, st: jax.lax.dynamic_slice_in_dim(row, st, chunk)
    )
    active_row = pitch > 0
    from .. import debug

    embed_asserts = debug.asserts_enabled()

    def step(carry, r):
        h, t = carry  # h: (B, D) int64, t: (B,) int32
        acc = jnp.zeros((B, chunk), dtype=jnp.int64)
        for j in range(num_taps):
            acc = acc + q[:, j : j + 1] * slice_rows(h, starts[j])
        pred64 = (acc + (1 << 14)) >> 15
        if embed_asserts:
            debug.check(
                jnp.all((pred64 <= jnp.int64(2**31 - 1))
                        & (pred64 >= jnp.int64(-(2**31)))),
                "long-term prediction overflows int32",
            )
        pred = pred64.astype(jnp.int32)
        pos = t[:, None] + c_idx
        use = active_row[:, None] & (pos >= max_delay[:, None])
        out = jnp.where(use, r + pred, r)
        h = jnp.concatenate([h[:, chunk:], out.astype(jnp.int64)], axis=1)
        return (h, t + chunk), out

    (hist, processed), out_t = jax.lax.scan(
        step,
        (hist.astype(jnp.int64), processed),
        jnp.swapaxes(residual.reshape(B, N // chunk, chunk), 0, 1),
    )
    out = jnp.swapaxes(out_t, 0, 1).reshape(B, N)
    return out, (hist.astype(jnp.int32), processed)


def longterm_init_state(batch: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    return (
        jnp.zeros((batch, _MAX_DELAY), dtype=jnp.int32),
        jnp.zeros((batch,), dtype=jnp.int32),
    )
