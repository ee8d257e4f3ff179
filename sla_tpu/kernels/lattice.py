"""PARCOR lattice analysis/synthesis filters — the per-sample hot loop.

Reference semantics (src/SLAPredictor.c:557-740), Q15 coefficients with
round-half constant 1<<14, int32 wraparound arithmetic:

predict (per sample, order p):
    f[0] = x
    f[k] = f[k-1] - ((c[k]*b_prev[k-1] + 16384) >> 15)      k = 1..p
    b[k] = b_prev[k-1] - ((c[k]*f[k-1] + 16384) >> 15)      k = p..1
    b[0] = x ; residual = f[p]

synthesize (per sample):
    f = r ; for k = p..1: f += ((c[k]*b_prev[k-1] + 16384) >> 15)
            then b[k] = b_prev[k-1] - ((c[k]*f_partial_k + 16384) >> 15)
    out = f ; b[0] = f

Batched re-derivation: within one sample, every multiply uses *previous*
state, so the order loop collapses into vector ops plus one cumulative sum:

predict:    m = (c*b_prev + h) >> 15            (vector over k)
            f[k] = x - prefix_sum(m)[k]
            b[k] = b_prev[k-1] - ((c[k]*f[k-1] + h) >> 15)
synthesize: m as above; f after stage k = r + suffix_sum(m)[k]
            b[k] = b_prev[k-1] - ((c[k]*(r + suffix_sum(m)[k]) + h) >> 15)

so one scan step is a handful of vector ops on a (batch, order) tile —
throughput comes from the (blocks x channels) batch width, exactly the axes
the serial C loops iterate (SLAEncoder.c:531, :846). The sample loop itself
must stay sequential: fixed-point rounding does not re-associate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HALF = 1 << 14


def _qmul(c: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(c*v + 16384) >> 15 in wrapping int32, matching the C expression."""
    return (c * v + _HALF) >> 15


def _check_qmul(c: jnp.ndarray, v: jnp.ndarray, what: str) -> None:
    """Debug-assert twin of the reference's NDEBUG'd invariants for the
    Q15 stage products (the lattice analog of SLAPredictor.c:1265-1271):
    the quantized coefficient must be a true Q15 value and the rounded
    stage product must fit int32 — a violation means the int32 wrap the
    fast kernels rely on changed a value. Traced only under
    SLA_TPU_DEBUG_ASSERTS (checkify)."""
    from .. import debug

    q = (c.astype(jnp.int64) * v.astype(jnp.int64) + _HALF) >> 15
    debug.check(
        jnp.all(jnp.abs(c) <= (1 << 15))
        & jnp.all((q <= jnp.int64(2**31 - 1)) & (q >= jnp.int64(-(2**31)))),
        f"lattice {what} stage product overflows int32",
    )


def lattice_predict(
    data: jnp.ndarray, coef: jnp.ndarray, backward: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Forward lattice (analysis).

    data: (B, N) int32; coef: (B, p) int32 = quantized c[1..p];
    backward: (B, p+1) int32 state. Returns (residual (B,N), new state).
    """
    c = coef.astype(jnp.int32)
    if c.shape[1] == 0:
        # order 0 is a valid stream parameter (the reference runs its stage
        # loop zero times): passthrough, state slot 0 tracks the last sample
        if data.shape[1] > 0:
            return data, data[:, -1:].astype(jnp.int32)
        return data, backward
    from .. import debug

    embed_asserts = debug.asserts_enabled()

    def step(b_prev, x):
        if embed_asserts:
            _check_qmul(c, b_prev[:, :-1], "predict")
        # m[k-1] = (c[k] * b_prev[k-1] + h) >> 15 for k = 1..p
        m = _qmul(c, b_prev[:, :-1])
        # cumsum pinned to int32: wraparound semantics as in the C loop
        f = x[:, None] - jnp.cumsum(m, axis=1, dtype=jnp.int32)  # f[1..p]
        f_prev = jnp.concatenate([x[:, None], f[:, :-1]], axis=1)  # f[0..p-1]
        if embed_asserts:
            _check_qmul(c, f_prev, "predict-update")
        b_hi = b_prev[:, :-1] - _qmul(c, f_prev)        # b[1..p]
        b_new = jnp.concatenate([x[:, None], b_hi], axis=1)
        return b_new, f[:, -1]

    new_state, res_t = jax.lax.scan(step, backward, jnp.swapaxes(data, 0, 1))
    return jnp.swapaxes(res_t, 0, 1), new_state


def lattice_synthesize(
    residual: jnp.ndarray, coef: jnp.ndarray, backward: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse lattice (synthesis).

    residual: (B, N) int32; coef: (B, p); backward: (B, p+1) state.
    Returns (output (B,N), new state).
    """
    c = coef.astype(jnp.int32)
    if c.shape[1] == 0:
        # order-0 passthrough (see lattice_predict)
        if residual.shape[1] > 0:
            return residual, residual[:, -1:].astype(jnp.int32)
        return residual, backward
    from .. import debug

    embed_asserts = debug.asserts_enabled()

    def step(b_prev, r):
        if embed_asserts:
            _check_qmul(c, b_prev[:, :-1], "synth")
        m = _qmul(c, b_prev[:, :-1])                    # stage terms k=1..p
        # suffix sums: f after processing stages p..k equals r + sum_{j>=k} m[j]
        suf = jnp.cumsum(m[:, ::-1], axis=1, dtype=jnp.int32)[:, ::-1]
        f_partial = r[:, None] + suf                    # f after stage k, k=1..p
        if embed_asserts:
            _check_qmul(c, f_partial, "synth-update")
        b_hi = b_prev[:, :-1] - _qmul(c, f_partial)     # b[1..p]
        out = f_partial[:, 0]                           # all stages applied
        b_new = jnp.concatenate([out[:, None], b_hi], axis=1)
        return b_new, out

    new_state, out_t = jax.lax.scan(step, backward, jnp.swapaxes(residual, 0, 1))
    return jnp.swapaxes(out_t, 0, 1), new_state


def lattice_init_state(batch: int, order: int) -> jnp.ndarray:
    return jnp.zeros((batch, order + 1), dtype=jnp.int32)
