"""Sign-sign LMS adaptive predictor (FIR + IIR cascade).

Reference semantics (src/SLAPredictor.c:1202-1463): order M (power of two,
>= 4), all arithmetic wrapping int32:

    pred[n] = (512 + sum_i fc[i]*xbuf[i] + sum_i ic[i]*pbuf[i]) >> 10
    residual[n] = x[n] - pred[n]
    step = sign(residual) * (bit_length(|residual|) >> 1)
    fc[i] += step * sign(xbuf[i]) ;  ic[i] += step * sign(pbuf[i])
    xbuf <- [x[n], xbuf[:-1]] ; pbuf <- [pred[n], pbuf[:-1]]

(the reference's 64-entry delta table collapses to the closed form above:
entry magnitude is (log2ceil(|res|+1) << 4) >> 5 = bit_length(|res|) >> 1,
signed by the residual sign and the buffered sample's sign; its separate
sign ring buffers always equal sign(value buffers)).

The first M samples after a reset pass through with no adaptation, while the
buffers fill newest-first (SLAPredictor.c:1233-1255). Coefficients after
reset are zero, so pred is 0 during warmup and only the adaptation and the
IIR-buffer insertion need masking.

The per-sample dependence is nonlinear (data-dependent coefficient update),
so the scan is irreducible; throughput comes from the (blocks x channels)
batch axis, each step being a few vector ops on (B, M) tiles.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class LmsState(NamedTuple):
    fir_coef: jnp.ndarray  # (B, M) int32
    iir_coef: jnp.ndarray  # (B, M) int32
    fir_buf: jnp.ndarray  # (B, M) int32, newest at index 0
    iir_buf: jnp.ndarray  # (B, M) int32
    processed: jnp.ndarray  # (B,) int32


def lms_init_state(batch: int, num_coef: int) -> LmsState:
    z = jnp.zeros((batch, num_coef), dtype=jnp.int32)
    return LmsState(z, z, z, z, jnp.zeros((batch,), dtype=jnp.int32))


def _sign(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sign(v).astype(jnp.int32)


def _step_mag(res: jnp.ndarray) -> jnp.ndarray:
    """bit_length(|res|) >> 1 — the LMS delta magnitude."""
    mag = jnp.abs(res).astype(jnp.uint32)
    bl = 32 - jax.lax.clz(mag).astype(jnp.int32)
    return bl >> 1


def _lms_scan(data: jnp.ndarray, state: LmsState, num_coef: int, synthesize: bool):
    M = num_coef
    if M == 0:
        # order 0 is a valid stream parameter OF THIS FRAMEWORK (the
        # reference decoder segfaults on it — PARITY.md known deviations;
        # tests/test_optimize.py pins the round trip): the filter is a
        # passthrough, like lattice_predict's order-0 gate
        return data, state

    from .. import debug

    embed_asserts = debug.asserts_enabled()

    def step(carry: LmsState, x):
        fc, ic, xb, pb, t = carry
        acc = jnp.full(x.shape, 512, dtype=jnp.int32)
        if embed_asserts:
            # mirror of the reference's per-tap overflow asserts
            # (SLAPredictor.c:1265-1271): each (coef * buf) >> 10 must fit
            # int32. Only traced under SLA_TPU_DEBUG_ASSERTS=1 via checkify.
            imax = jnp.int64(2**31 - 1)
            imin = jnp.int64(-(2**31))
            fir64 = fc.astype(jnp.int64) * xb.astype(jnp.int64) >> 10
            iir64 = ic.astype(jnp.int64) * pb.astype(jnp.int64) >> 10
            debug.check(
                jnp.all((fir64 <= imax) & (fir64 >= imin))
                & jnp.all((iir64 <= imax) & (iir64 >= imin)),
                "LMS tap product overflows int32",
            )
        # dtype pinned to int32: the reference accumulates with wraparound
        # int32 semantics (SLAPredictor.c:1260-1273)
        acc = acc + jnp.sum(fc * xb, axis=1, dtype=jnp.int32)
        acc = acc + jnp.sum(ic * pb, axis=1, dtype=jnp.int32)
        pred = acc >> 10
        warm = (t < M)[:, None]  # (B,1)
        if synthesize:
            res = x  # table index uses the residual (pre-addition output)
            out = x + pred
            new_sample = out
        else:
            out = x - pred
            res = out
            new_sample = x
        step_val = (_sign(res) * _step_mag(res))[:, None]
        step_val = jnp.where(warm, 0, step_val)
        fc = fc + step_val * _sign(xb)
        ic = ic + step_val * _sign(pb)
        ins_p = jnp.where(warm[:, 0], new_sample, pred)
        xb = jnp.concatenate([new_sample[:, None], xb[:, :-1]], axis=1)
        pb = jnp.concatenate([ins_p[:, None], pb[:, :-1]], axis=1)
        out = jnp.where(warm[:, 0], x, out)
        return LmsState(fc, ic, xb, pb, t + 1), out

    new_state, out_t = jax.lax.scan(step, state, jnp.swapaxes(data, 0, 1))
    return jnp.swapaxes(out_t, 0, 1), new_state


def lms_predict(
    data: jnp.ndarray, state: LmsState, num_coef: int
) -> tuple[jnp.ndarray, LmsState]:
    """data: (B, N) int32 -> (residual, new state)."""
    return _lms_scan(data, state, num_coef, synthesize=False)


def lms_synthesize(
    residual: jnp.ndarray, state: LmsState, num_coef: int
) -> tuple[jnp.ndarray, LmsState]:
    """residual: (B, N) int32 -> (output, new state)."""
    return _lms_scan(residual, state, num_coef, synthesize=True)
