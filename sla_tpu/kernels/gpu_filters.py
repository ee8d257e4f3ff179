"""GPU kernels for the three sample-recursive filter dispatches.

Every (block x channel) row is independent — the format resets predictor
state at block starts (SLADecoder.c:637-639) — while inside a row every
sample depends on the one before it, in exact wrapping int32 arithmetic.
So each kernel gives one GPU thread one row: the grid runs over blocks of
BLOCK_ROWS rows, and a `lax.fori_loop` over the samples carries that
row's filter state in registers (lattice p <= 48 words, LMS 4*M <= 160).
Nothing carries over between programs.

    stage1: pre-emphasis -> lattice predict                 (encode)
    stage2: pitch-gated long-term FIR -> LMS predict        (encode)
    synth:  LMS synth -> long-term synth -> lattice synth -> de-emphasis

The arithmetic is the `lax.scan` twins' (kernels/{emphasis,lattice,lms,
longterm}.py), written per row instead of per batch: the order loops unroll
at trace time, the long-term taps read the row's own lagged history with a
per-lane gather (from the input in stage2, from the kernel's own earlier
output in synth), and the long-term sum keeps the reference's 64-bit
accumulator. The outputs are bit-identical to the scans.

The kernels are Pallas programs lowered through Triton
(`backend="triton"`); `interpret=True` runs the same program on the CPU
for tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..constants import PRE_EMPHASIS_SHIFT

_HALF = 1 << 14
_EMPH = (1 << PRE_EMPHASIS_SHIFT) - 1  # 31
# Rows per program (one warp, one row per thread). Rows are the only
# parallel axis, so small programs spread a batch over more SMs: on an H100
# at 2048 rows, 8 ran within 10% of the fastest of 4/8/16/32 for every
# kernel, and fastest at 256 and 4096 rows (PERF.md).
BLOCK_ROWS = 8


def _qmul(c, v):
    """(c*v + 16384) >> 15 in wrapping int32 (kernels/lattice.py)."""
    return (c * v + _HALF) >> 15


def _sign(v):
    return jnp.sign(v).astype(jnp.int32)


def _lms_step(x, st, t, M: int, synthesize: bool):
    """One sign-sign LMS sample (kernels/lms.py) on per-row vectors.

    st = (fc, ic, xb, pb): four length-M tuples of (R,) int32, newest
    buffer entry first. Returns (output, new st)."""
    fc, ic, xb, pb = st
    acc = jnp.full_like(x, 512)
    for i in range(M):
        acc = acc + fc[i] * xb[i]
    for i in range(M):
        acc = acc + ic[i] * pb[i]
    pred = acc >> 10
    warm = t < M
    if synthesize:
        res = x
        out = x + pred
        new = out
    else:
        out = x - pred
        res = out
        new = x
    # bit_length(|res|) >> 1; |INT32_MIN| wraps to 0x80000000, clz 0
    step = _sign(res) * ((32 - jax.lax.clz(jnp.abs(res))) >> 1)
    step = jnp.where(warm, 0, step)
    fc = tuple(fc[i] + step * _sign(xb[i]) for i in range(M))
    ic = tuple(ic[i] + step * _sign(pb[i]) for i in range(M))
    ins_p = jnp.where(warm, new, pred)
    xb = (new,) + xb[:-1]
    pb = (ins_p,) + pb[:-1]
    return jnp.where(warm, x, out), (fc, ic, xb, pb)


def _lms_zero_state(R: int, M: int):
    z = tuple(jnp.zeros((R,), jnp.int32) for _ in range(M))
    return (z, z, z, z)


def _longterm_pred(hist_ref, rows, n, md, q, T: int):
    """(sum_j q15_j * hist[n - (md - j)] + 2^14) >> 15 with a 64-bit
    accumulator (kernels/longterm.py); md = pitch + T//2 per row. Reads
    outside [0, n] (before the row start, or ahead for rows with the
    long-term stage off) are clamped into it — the caller's gate
    (md > 0 and n >= md) discards them."""
    acc = jnp.zeros(rows.shape, jnp.int64)
    for j in range(T):
        col = jnp.clip(n - (md - j), 0, n)
        acc = acc + q[j].astype(jnp.int64) * hist_ref[rows, col].astype(jnp.int64)
    return ((acc + _HALF) >> 15).astype(jnp.int32)


def _stage1_kernel(x_ref, prm_ref, o_ref, *, p: int):
    R, L = x_ref.shape
    c = [prm_ref[:, k] for k in range(p)]

    def body(n, carry):
        prev, b = carry[0], carry[1:]
        x = x_ref[:, n]
        y = x - ((prev * _EMPH) >> PRE_EMPHASIS_SHIFT)
        f = y
        nb = [y]
        for k in range(p):
            nb.append(b[k] - _qmul(c[k], f))
            f = f - _qmul(c[k], b[k])
        o_ref[:, n] = f
        return (x, *nb[:p])

    zero = jnp.zeros((R,), jnp.int32)
    jax.lax.fori_loop(0, L, body, (zero,) * (1 + p))


def _stage2_kernel(x_ref, prm_ref, o_ref, *, T: int, M: int):
    R, L = x_ref.shape
    rows = jax.lax.iota(jnp.int32, R)
    md = prm_ref[:, 0]
    q = [prm_ref[:, 1 + j] for j in range(T)]
    lt_on = md > 0

    def body(n, carry):
        n = n.astype(jnp.int32)
        x = x_ref[:, n]
        if T > 0:
            pred = _longterm_pred(x_ref, rows, n, md, q, T)
            x = jnp.where(lt_on & (n >= md), x - pred, x)
        if M > 0:
            x, carry = _lms_step(x, carry, n, M, synthesize=False)
        o_ref[:, n] = x
        return carry

    jax.lax.fori_loop(0, L, body, _lms_zero_state(R, M))


def _synth_kernel(x_ref, prm_ref, o_ref, *, p: int, T: int, M: int):
    R, L = x_ref.shape
    rows = jax.lax.iota(jnp.int32, R)
    md = prm_ref[:, 0]
    q = [prm_ref[:, 1 + j] for j in range(T)]
    c = [prm_ref[:, 1 + T + k] for k in range(p)]
    lt_on = md > 0

    # pass 1: LMS synth -> long-term synth. The long-term history is this
    # pass's own output, read back from o_ref: every tap reaches at least
    # one sample back, so it was stored by an earlier iteration of the
    # same thread (num_stages=1 keeps the loads behind those stores)
    def body1(n, carry):
        n = n.astype(jnp.int32)
        x = x_ref[:, n]
        if M > 0:
            x, carry = _lms_step(x, carry, n, M, synthesize=True)
        if T > 0:
            pred = _longterm_pred(o_ref, rows, n, md, q, T)
            x = jnp.where(lt_on & (n >= md), x + pred, x)
        o_ref[:, n] = x
        return carry

    jax.lax.fori_loop(0, L, body1, _lms_zero_state(R, M))

    # pass 2, in place: lattice synth -> de-emphasis
    def body2(n, carry):
        prev, b = carry[0], carry[1:]
        r = o_ref[:, n]
        m = [_qmul(c[k], b[k]) for k in range(p)]
        f = r
        fp = [None] * p
        for k in reversed(range(p)):
            f = f + m[k]
            fp[k] = f
        nb = [f] + [b[k] - _qmul(c[k], fp[k]) for k in range(p)]
        y = f + ((prev * _EMPH) >> PRE_EMPHASIS_SHIFT)
        o_ref[:, n] = y
        return (y, *nb[:p])

    zero = jnp.zeros((R,), jnp.int32)
    jax.lax.fori_loop(0, L, body2, (zero,) * (1 + p))


def _call(kernel, x, prm, *, interpret: bool, name: str):
    """Run `kernel` over BLOCK_ROWS-row blocks of x (B, L) with per-row
    parameters prm (B, K); rows pad up to a BLOCK_ROWS multiple."""
    B, L = x.shape
    pad = (-B) % BLOCK_ROWS
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
        prm = jnp.pad(prm, ((0, pad), (0, 0)))
    Bp, K = prm.shape
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((Bp, L), jnp.int32),
        grid=(Bp // BLOCK_ROWS,),
        in_specs=[
            pl.BlockSpec((BLOCK_ROWS, L), lambda i: (i, 0)),
            pl.BlockSpec((BLOCK_ROWS, K), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((BLOCK_ROWS, L), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name=name,
    )(x, prm)
    return out[:B]


def _longterm_params(pitch, ltm_coef, num_taps: int):
    """(B, 1+T): the row's max delay (0 = long-term off) and its Q15 taps
    (Q31 coefficients have zero low halves — kernels/longterm.py)."""
    md = jnp.where(pitch > 0, pitch + num_taps // 2, 0).astype(jnp.int32)
    q15 = (ltm_coef[:, :num_taps] >> 16).astype(jnp.int32)
    return jnp.concatenate([md[:, None], q15], axis=1)


@functools.partial(jax.jit, static_argnames=("parcor_order", "interpret"))
def stage1(data, parcor_coef, parcor_order: int, interpret: bool = False):
    """Pre-emphasis + lattice predict. data (B, L) int32; parcor_coef
    (B, p) int32. Returns the PARCOR residual (B, L)."""
    B = data.shape[0]
    prm = jnp.concatenate(
        [parcor_coef[:, :parcor_order].astype(jnp.int32),
         jnp.zeros((B, 1), jnp.int32)], axis=1,
    )
    kern = functools.partial(_stage1_kernel, p=parcor_order)
    return _call(kern, data, prm, interpret=interpret, name="sla_stage1")


@functools.partial(
    jax.jit, static_argnames=("num_taps", "lms_order", "interpret")
)
def stage2(residual, pitch, ltm_coef, num_taps: int, lms_order: int,
           interpret: bool = False):
    """Pitch-gated long-term FIR + LMS predict. residual (B, L); pitch (B,)
    (0 = long-term off for that row); ltm_coef (B, >=T) Q31."""
    prm = _longterm_params(pitch, ltm_coef, num_taps)
    kern = functools.partial(_stage2_kernel, T=num_taps, M=lms_order)
    return _call(kern, residual, prm, interpret=interpret, name="sla_stage2")


@functools.partial(
    jax.jit,
    static_argnames=("parcor_order", "num_taps", "lms_order", "interpret"),
)
def synth(residual, parcor_coef, pitch, ltm_coef, parcor_order: int,
          num_taps: int, lms_order: int, interpret: bool = False):
    """The whole decode cascade: LMS synth -> long-term synth -> lattice
    synth -> de-emphasis. Returns PCM rows before the MS inverse / shift."""
    prm = jnp.concatenate(
        [_longterm_params(pitch, ltm_coef, num_taps),
         parcor_coef[:, :parcor_order].astype(jnp.int32)], axis=1,
    )
    kern = functools.partial(
        _synth_kernel, p=parcor_order, T=num_taps, M=lms_order
    )
    return _call(kern, residual, prm, interpret=interpret, name="sla_synth")
