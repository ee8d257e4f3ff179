"""Opt-in on-device overflow asserts (SLA_TPU_DEBUG_ASSERTS=1).

The reference peppers its hot loops with `SLA_Assert` (disabled by NDEBUG
in release builds, e.g. the per-tap LMS overflow checks at
src/SLAPredictor.c:1265-1271 and the Levinson invariants at :305/:321).
The JAX equivalent is `checkify`: with the env flag set, the scan kernels
embed `checkify.check` calls and the pipeline dispatchers route through a
checkified (functionalized) trace that raises `JaxRuntimeError` on the
first violated assert. Off by default — exactly like NDEBUG — so the
release path carries zero overhead.

Coverage (round 3, parity breadth): LMS tap products (kernels/lms.py),
lattice stage products both directions (kernels/lattice.py), long-term
prediction range on all three scan formulations (kernels/longterm.py).
The native C++ cascades carry the same checks in a -DSLA_TPU_DEBUG build
selected by SLA_TPU_NATIVE_DEBUG=1 (native/__init__.py), including the
Levinson e>=0 / |gamma|<1 analysis invariants — a violation aborts like
assert(). Each path's trap is exercised by a seeded overflow in
tests/test_cli.py.

Known exclusions (structural, documented rather than solved):
* checkify does not functionalize through `shard_map` — assert mode
  downgrades the mesh backend to the single-device checkified scan
  (encoder backend selection; __graft_entry__ mirrors this).
* The GPU kernels (kernels/gpu_filters.py) cannot carry `checkify.check`
  — assert mode forces the scan path, which computes bit-identical values,
  so the checked run still validates the numbers the kernels would
  produce; only the kernel *implementation* runs unchecked.
"""

from __future__ import annotations

import functools
import os


def asserts_enabled() -> bool:
    return bool(os.environ.get("SLA_TPU_DEBUG_ASSERTS"))


def check(cond, msg: str) -> None:
    """checkify.check, only callable from inside a checkified trace."""
    from jax.experimental import checkify

    checkify.check(cond, msg)


def run_checked(fn, *args, **static_kwargs):
    """Run `fn` under the checkify transform and raise on any failed check.

    `fn` may be jit-wrapped; static arguments go through as keywords."""
    from jax.experimental import checkify

    err, out = checkify.checkify(functools.partial(fn, **static_kwargs))(*args)
    err.throw()
    return out
