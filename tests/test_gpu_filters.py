"""The GPU filter kernels (kernels/gpu_filters.py) against their `lax.scan`
twins, and the dispatch that chooses between them.

On the CPU the kernels run in Pallas interpret mode: the same program,
bit for bit, that Triton compiles for the card. Tests marked `gpu` run the
compiled kernels and skip where JAX has no GPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import sla_tpu  # noqa: F401  (x64)
from sla_tpu import pipeline
from sla_tpu.kernels import gpu_filters as g
from sla_tpu.pipeline import (
    _decode_stage_scan,
    _encode_stage1_scan,
    _encode_stage2_scan,
)

L = 192  # > the longest delay drawn below, and > M = 40 warmup samples


def _inputs(B, p, T, seed=0, L=L, shortest_lag=False):
    rng = np.random.default_rng(seed)
    data = rng.integers(-(1 << 23), 1 << 23, (B, L), dtype=np.int32)
    coef = rng.integers(-(1 << 14), 1 << 14, (B, p), dtype=np.int32)
    pitch = rng.integers(3, 120, (B,), dtype=np.int32)
    pitch[::4] = 0  # long-term off for these rows
    if shortest_lag:
        pitch[1::2] = 3  # + T//2 - (T-1): a one-sample feedback lag at T = 5
    ltm = (rng.integers(-(1 << 14), 1 << 14, (B, max(T, 1)), dtype=np.int64)
           << 16).astype(np.int32)
    return tuple(jnp.asarray(a) for a in (data, coef, pitch, ltm))


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("p", [0, 1, 8, 16, 32, 48])
def test_stage1_matches_scan(p):
    d, c, _, _ = _inputs(19, p, 0, seed=p)
    assert _eq(g.stage1(d, c, p, interpret=True), _encode_stage1_scan(d, c, p))


@pytest.mark.parametrize(
    "T,M", [(T, M) for T in (0, 1, 3, 5) for M in (0, 1, 8)] + [(5, 40)]
)
def test_stage2_matches_scan(T, M):
    r, _, pitch, ltm = _inputs(19, 0, T, seed=10 * T + M)
    got = g.stage2(r, pitch, ltm, T, M, interpret=True)
    assert _eq(got, _encode_stage2_scan(r, pitch, ltm, T, M))


@pytest.mark.parametrize(
    "p,T,M",
    [(1, 0, 1), (8, 1, 8), (16, 1, 8), (32, 3, 8), (48, 5, 40), (16, 5, 1),
     (8, 3, 40), (0, 0, 0), (1, 5, 0), (0, 1, 8)],
)
def test_synth_matches_scan_and_inverts(p, T, M):
    d, c, pitch, ltm = _inputs(19, p, T, seed=100 + p + T + M)
    r = _encode_stage2_scan(_encode_stage1_scan(d, c, p), pitch, ltm, T, M)
    got = g.synth(r, c, pitch, ltm, p, T, M, interpret=True)
    assert _eq(got, _decode_stage_scan(r, c, pitch, ltm, p, T, M))
    assert _eq(got, d)


@pytest.mark.parametrize("stage", ["stage2", "synth"])
def test_shortest_legal_lag(stage):
    """Pitch 3 at T = 5 feeds back from the previous sample: the synth
    kernel must read its own output stored one iteration earlier."""
    p, T, M = 8, 5, 8
    d, c, pitch, ltm = _inputs(16, p, T, seed=7, shortest_lag=True)
    r1 = _encode_stage1_scan(d, c, p)
    r2 = _encode_stage2_scan(r1, pitch, ltm, T, M)
    if stage == "stage2":
        assert _eq(g.stage2(r1, pitch, ltm, T, M, interpret=True), r2)
    else:
        assert _eq(g.synth(r2, c, pitch, ltm, p, T, M, interpret=True), d)


@pytest.mark.parametrize("extra", [-7, -1, 1, 3])
def test_ragged_rows(extra):
    """Row counts off the row block pad up and slice back; padded rows
    (pitch 0, zero coefficients) never leak into real ones."""
    p, T, M = 4, 3, 4
    B = 2 * g.BLOCK_ROWS + extra
    d, c, pitch, ltm = _inputs(B, p, T, seed=B, L=64)
    r1 = g.stage1(d, c, p, interpret=True)
    assert r1.shape == d.shape
    assert _eq(r1, _encode_stage1_scan(d, c, p))
    r2 = g.stage2(r1, pitch, ltm, T, M, interpret=True)
    assert _eq(r2, _encode_stage2_scan(r1, pitch, ltm, T, M))
    assert _eq(g.synth(r2, c, pitch, ltm, p, T, M, interpret=True), d)


def test_longterm_params_packing():
    """(B, 1+T): the max delay (0 where pitch is 0), then the Q15 taps."""
    pitch = jnp.asarray(np.array([0, 3, 200], np.int32))
    ltm = jnp.asarray((np.array([[1, -2, 3]] * 3, np.int64) << 16).astype(np.int32))
    prm = np.asarray(g._longterm_params(pitch, ltm, 3))
    assert prm.tolist() == [[0, 1, -2, 3], [4, 1, -2, 3], [201, 1, -2, 3]]


# ---- dispatch ---------------------------------------------------------------

def _interpret_kernels(monkeypatch):
    for name in ("stage1", "stage2", "synth"):
        orig = getattr(g, name)

        def interp(*a, _o=orig, **k):
            return _o(*a, interpret=True, **k)

        monkeypatch.setattr(g, name, interp)


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("stage", ["stage1", "stage2", "synth"])
def test_dispatch_by_platform(platform, stage, monkeypatch):
    """An array on a GPU takes the kernel, anything else the scan; both
    give the same values, and DISPATCH records the choice."""
    _interpret_kernels(monkeypatch)
    monkeypatch.setattr(pipeline, "_platform", lambda x: platform)
    monkeypatch.setattr(pipeline, "DISPATCH", pipeline.DISPATCH.__class__())
    p, T, M = 8, 1, 8
    d, c, pitch, ltm = _inputs(8, p, T, seed=3)
    r1 = _encode_stage1_scan(d, c, p)
    r2 = _encode_stage2_scan(r1, pitch, ltm, T, M)
    if stage == "stage1":
        assert _eq(pipeline.encode_stage1(d, c, p), r1)
    elif stage == "stage2":
        assert _eq(pipeline.encode_stage2(r1, pitch, ltm, T, M), r2)
    else:
        assert _eq(pipeline.decode_stage(r2, c, pitch, ltm, p, T, M), d)
    impl = "kernel" if platform == "gpu" else "scan"
    assert dict(pipeline.DISPATCH) == {(stage, impl): 1}


def test_debug_asserts_take_the_checked_scan(monkeypatch):
    """SLA_TPU_DEBUG_ASSERTS routes every stage through the checkified
    scan, even on a GPU (the kernels cannot carry checkify checks)."""
    d, c, _, _ = _inputs(4, 4, 0, seed=5, L=32)
    want = _encode_stage1_scan(d, c, 4)
    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    monkeypatch.setattr(pipeline, "_platform", lambda x: "gpu")
    monkeypatch.setattr(pipeline, "DISPATCH", pipeline.DISPATCH.__class__())
    assert _eq(pipeline.encode_stage1(d, c, 4), want)
    assert not pipeline.DISPATCH


def test_filter_impl():
    assert pipeline.filter_impl("gpu") == "kernel"
    assert pipeline.filter_impl("cpu") == "scan"


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX's default backend is not 'gpu')")


@pytest.mark.gpu
@pytest.mark.parametrize("p,T,M", [(16, 1, 8), (48, 5, 40), (0, 0, 0)])
def test_compiled_kernels_match_scan(gpu, p, T, M):
    d, c, pitch, ltm = _inputs(37, p, T, seed=p + T + M, L=4096,
                               shortest_lag=True)
    r1 = _encode_stage1_scan(d, c, p)
    r2 = _encode_stage2_scan(r1, pitch, ltm, T, M)
    assert _eq(g.stage1(d, c, p), r1)
    assert _eq(g.stage2(r1, pitch, ltm, T, M), r2)
    assert _eq(g.synth(r2, c, pitch, ltm, p, T, M), d)
