"""Pure-Python fallbacks for the streaming decoder's native hot path.

The reference streaming decoder is portable C with no hard dependency on a
toolchain (src/SLADecoder.c:752-1123); this module gives the rebuild the
same property: when the native library is unavailable (no g++, build
failure, SLA_TPU_NO_NATIVE=1), `StreamingDecoder` transparently uses these
implementations. They are slow per sample but bit-exact to the native ones:

* `PyPayloadCursor` mirrors native `sla_get_data_array_partial` /
  `sla_init_param_state` (sla_native.cpp) — resumable channel-interleaved
  recursive-Rice/Golomb decode with carried fixed-point parameter state.
* `py_synth_chunk` mirrors native `sla_synth_chunk` — the incremental
  LMS -> long-term -> PARCOR -> de-emphasis synthesis chain (decode order,
  reference src/SLADecoder.c:494-537) with wrapping int32 arithmetic.
* `py_get_raw` mirrors native `sla_get_raw` (RAWDATA payload decode).

All three share the native bit reader's over-read semantics: reads past the
buffered end zero-fill but still advance the position, so the caller's
underrun check (`bit_pos > 8 * len(buffer)`) detects a violated feed
contract and rolls back.
"""

from __future__ import annotations

import numpy as np

from .constants import CODER_NUM_RECURSIVE_RICE_PARAMETER
from .rice import (
    RiceState,
    effective_init_param,
    get_golomb,
    get_recursive_rice,
    param_set_fixed,
)
from .bitio import uint32_to_sint32
from .constants import CODER_LOW_THRESHOLD_PARAMETER

_NUMP = CODER_NUM_RECURSIVE_RICE_PARAMETER
_M32 = 0xFFFFFFFF


def _w32(v: int) -> int:
    """Wrap to signed int32 (the native library builds with -fwrapv)."""
    v &= _M32
    return v - 0x100000000 if v >= 0x80000000 else v


class _ZeroFillReader:
    """MSB-first bit reader that zero-fills past the end of the buffer but
    keeps advancing the logical position (native BitReader semantics,
    sla_native.cpp `load_byte`), so over-reads are detectable via the final
    position instead of raising mid-symbol."""

    __slots__ = ("_mem", "_bitpos", "_nbits")

    def __init__(self, data, bit_offset: int = 0) -> None:
        self._mem = memoryview(data)
        self._nbits = len(self._mem) * 8
        self._bitpos = bit_offset

    def get(self, nbits: int) -> int:
        out = 0
        pos = self._bitpos
        end = pos + nbits
        mem = self._mem
        nbytes = len(mem)
        while pos < end:
            idx = pos >> 3
            byte = mem[idx] if idx < nbytes else 0
            avail = 8 - (pos & 7)
            take = min(avail, end - pos)
            shift = avail - take
            out = (out << take) | ((byte >> shift) & ((1 << take) - 1))
            pos += take
        self._bitpos = end
        return out

    def get_zero_run(self) -> int:
        run = 0
        mem = self._mem
        pos = self._bitpos
        total = self._nbits
        while pos < total:
            byte = mem[pos >> 3]
            avail = 8 - (pos & 7)
            chunk = byte & ((1 << avail) - 1)
            if chunk == 0:
                run += avail
                pos += avail
                continue
            lead = avail - chunk.bit_length()
            self._bitpos = pos + lead + 1
            return run + lead
        # only zeros remain to the real end (already counted by the loop);
        # mark the over-read (pos = total + 1, matching the native reader)
        self._bitpos = total + 1
        return run

    def mark_overread(self) -> None:
        self._bitpos = self._nbits + 1


class _BitPos:
    """Tiny settable holder matching ctypes.c_int64's `.value` interface."""

    __slots__ = ("value",)

    def __init__(self, value: int) -> None:
        self.value = int(value)


class PyPayloadCursor:
    """Resumable entropy-decode cursor (pure-Python twin of
    native.PayloadCursor; same state layout so snapshot/rollback in
    StreamingDecoder works unchanged)."""

    def __init__(self, init_params, num_channels: int, bit_offset: int):
        C = int(num_channels)
        self.C = C
        self.bit_pos = _BitPos(bit_offset)
        self.param_state = np.array(
            [param_set_fixed(int(p)) for p in init_params for _ in range(_NUMP)],
            dtype=np.uint64,
        )
        self.eff_params = np.array(
            [effective_init_param(int(p)) for p in init_params], dtype=np.uint32
        )
        # branch decided once per block from the initial params
        # (SLACoder.c:489-505)
        self.use_golomb = int(
            int(self.eff_params.astype(np.uint64).sum()) // C
            <= CODER_LOW_THRESHOLD_PARAMETER
        )

    def read(self, stream, num_samples: int) -> np.ndarray:
        # _ZeroFillReader indexes a memoryview, which wraps a contiguous
        # uint8 ndarray zero-copy — converting via tobytes() would re-copy
        # the whole buffered stream every 120 Hz streaming tick
        r = _ZeroFillReader(stream, self.bit_pos.value)
        C = self.C
        out = np.empty((C, num_samples), dtype=np.int32)
        if self.use_golomb:
            eff = [int(e) for e in self.eff_params]
            for s in range(num_samples):
                for ch in range(C):
                    out[ch, s] = uint32_to_sint32(get_golomb(r, eff[ch]))
        else:
            states = []
            for ch in range(C):
                st = RiceState.__new__(RiceState)
                st.params = [int(x) for x in self.param_state[ch * _NUMP : (ch + 1) * _NUMP]]
                states.append(st)
            for s in range(num_samples):
                for ch in range(C):
                    out[ch, s] = uint32_to_sint32(get_recursive_rice(r, states[ch]))
            for ch in range(C):
                self.param_state[ch * _NUMP : (ch + 1) * _NUMP] = states[ch].params
        self.bit_pos.value = r._bitpos
        return out


def py_get_raw(stream, bit_offset: int, C: int, N: int, bits_per_ch) -> np.ndarray:
    """RAWDATA payload decode: zigzagged, channel-interleaved
    (reference SLAEncoder.c:741-763 layout)."""
    r = _ZeroFillReader(stream, bit_offset)
    out = np.empty((C, N), dtype=np.int32)
    for s in range(N):
        for ch in range(C):
            out[ch, s] = uint32_to_sint32(r.get(bits_per_ch[ch]))
    return out


def _qmul15(c: int, v: int) -> int:
    """Q15 multiply with half-up rounding and wrapping int32 product
    (SLAPredictor.c lattice arithmetic)."""
    return _w32(_w32(c * v) + (1 << 14)) >> 15


def py_synth_chunk(
    residual: np.ndarray,
    parcor_coef: np.ndarray,
    lattice_state: np.ndarray,
    pitch: int,
    ltm_coef: np.ndarray,
    num_taps: int,
    lt_hist: np.ndarray,
    lt_processed: np.ndarray,
    lms_order: int,
    lms_state: np.ndarray,
    lms_processed: np.ndarray,
    deemph_prev: np.ndarray,
) -> np.ndarray:
    """Incremental one-channel synthesis; mutates the state arrays in place.
    Same signature and state layout as native.synth_chunk."""
    n = len(residual)
    p = len(parcor_coef)
    M = int(lms_order)
    coef = [int(c) for c in parcor_coef]
    lat = [int(v) for v in lattice_state]
    fc = [int(v) for v in lms_state[0:M]]
    ic = [int(v) for v in lms_state[M : 2 * M]]
    xb = [int(v) for v in lms_state[2 * M : 3 * M]]  # newest-first
    pb = [int(v) for v in lms_state[3 * M : 4 * M]]
    lms_proc = int(lms_processed[0])
    lt_proc = int(lt_processed[0])
    prev = int(deemph_prev[0])
    pitch = int(pitch)
    max_delay = pitch + int(num_taps) // 2
    # 1024-entry ring exactly like the native lanes (sla_native.cpp
    # lt_ring): history in slots [0, L), head at L, unseeded slots zero —
    # degenerate corrupt-stream shapes (taps past the history, max_delay
    # beyond the window) read deterministic zeros instead of raising or
    # aliasing the wrong entries
    L = len(lt_hist)
    ring = [0] * 1024
    for i in range(L):
        ring[i] = int(lt_hist[i])
    head = L
    q15c = [int(c) >> 16 for c in ltm_coef[: int(num_taps)]]

    out = np.empty(n, dtype=np.int32)
    for s in range(n):
        x = int(residual[s])

        # ---- LMS synthesis (sign-sign update, wrapping int32 accumulate)
        acc = 512
        for i in range(M):
            acc = _w32(acc + _w32(fc[i] * xb[i]))
        for i in range(M):
            acc = _w32(acc + _w32(ic[i] * pb[i]))
        pred = acc >> 10
        warm = lms_proc < M
        res = x
        y = _w32(x + pred)
        if not warm:
            mag = (-res if res < 0 else res) & _M32
            bl = mag.bit_length()
            sign = (res > 0) - (res < 0)
            step = sign * (bl >> 1)
            for i in range(M):
                fc[i] = _w32(fc[i] + step * ((xb[i] > 0) - (xb[i] < 0)))
                ic[i] = _w32(ic[i] + step * ((pb[i] > 0) - (pb[i] < 0)))
        new_sample = y
        ins_p = new_sample if warm else pred
        if M:
            xb.insert(0, new_sample)
            xb.pop()
            pb.insert(0, ins_p)
            pb.pop()
        if warm:
            y = x
        lms_proc += 1

        # ---- long-term synthesis (Q15 coefs after >>16, int64 accumulate)
        if pitch > 0:
            s64 = 0
            for j in range(len(q15c)):
                s64 += q15c[j] * ring[(head - (max_delay - j)) & 1023]
            lpred = _w32((s64 + (1 << 14)) >> 15)
            lout = _w32(y + lpred) if lt_proc >= max_delay else y
            ring[head & 1023] = lout
            head += 1
            y = lout
        lt_proc += 1

        # ---- PARCOR lattice synthesis
        f = y
        for k in range(p, 0, -1):
            f = _w32(f + _qmul15(coef[k - 1], lat[k - 1]))
            lat[k] = _w32(lat[k - 1] - _qmul15(coef[k - 1], f))
        lat[0] = f
        y = f

        # ---- de-emphasis
        y = _w32(y + (_w32(prev * 31) >> 5))
        prev = y
        out[s] = y

    lattice_state[:] = lat
    lms_state[0:M] = fc
    lms_state[M : 2 * M] = ic
    lms_state[2 * M : 3 * M] = xb
    lms_state[3 * M : 4 * M] = pb
    lms_processed[0] = lms_proc
    lt_processed[0] = lt_proc
    deemph_prev[0] = prev
    if pitch > 0:
        for i in range(L):
            lt_hist[i] = _w32(ring[(head - L + i) & 1023])
    return out


def py_synth_chunk_rows(
    residual: np.ndarray,
    parcor_coef: np.ndarray,
    lattice_state: np.ndarray,
    pitch: np.ndarray,
    ltm_coef: np.ndarray,
    num_taps: int,
    lt_hist: np.ndarray,
    lt_processed: np.ndarray,
    lms_order: int,
    lms_state: np.ndarray,
    lms_processed: np.ndarray,
    deemph_prev: np.ndarray,
    ms: bool = False,
    shift: int = 0,
) -> np.ndarray:
    """All-channel streaming-tick synthesis with the mid/side inverse and
    left shift fused — the pure-Python twin of native.synth_chunk_rows
    (same stacked (C, ...) state layout, mutates in place)."""
    from .dsp.channel import ms_to_lr_int32

    residual = np.ascontiguousarray(residual, dtype=np.int32)
    C, n = residual.shape
    out = np.empty((C, n), dtype=np.int32)
    for ch in range(C):
        out[ch] = py_synth_chunk(
            residual[ch], parcor_coef[ch], lattice_state[ch], int(pitch[ch]),
            ltm_coef[ch], num_taps, lt_hist[ch], lt_processed[ch], lms_order,
            lms_state[ch], lms_processed[ch], deemph_prev[ch],
        )
    if ms:
        if C != 2:
            raise ValueError("mid/side requires exactly 2 channels")
        left, right = ms_to_lr_int32(out[0], out[1])
        out = np.stack([left, right])
    if shift:
        out = (out << np.int32(shift)).astype(np.int32)
    return out
