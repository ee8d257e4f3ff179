// Native host entropy stage: MSB-first bit I/O + recursive-Rice / Golomb
// array codecs + CRC16, matching the semantics of sla_tpu/rice.py and
// sla_tpu/bitio.py (which interoperate bit-exactly with the reference
// format, see reference src/SLACoder.c, src/SLABitStream.c).
//
// This is the host-side half of the host/device split: the device computes whole
// residual batches, this module turns them into (or parses them from) the
// bit-serial container payload. Compiled with g++ -O3 into a shared library
// loaded via ctypes (no pybind11 in the image).

#include <algorithm>
#include <atomic>
#include <climits>
#include <mutex>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>
#if defined(__x86_64__)
#include <immintrin.h>
#endif

// Debug-build invariant checks (SLA_TPU_NATIVE_DEBUG=1 builds with
// -DSLA_TPU_DEBUG): the native twin of the reference's SLA_Assert
// (SLAInternal.h:49-54, compiled out by NDEBUG in release — same policy
// here: zero overhead unless the debug lib is selected). A violation
// aborts loudly so tests can catch it at process level.
#ifdef SLA_TPU_DEBUG
#include <cstdio>
#define SLA_DBG_ASSERT(cond, msg)                                          \
  do {                                                                     \
    if (!(cond)) {                                                         \
      std::fprintf(stderr, "SLA debug assert failed: %s (%s:%d)\n", msg,   \
                   __FILE__, __LINE__);                                    \
      std::abort();                                                        \
    }                                                                      \
  } while (0)
#else
#define SLA_DBG_ASSERT(cond, msg) ((void)0)
#endif

#if defined(__AVX512F__)
// defined in the filter section (inside its extern "C" block)
extern "C" {
static inline void transpose8d(__m512d m[8]);
static inline void tile_transpose8(__m256i m[8]);
}
#endif

namespace {

// Worker-thread count for the block-parallel entropy stages: the format's
// blocks are independent and byte-aligned, so serialization/decode shards
// at block granularity. Default min(hardware_concurrency, 8); override
// with SLA_TPU_THREADS (1 disables threading — this box's single core
// still exercises the sharded code path in tests via SLA_TPU_THREADS=N).
static int entropy_threads() {
  if (const char* e = std::getenv("SLA_TPU_THREADS")) {
    int v = std::atoi(e);
    if (v >= 1) return v > 64 ? 64 : v;
  }
  unsigned hw = std::thread::hardware_concurrency();
  if (hw < 2) return 1;
  return hw > 8 ? 8 : (int)hw;
}

constexpr int kNumRecursiveParams = 2;  // SLAInternal.h:18
constexpr uint32_t kQuotThreshold = 16; // SLAInternal.h:20
constexpr uint32_t kLowThreshold = 8;   // SLAInternal.h:19
constexpr int kFrac = 8;
constexpr uint64_t kHalf = 1u << (kFrac - 1);

// ---------------------------------------------------------------- bit writer
struct BitWriter {
  uint8_t* buf;
  int64_t cap;     // capacity in bytes
  int64_t nbytes;  // whole bytes emitted
  uint64_t acc;    // pending bits, right-aligned
  int nacc;        // number of pending bits (< 8 after drain)
  bool overflow;
  bool fatal;  // pathological emission (unbounded Golomb run): abort encode

  void init(uint8_t* b, int64_t c) {
    buf = b; cap = c; nbytes = 0; acc = 0; nacc = 0; overflow = false;
    fatal = false;
  }
  inline void drain() {
    const int out = nacc >> 3;  // whole bytes pending
    if (!out) return;
    if (nbytes + 8 <= cap) {
      // single branch-free store: the whole-byte prefix left-aligned in a
      // big-endian u64; the unused tail bytes are overwritten next drain
      const int keep = nacc & 7;
      uint64_t be = __builtin_bswap64((acc >> keep) << (64 - 8 * out));
      std::memcpy(buf + nbytes, &be, 8);
      nbytes += out;
      nacc = keep;
      acc &= (1ull << keep) - 1;
      return;
    }
    while (nacc >= 8) {  // near-capacity tail: byte-at-a-time with checks
      nacc -= 8;
      if (nbytes < cap) buf[nbytes++] = (uint8_t)(acc >> nacc);
      else { overflow = true; nbytes++; }
    }
    acc &= (1ull << nacc) - 1;
  }
  inline void put(uint64_t val, int nbits) {  // nbits 1..57 per call
    acc = (acc << nbits) | (val & ((nbits >= 64) ? ~0ull : ((1ull << nbits) - 1)));
    nacc += nbits;
    drain();
  }
  inline void put_wide(uint64_t val, int nbits) {  // nbits 1..64
    if (nbits > 32) { put(val >> 32, nbits - 32); put(val & 0xFFFFFFFFull, 32); }
    else put(val, nbits);
  }
  inline void put_unary(uint32_t q) {  // q zero bits then a one bit
    while (q >= 32) { put(0, 32); q -= 32; }
    put(1, q + 1);
  }
  void flush() { if (nacc) put(0, 8 - nacc); }
};

// ---------------------------------------------------------------- bit reader
// 64-bit cached reader: bits stream through a register window refilled a
// byte at a time, so the per-symbol hot loops (Rice/Golomb decode) touch
// memory once per 8 bits instead of per call. Reads past the end zero-fill
// the value but still advance the logical position, so a caller can detect
// an over-read (streaming underrun) via pos() > total.
struct BitReader {
  const uint8_t* buf;
  int64_t size_bytes;
  int64_t next_byte;   // next (virtual) byte to load; may pass size_bytes
  uint64_t cache;      // low `ncache` bits hold the upcoming bits, MSB-first
  int ncache;

  void init(const uint8_t* b, int64_t size, int64_t bit_offset) {
    buf = b;
    size_bytes = size;
    next_byte = bit_offset >> 3;
    cache = 0;
    ncache = 0;
    int skip = (int)(bit_offset & 7);
    if (skip) {  // preload the partial byte and drop the consumed high bits
      load_byte();
      ncache -= skip;
      cache &= (1ull << ncache) - 1;
    }
  }
  inline void load_byte() {
    uint8_t v = (next_byte < size_bytes) ? buf[next_byte] : 0;  // zero past end
    ++next_byte;
    cache = (cache << 8) | v;
    ncache += 8;
  }
  inline void refill32() {  // bulk path: one 8-byte load tops up to 56+ bits
    if (next_byte + 8 <= size_bytes) {
      const int nb = (63 - ncache) >> 3;  // whole bytes that fit (<= 7)
      if (nb > 0) {
        uint64_t v;
        std::memcpy(&v, buf + next_byte, 8);
        next_byte += nb;
        cache = (cache << (8 * nb)) |
                (__builtin_bswap64(v) >> (64 - 8 * nb));
        ncache += 8 * nb;
      }
    } else if (ncache <= 32 && next_byte + 4 <= size_bytes) {
      uint32_t v;
      std::memcpy(&v, buf + next_byte, 4);
      next_byte += 4;
      cache = (cache << 32) | __builtin_bswap32(v);
      ncache += 32;
    }
  }
  inline int64_t pos() const { return next_byte * 8 - ncache; }
  inline int64_t nbits_total() const { return size_bytes * 8; }
  // force the over-read state (pos() == total + 1): callers' end-position
  // checks then surface INSUFFICIENT/corruption; reads keep zero-filling
  inline void mark_overread() { next_byte = size_bytes; ncache = -1; cache = 0; }
  inline uint64_t get(int nbits) {  // nbits 0..33 in all callers
    if (ncache < nbits) {
      refill32();
      while (ncache < nbits) load_byte();
    }
    ncache -= nbits;
    uint64_t out = cache >> ncache;
    cache &= (1ull << ncache) - 1;
    return out;
  }
  inline uint32_t get_zero_run() {
    uint32_t run = 0;
    for (;;) {
      if (cache == 0) {
        if (next_byte + 4 <= size_bytes) {
          run += (uint32_t)ncache;
          ncache = 0;
          refill32();
          continue;
        }
        if (next_byte >= size_bytes) {
          // only zeros remain to the real end: count the non-virtual ones,
          // then mark the over-read (pos = total + 1, old-reader semantics)
          int64_t virtual_bits = (next_byte - size_bytes) * 8;
          if (virtual_bits > ncache) virtual_bits = ncache;
          run += (uint32_t)(ncache - virtual_bits);
          next_byte = size_bytes;
          ncache = -1;  // pos() == size*8 + 1
          cache = 0;
          return run;
        }
        run += (uint32_t)ncache;
        ncache = 0;
        load_byte();
        continue;
      }
      int lead = ncache - (64 - __builtin_clzll(cache));  // zeros before the 1
      run += (uint32_t)lead;
      ncache -= lead + 1;  // consume zeros + the terminating 1
      cache &= (1ull << ncache) - 1;
      return run;
    }
  }
};

// ------------------------------------------------------------------- zigzag
static inline uint32_t zigzag(int32_t v) {
  return ((uint32_t)v << 1) ^ (uint32_t)(v >> 31);
}
// stage both stereo rows' zigzag maps into a reusable scratch so the
// serial Rice parameter chain doesn't carry the mapping (shared by
// sla_put_data_array and encode_block_core)
static inline void stage_zigzag_stereo(const int32_t* d0, const int32_t* d1,
                                       int32_t n, const uint32_t** z0_out,
                                       const uint32_t** z1_out) {
  static thread_local std::vector<uint32_t> zz;
  zz.resize(2 * (size_t)n);
  uint32_t* z0 = zz.data();
  uint32_t* z1 = zz.data() + n;
  for (int32_t s = 0; s < n; ++s) z0[s] = ((uint32_t)d0[s] << 1) ^ (uint32_t)(d0[s] >> 31);
  for (int32_t s = 0; s < n; ++s) z1[s] = ((uint32_t)d1[s] << 1) ^ (uint32_t)(d1[s] >> 31);
  *z0_out = z0;
  *z1_out = z1;
}

static inline int32_t unzigzag(uint32_t u) {
  return (int32_t)((u >> 1) ^ (~(u & 1) + 1));
}

// ------------------------------------------------- fixed-point Rice params
static inline uint32_t roundup_pow2(uint32_t x) {
  // 1u << LOG2CEIL(x), with x86 shift-count masking (bl & 31) semantics
  int bl = (x <= 1) ? 0 : (32 - __builtin_clz(x - 1));
  return 1u << (bl & 31);
}
static inline uint64_t param_set_fixed(uint32_t v) {
  return (uint64_t)(uint32_t)(v << kFrac);  // uint32 wrap, then widen
}
static inline uint32_t param_get(uint64_t p) {
  uint32_t v = (uint32_t)((p + kHalf) >> kFrac);
  return v < 1 ? 1 : v;
}
static inline uint64_t param_update(uint64_t p, uint32_t code) {
  uint32_t term = 9u * (uint32_t)(code << kFrac);  // uint32 wrap (load-bearing)
  return (119u * p + term + (1u << 6)) >> 7;
}
static inline uint32_t rice_param(uint64_t p) {
  uint32_t h = (uint32_t)(((p >> 1) + kHalf) >> kFrac);
  return roundup_pow2(h < 1 ? 1 : h);
}
static inline int log2_pow2(uint32_t k) {  // k is a power of two
  return 31 - __builtin_clz(k);
}
// SLAUtility_Log2 replica: log(x) * (1/ln 2) with the reference's exact
// double constant (SLAUtility.c:442-446). NOT std::log2 — the two differ in
// the last ulp for ~19% of inputs, and code-length estimates built on this
// feed partition / raw-fallback decisions that byte-identity pins.
static inline double sla_ref_log2(double x) {
  return std::log(x) * 1.4426950408889634;
}

// --------------------------------------------------------------- gamma code
static inline void put_gamma(BitWriter& w, uint32_t val) {
  if (val == 0) { w.put(1, 1); return; }
  int ndigit = 32 - __builtin_clz(val + 1);  // bit_length(val+1)
  if (ndigit - 1) w.put(0, ndigit - 1);
  w.put(val + 1, ndigit);
}
static inline uint32_t get_gamma(BitReader& r) {
  uint32_t ndigit = r.get_zero_run() + 1;
  if (ndigit == 1) return 0;
  if (ndigit == 0 || ndigit > 32) {
    // no uint32 gamma code has more than 32 digits (put_gamma emits
    // bit_length(val+1) <= 32); a longer run is corruption — and
    // `1u << (ndigit-1)` would be UB. ndigit == 0 is the wrapped
    // over-read marker (a zero run read entirely past the end).
    // Poison the reader so the caller's end-position check reports it.
    r.mark_overread();
    return 0;
  }
  uint32_t rest = (uint32_t)r.get((int)ndigit - 1);
  return (1u << (ndigit - 1)) + rest - 1;
}

// -------------------------------------------------------------- golomb code
static inline void put_golomb(BitWriter& w, uint32_t m, uint32_t val) {
  uint32_t quot = val / m, rest = val % m;
  // static Golomb has no gamma escape: a channel whose u32 parameter store
  // wrapped to a tiny m would make one symbol a multi-gigabit unary run
  // (the Python twin raises the same structured error; valid content never
  // comes near this bound)
  if (quot > (1u << 26)) { w.fatal = true; return; }
  w.put_unary(quot);
  if ((m & (m - 1)) == 0) {  // Rice fast path
    if (m > 1) w.put(rest, log2_pow2(m));
    return;
  }
  int b = 32 - __builtin_clz(m - 1);  // log2ceil(m)
  uint32_t two_b = 1u << b;
  if (rest < two_b - m) w.put(rest, b - 1);
  else w.put(rest + two_b - m, b);
}
static inline uint32_t get_golomb(BitReader& r, uint32_t m) {
  uint32_t quot = r.get_zero_run();
  if ((m & (m - 1)) == 0) {
    uint32_t rest = (m > 1) ? (uint32_t)r.get(log2_pow2(m)) : 0;
    return quot * m + rest;
  }
  int b = 32 - __builtin_clz(m - 1);
  uint32_t two_b = 1u << b;
  uint32_t rest = (uint32_t)r.get(b - 1);
  if (rest < two_b - m) return quot * m + rest;
  rest = (rest << 1) + (uint32_t)r.get(1);
  return quot * m + rest - (two_b - m);
}

// ----------------------------------------------------- recursive Rice codec
struct RiceState {
  uint64_t params[kNumRecursiveParams];
  void init(uint32_t init_param) {
    for (int i = 0; i < kNumRecursiveParams; ++i)
      params[i] = param_set_fixed(init_param);
  }
};

struct RiceParts;
static inline void encode_recursive_rice(RiceState& st, uint32_t val,
                                         RiceParts& p);
static inline void write_rice_parts(BitWriter& w, const RiceParts& p);

static inline void put_recursive_rice(BitWriter& w, RiceState& st, uint32_t val);

// Parts form of put_recursive_rice: encodes the symbol into a right-
// aligned (code, nbits <= 47) pair so the caller can fuse two channels'
// codes into one BitWriter::put. The rare gamma-escape path (quotient >=
// 16, SLAInternal.h:20) reports escape=true and the fields needed to emit
// it verbatim. Parameter updates are identical to put_recursive_rice.
struct RiceParts {
  uint64_t code;
  int32_t nbits;    // valid when !escape
  uint32_t reduced; // escape payload
  int32_t kb1;
  bool escape;
};

static inline void encode_recursive_rice(RiceState& st, uint32_t val,
                                         RiceParts& p) {
  // branchless stage select (the mirror of the decode-side try_sym): the
  // stage-0/stage-1 split is ~60/40 at typical ratios, so the data-
  // dependent branch it replaced was a constant mispredict; masks leave
  // only the rare gamma-escape branch. Measured ~1.55x on the put stage;
  // emitted bits identical.
  static_assert(kNumRecursiveParams == 2, "two-stage structure assumed");
  uint32_t k0 = rice_param(st.params[0]);
  int kb0 = log2_pow2(k0);
  uint32_t k1 = rice_param(st.params[1]);
  int kb1 = log2_pow2(k1);
  const uint32_t m = (uint32_t)-(int32_t)(val >= k0);  // ones iff stage 1
  uint32_t reduced = val - k0;            // garbage at stage 0 (masked out)
  uint32_t tail_quot = 1 + (reduced >> kb1);
  st.params[0] = param_update(st.params[0], val);
  uint64_t p1u = param_update(st.params[1], reduced);
  const uint64_t m64 = (uint64_t)(int64_t)(int32_t)m;
  st.params[1] = (p1u & m64) | (st.params[1] & ~m64);
  if (m && tail_quot >= kQuotThreshold) {
    p.reduced = reduced;
    p.kb1 = kb1;
    p.escape = true;
    return;
  }
  const int kb = kb0 ^ ((kb0 ^ kb1) & (int)m);
  const uint32_t rest = (val ^ ((val ^ reduced) & m)) & ((1u << kb) - 1);
  p.code = (1ull << kb) | rest;
  p.nbits = 1 + kb + (int32_t)(tail_quot & m);
  p.escape = false;
}

static inline void write_rice_parts(BitWriter& w, const RiceParts& p) {
  if (!p.escape) {
    w.put(p.code, p.nbits);
    return;
  }
  uint32_t tail_quot = 1 + (p.reduced >> p.kb1);
  w.put_unary(kQuotThreshold);
  put_gamma(w, tail_quot - kQuotThreshold);
  if (p.kb1 != 0) w.put(p.reduced & ((1u << p.kb1) - 1), p.kb1);
}

static inline void put_recursive_rice(BitWriter& w, RiceState& st, uint32_t val) {
  RiceParts p;
  encode_recursive_rice(st, val, p);
  write_rice_parts(w, p);
}

// Encode one sample for two channels and emit both codes with a single
// accumulator put when they fit in 57 bits (identical bits either way).
// THE fused-pair emit: every stereo/multichannel put loop uses this.
static inline void put_rice_pair(BitWriter& w, RiceState& st0, RiceState& st1,
                                 uint32_t v0, uint32_t v1) {
  RiceParts a, b;
  encode_recursive_rice(st0, v0, a);
  encode_recursive_rice(st1, v1, b);
  if (!a.escape && !b.escape && a.nbits + b.nbits <= 57) {
    w.put((a.code << b.nbits) | b.code, a.nbits + b.nbits);
  } else {
    write_rice_parts(w, a);
    write_rice_parts(w, b);
  }
}

static inline uint32_t get_recursive_rice(BitReader& r, RiceState& st);

// Branchless recursive-Rice symbol decode with validate-before-commit.
// The serial get loop's cost is dominated by data-dependent branches
// (stage-0 vs stage-1 is ~60/40 at typical ratios -> constant
// mispredicts); this variant finds the unary run with one clz over the
// exposed cache window and selects stage via arithmetic masks, so the
// only data-dependent branch left is the combined rare-case test (gamma
// escape, or fewer cached bits than the symbol needs — the caller then
// falls back to the byte-exact slow path from UNTOUCHED state). Safe at
// any ncache, so a stereo loop can refill once per sample instead of per
// symbol (the refill is ~1/3 of the skeleton cost). Bit consumption is
// identical to get_recursive_rice; measured ~1.7-1.9x on the decode
// entropy stage across 5.5-11 bits/sym payloads.
// Scalar-reference form so callers can keep the whole loop-carried state
// (bit cache + both adaptive parameters) in REGISTERS: with the state in
// a RiceState stack array, every parameter update is a load+store on the
// serial chain (~2x on the streaming partial decode below).
static inline __attribute__((always_inline)) bool try_sym_regs(
    uint64_t& cache, int& ncache, uint64_t& p0, uint64_t& p1,
    uint32_t* out_val) {
  // ncache == -1 is the over-read marker (get_zero_run's old-reader
  // semantics): a PRIOR symbol's slow-path escape can leave it set, and
  // the window shift below would be UB — fall back to the byte-exact
  // slow path, which zero-fills consistently
  if ((unsigned)ncache > 63u) return false;
  uint32_t k0 = rice_param(p0);
  int kb0 = log2_pow2(k0);
  // (cache<<1)<<(63-ncache): == cache<<(64-ncache) for ncache>=1 and a
  // defined all-zero window for ncache==0 (plain <<64 would be UB)
  uint64_t win = (cache << 1) << (63 - ncache);
  int lead = __builtin_clzll(win | 1);  // zeros before the terminating 1
  uint32_t k1 = rice_param(p1);
  int kb1 = log2_pow2(k1);
  const uint32_t m32 = (uint32_t)-(int32_t)(lead != 0);  // ones iff stage 1
  const int kb = kb0 ^ ((kb0 ^ kb1) & (int)m32);
  const int consumed = lead + 1 + kb;
  if (lead >= (int)kQuotThreshold || consumed > ncache) return false;
  ncache -= consumed;
  uint32_t rest = (uint32_t)((cache >> ncache) & ((1ull << kb) - 1));
  cache &= (1ull << ncache) - 1;
  uint32_t reduced = k1 * (uint32_t)(lead - 1) + rest;  // garbage at stage 0
  uint32_t val = rest + ((k0 + reduced - rest) & m32);
  p0 = param_update(p0, val);
  uint64_t p1u = param_update(p1, reduced);
  const uint64_t m64 = (uint64_t)(int64_t)(int32_t)m32;
  p1 = (p1u & m64) | (p1 & ~m64);
  *out_val = val;
  return true;
}

static inline bool try_sym(BitReader& r, RiceState& st, uint32_t* out_val) {
  return try_sym_regs(r.cache, r.ncache, st.params[0], st.params[1], out_val);
}

// Per-symbol driver: refill + branchless path while an 8-byte margin
// holds, byte-exact slow path through the buffer tail where the
// zero-fill/over-read semantics live (and for gamma escapes).
static inline uint32_t get_sym_auto(BitReader& r, RiceState& st) {
  if (r.next_byte + 8 <= r.size_bytes) {
    r.refill32();
    uint32_t v;
    if (try_sym(r, st, &v)) return v;
  }
  return get_recursive_rice(r, st);
}

static inline uint32_t get_recursive_rice(BitReader& r, RiceState& st) {
  // specialized two-stage structure, mirror of put_recursive_rice
  static_assert(kNumRecursiveParams == 2, "two-stage structure assumed");
  uint32_t k0 = rice_param(st.params[0]);
  int kb0 = log2_pow2(k0);
  // fast path: a stage-0 symbol is a '1' marker + kb0 remainder bits —
  // one cache extraction instead of zero-run + get (same bits consumed)
  if (r.ncache <= 33) r.refill32();
  if (r.ncache >= 1 + kb0 && (r.cache >> (r.ncache - 1)) & 1) {
    r.ncache -= 1 + kb0;
    uint32_t val = (uint32_t)((r.cache >> r.ncache) & (uint64_t)(k0 - 1));
    r.cache &= (1ull << r.ncache) - 1;
    st.params[0] = param_update(st.params[0], val);
    return val;
  }
  uint32_t quot = r.get_zero_run();
  if (quot == 0) {  // symbol stayed in stage 0 (near-end-of-buffer path)
    uint32_t val = (k0 != 1) ? (uint32_t)r.get(kb0) : 0;
    st.params[0] = param_update(st.params[0], val);
    return val;
  }
  uint32_t k1 = rice_param(st.params[1]);
  if (quot == kQuotThreshold) quot += get_gamma(r);
  uint32_t rest = (k1 != 1) ? (uint32_t)r.get(log2_pow2(k1)) : 0;
  uint32_t reduced = k1 * (quot - 1) + rest;
  uint32_t val = k0 + reduced;
  st.params[0] = param_update(st.params[0], val);
  st.params[1] = param_update(st.params[1], reduced);
  return val;
}

// -------------------------------------------------------------------- CRC16
// CRC16-IBM, reflected, poly 0xA001 (reference src/SLAUtility.c:322-339)
static uint16_t crc16_table[8][256];  // slice-by-8 (same CRC, 8 bytes/step)
static bool crc16_init_done = false;
static void crc16_init();
// build the tables at library load (a global constructor): lazy init from
// concurrently calling threads would race on crc16_init_done
static const bool crc16_tables_ready = (crc16_init(), true);
static void crc16_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int b = 0; b < 8; ++b) c = (c & 1) ? (c >> 1) ^ 0xA001u : c >> 1;
    crc16_table[0][i] = (uint16_t)c;
  }
  for (int t = 1; t < 8; ++t)
    for (uint32_t i = 0; i < 256; ++i)
      crc16_table[t][i] = (uint16_t)((crc16_table[t - 1][i] >> 8) ^
                                     crc16_table[0][crc16_table[t - 1][i] & 0xFF]);
  crc16_init_done = true;
}

}  // namespace

extern "C" {

// CRC16-IBM, table path (slice-by-8) with an arbitrary initial state.
static uint16_t crc16_table_run(const uint8_t* data, int64_t size,
                                uint16_t crc) {
  int64_t i = 0;
  for (; i + 8 <= size; i += 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data + i, 8);
    chunk ^= crc;  // low 2 bytes absorb the running CRC (reflected poly)
    crc = (uint16_t)(crc16_table[7][chunk & 0xFF] ^
                     crc16_table[6][(chunk >> 8) & 0xFF] ^
                     crc16_table[5][(chunk >> 16) & 0xFF] ^
                     crc16_table[4][(chunk >> 24) & 0xFF] ^
                     crc16_table[3][(chunk >> 32) & 0xFF] ^
                     crc16_table[2][(chunk >> 40) & 0xFF] ^
                     crc16_table[1][(chunk >> 48) & 0xFF] ^
                     crc16_table[0][(chunk >> 56) & 0xFF]);
  }
  for (; i < size; ++i)
    crc = (uint16_t)((crc >> 8) ^ crc16_table[0][(crc ^ data[i]) & 0xFF]);
  return crc;
}

// CRC16-IBM over a byte buffer.
//
// Bulk path: PCLMULQDQ folding in the reflected-clmul domain. The message
// register loads little-endian, so register bit j holds the message bit of
// degree 127-j; folding a 128-bit block across a distance of D bytes is
// X -> clmul(X_lo64, rev64(x^(8D+63) mod P)) ^ clmul(X_hi64,
// rev64(x^(8D-1) mod P)), where the extra ·x from the 127- vs 128-bit
// reversal off-by-one is absorbed into the exponents (hence 63/-1 instead
// of 64/0). Four independent lanes fold at distance 64 bytes so the ~7-
// cycle clmul latencies overlap, then merge at distance 16. The final
// 128-bit register, read back as 16 little-endian bytes, is by the same
// encoding argument a MESSAGE with the identical CRC — so the reduction is
// 16 table steps, no Barrett constants. Constants generated and the whole
// dataflow validated against the bitwise CRC in a Python GF(2) model;
// byte-exact by construction (the stream format depends on it).
uint16_t sla_crc16(const uint8_t* data, int64_t size) {
  if (!crc16_init_done) crc16_init();
#if defined(__PCLMUL__) && defined(__SSE2__)
  if (size >= 64) {
    // rev64(x^e mod P) << 48 for e = 191 / 127 (distance 16 bytes) and
    // e = 575 / 511 (distance 64 bytes)
    const __m128i K1 = _mm_set_epi64x((int64_t)0xc100000000000000ull,
                                      (int64_t)0xccd0000000000000ull);
    const __m128i K4 = _mm_set_epi64x((int64_t)0x8101000000000000ull,
                                      (int64_t)0xc450000000000000ull);
    __m128i x0 = _mm_loadu_si128((const __m128i*)(data + 0));
    __m128i x1 = _mm_loadu_si128((const __m128i*)(data + 16));
    __m128i x2 = _mm_loadu_si128((const __m128i*)(data + 32));
    __m128i x3 = _mm_loadu_si128((const __m128i*)(data + 48));
    int64_t pos = 64;
    for (; pos + 64 <= size; pos += 64) {
      x0 = _mm_xor_si128(
          _mm_xor_si128(_mm_clmulepi64_si128(x0, K4, 0x00),
                        _mm_clmulepi64_si128(x0, K4, 0x11)),
          _mm_loadu_si128((const __m128i*)(data + pos)));
      x1 = _mm_xor_si128(
          _mm_xor_si128(_mm_clmulepi64_si128(x1, K4, 0x00),
                        _mm_clmulepi64_si128(x1, K4, 0x11)),
          _mm_loadu_si128((const __m128i*)(data + pos + 16)));
      x2 = _mm_xor_si128(
          _mm_xor_si128(_mm_clmulepi64_si128(x2, K4, 0x00),
                        _mm_clmulepi64_si128(x2, K4, 0x11)),
          _mm_loadu_si128((const __m128i*)(data + pos + 32)));
      x3 = _mm_xor_si128(
          _mm_xor_si128(_mm_clmulepi64_si128(x3, K4, 0x00),
                        _mm_clmulepi64_si128(x3, K4, 0x11)),
          _mm_loadu_si128((const __m128i*)(data + pos + 48)));
    }
    __m128i y = x0;
    y = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(y, K1, 0x00),
                                    _mm_clmulepi64_si128(y, K1, 0x11)), x1);
    y = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(y, K1, 0x00),
                                    _mm_clmulepi64_si128(y, K1, 0x11)), x2);
    y = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(y, K1, 0x00),
                                    _mm_clmulepi64_si128(y, K1, 0x11)), x3);
    for (; pos + 16 <= size; pos += 16) {
      y = _mm_xor_si128(
          _mm_xor_si128(_mm_clmulepi64_si128(y, K1, 0x00),
                        _mm_clmulepi64_si128(y, K1, 0x11)),
          _mm_loadu_si128((const __m128i*)(data + pos)));
    }
    alignas(16) uint8_t reg[16];
    _mm_store_si128((__m128i*)reg, y);
    uint16_t crc = crc16_table_run(reg, 16, 0);
    return crc16_table_run(data + pos, size - pos, crc);
  }
#endif
  return crc16_table_run(data, size, 0);
}

// Channel-interleaved payload encode (semantics: SLACoder_PutDataArray).
// data: C rows of N int32 (row-major, stride N). init_params: C plain
// integer initial parameters. out: byte buffer (byte-aligned start); the
// payload is flushed to a byte boundary. Returns bytes written, or -1 on
// overflow of out_capacity.
int64_t sla_put_data_array(const int32_t* data, int32_t C, int32_t N,
                           const uint32_t* init_params, uint8_t* out,
                           int64_t out_capacity) {
  if (C <= 0 || C > 64) return -2;  // scratch capacity: don't trust callers
  BitWriter w;
  w.init(out, out_capacity);
  uint64_t eff_sum = 0;
  uint32_t eff[64];
  for (int ch = 0; ch < C; ++ch) {
    eff[ch] = param_get(param_set_fixed(init_params[ch]));
    eff_sum += eff[ch];
  }
  if (eff_sum / (uint32_t)C > kLowThreshold) {
    RiceState st[64];
    for (int ch = 0; ch < C; ++ch) st[ch].init(init_params[ch]);
    if (C == 2) {  // stereo fast path: direct row pointers, no inner loop
      const int32_t* d0 = data;
      const int32_t* d1 = data + N;
      const uint32_t *z0, *z1;
      stage_zigzag_stereo(d0, d1, N, &z0, &z1);
      for (int s = 0; s < N; ++s) put_rice_pair(w, st[0], st[1], z0[s], z1[s]);
    } else {
      // multichannel: fuse channel pairs per sample (same bits, fewer
      // accumulator drains — the 5.1 layout codes three pairs per sample)
      for (int s = 0; s < N; ++s) {
        int ch = 0;
        for (; ch + 2 <= C; ch += 2)
          put_rice_pair(w, st[ch], st[ch + 1],
                        zigzag(data[(int64_t)ch * N + s]),
                        zigzag(data[(int64_t)(ch + 1) * N + s]));
        if (ch < C)
          put_recursive_rice(w, st[ch], zigzag(data[(int64_t)ch * N + s]));
      }
    }
  } else {
    for (int s = 0; s < N; ++s)
      for (int ch = 0; ch < C; ++ch)
        put_golomb(w, eff[ch], zigzag(data[(int64_t)ch * N + s]));
  }
  w.flush();
  if (w.fatal) return -3;  // pathological static-Golomb run
  return w.overflow ? -1 : w.nbytes;
}

// Channel-interleaved payload decode (semantics: SLACoder_GetDataArray).
// in/in_size: whole stream buffer; bit_offset: payload start (byte-aligned).
// out: C*N int32, row-major. Returns the bit position after the payload.
static int64_t get_data_array_rs(const uint8_t* in, int64_t in_size,
                                 int64_t bit_offset, int32_t C, int32_t N,
                                 const uint32_t* init_params, int32_t* out,
                                 int64_t rs /* channel-row stride, >= N */) {
  if (C <= 0 || C > 64) return -2;  // scratch capacity: don't trust callers
  BitReader r;
  r.init(in, in_size, bit_offset);
  uint64_t eff_sum = 0;
  uint32_t eff[64];
  for (int ch = 0; ch < C; ++ch) {
    eff[ch] = param_get(param_set_fixed(init_params[ch]));
    eff_sum += eff[ch];
  }
  if (eff_sum / (uint32_t)C > kLowThreshold) {
    RiceState st[64];
    for (int ch = 0; ch < C; ++ch) st[ch].init(init_params[ch]);
    if (C == 2) {  // stereo fast path: one refill per sample, two try_syms
      int32_t* o0 = out;
      int32_t* o1 = out + rs;
      int s = 0;
      for (; s < N && r.next_byte + 8 <= r.size_bytes; ++s) {
        r.refill32();
        uint32_t u0, u1;
        if (!try_sym(r, st[0], &u0)) u0 = get_recursive_rice(r, st[0]);
        if (!try_sym(r, st[1], &u1)) u1 = get_recursive_rice(r, st[1]);
        o0[s] = unzigzag(u0);
        o1[s] = unzigzag(u1);
      }
      for (; s < N; ++s) {  // buffer tail: byte-exact slow path
        o0[s] = unzigzag(get_recursive_rice(r, st[0]));
        o1[s] = unzigzag(get_recursive_rice(r, st[1]));
      }
    } else {
      for (int s = 0; s < N; ++s)
        for (int ch = 0; ch < C; ++ch)
          out[(int64_t)ch * rs + s] = unzigzag(get_sym_auto(r, st[ch]));
    }
  } else {
    for (int s = 0; s < N; ++s)
      for (int ch = 0; ch < C; ++ch)
        out[(int64_t)ch * rs + s] = unzigzag(get_golomb(r, eff[ch]));
  }
  return r.pos();
}

int64_t sla_get_data_array(const uint8_t* in, int64_t in_size,
                           int64_t bit_offset, int32_t C, int32_t N,
                           const uint32_t* init_params, int32_t* out) {
  return get_data_array_rs(in, in_size, bit_offset, C, N, init_params, out, N);
}

#if defined(__AVX512F__) && defined(__AVX512CD__) && defined(__AVX512BW__) && \
    defined(__AVX512DQ__)
// ---- 8-lane vectorized block decode --------------------------------------
// Blocks are independent byte-aligned bitstreams, so eight decode cursors
// ride the 64-bit lanes of one zmm register set. The branchless
// validate-before-commit symbol step (try_sym) vectorizes lane-for-lane:
// window expose via variable shifts, unary run via vplzcntq, stage select
// and parameter updates via masks. A lane that fails validation (gamma
// escape, or fewer cached bits than the symbol needs) keeps its state
// UNTOUCHED and re-decodes that one symbol through the byte-exact scalar
// path, so bit consumption, parameter evolution, and outputs are identical
// to the serial loop for every stream, valid or corrupt.

extern "C++" {

static inline __m512i vdec_bswap64(__m512i v) {
  const __m128i bs = _mm_set_epi8(8, 9, 10, 11, 12, 13, 14, 15,
                                  0, 1, 2, 3, 4, 5, 6, 7);
  return _mm512_shuffle_epi8(v, _mm512_broadcast_i32x4(bs));
}

// Scalar remainder of one lane's block (same structure as
// sla_get_data_array's stereo/mono loops), from an evolved reader state.
template <int CH>
static void vdec_finish_lane(BitReader& r, RiceState* st, int32_t** o,
                             int32_t s, int32_t N) {
  for (; s < N && r.next_byte + 8 <= r.size_bytes; ++s) {
    r.refill32();
    for (int ch = 0; ch < CH; ++ch) {
      uint32_t u;
      if (!try_sym(r, st[ch], &u)) u = get_recursive_rice(r, st[ch]);
      o[ch][s] = unzigzag(u);
    }
  }
  for (; s < N; ++s)  // buffer tail: byte-exact slow path
    for (int ch = 0; ch < CH; ++ch)
      o[ch][s] = unzigzag(get_recursive_rice(r, st[ch]));
}

// Eight adaptive-Rice blocks b..b+7, CH channels each, decoded in lanes.
// Returns 0 or -(block+2) on an over-read (caller semantics).
template <int CH>
static int64_t decode_blocks_v8(const uint8_t* in, int64_t in_size,
                                const int64_t* bit_offsets, int32_t C,
                                const int32_t* ns, const uint32_t* init,
                                int32_t* out, const int64_t* out_offs,
                                int64_t row_stride, const int32_t* blks) {
  // lane state spill area (vector<->scalar round trips on rare fallbacks)
  alignas(64) uint64_t a_cache[8], a_nc[8], a_nb[8], a_p[CH][2][8];
  int32_t* optr[CH][8];
  int32_t nmin = INT32_MAX;
  for (int l = 0; l < 8; ++l) {
    const int32_t blk = blks[l];
    BitReader r;
    r.init(in, in_size, bit_offsets[blk]);
    a_cache[l] = r.cache;
    a_nc[l] = (uint64_t)r.ncache;
    a_nb[l] = (uint64_t)r.next_byte;
    for (int ch = 0; ch < CH; ++ch) {
      const uint64_t p = param_set_fixed(init[(int64_t)blk * C + ch]);
      a_p[ch][0][l] = p;
      a_p[ch][1][l] = p;
      optr[ch][l] =
          out + out_offs[blk] +
          (int64_t)ch * (row_stride ? row_stride : (int64_t)ns[blk]);
    }
    nmin = ns[blk] < nmin ? ns[blk] : nmin;
  }
  __m512i vcache = _mm512_load_si512(a_cache);
  __m512i vnc = _mm512_load_si512(a_nc);
  __m512i vnb = _mm512_load_si512(a_nb);
  __m512i vp[CH][2];
  for (int ch = 0; ch < CH; ++ch) {
    vp[ch][0] = _mm512_load_si512(a_p[ch][0]);
    vp[ch][1] = _mm512_load_si512(a_p[ch][1]);
  }
  const __m512i v0 = _mm512_setzero_si512();
  const __m512i v1 = _mm512_set1_epi64(1);
  const __m512i v16 = _mm512_set1_epi64(16);
  const __m512i v63 = _mm512_set1_epi64(63);
  const __m512i v64 = _mm512_set1_epi64(64);
  const __m512i vhalf = _mm512_set1_epi64((long long)kHalf);
  const __m512i vrnd = _mm512_set1_epi64(1 << 6);
  const __m512i vu32 = _mm512_set1_epi64(0xFFFFFFFFll);
  const __m512i vsz8 = _mm512_set1_epi64(in_size - 8);

  // spill/reload helpers for the rare scalar fallback
  auto spill = [&]() {
    _mm512_store_si512(a_cache, vcache);
    _mm512_store_si512(a_nc, vnc);
    _mm512_store_si512(a_nb, vnb);
    for (int ch = 0; ch < CH; ++ch) {
      _mm512_store_si512(a_p[ch][0], vp[ch][0]);
      _mm512_store_si512(a_p[ch][1], vp[ch][1]);
    }
  };
  auto reload = [&]() {
    vcache = _mm512_load_si512(a_cache);
    vnc = _mm512_load_si512(a_nc);
    vnb = _mm512_load_si512(a_nb);
    for (int ch = 0; ch < CH; ++ch) {
      vp[ch][0] = _mm512_load_si512(a_p[ch][0]);
      vp[ch][1] = _mm512_load_si512(a_p[ch][1]);
    }
  };

  alignas(64) uint32_t tile[CH][8][8];  // [ch][sample-in-tile][lane]
  // Pipelined refill: vraw always holds the 8 bytes at in + vnb for every
  // lane still inside the 8-byte margin (vnb <= size - 8). Each refill
  // consumes vraw with register ops only and immediately re-issues the
  // gather for the new vnb, so the gather's ~25-cycle latency overlaps the
  // following symbol decodes instead of blocking the refill. Identical
  // bytes reach the cache in the identical order (in[] is immutable and
  // vnb is unchanged between the gather and its use), so outputs are
  // byte-identical to the on-demand form.
  __m512i vraw = _mm512_mask_i64gather_epi64(
      v0, _mm512_cmple_epi64_mask(vnb, vsz8), vnb, in, 1);
  // refill32 bulk path: nb = (63 - ncache) >> 3, only for lanes below 40
  // cached bits AND inside the margin (their vraw is valid) — a 64-bit
  // cache feeds ~2 stereo samples per refill, and refill cadence cannot
  // change the bits any symbol consumes (a genuinely cache-short symbol
  // fails validation and re-decodes byte-exactly from untouched state)
  auto vrefill = [&](__mmask8 lowm) {
    const __m512i nb = _mm512_srli_epi64(_mm512_sub_epi64(v63, vnc), 3);
    const __mmask8 dorf = lowm & _mm512_cmpgt_epi64_mask(nb, v0);
    const __m512i raw = vdec_bswap64(vraw);
    const __m512i sh8 = _mm512_slli_epi64(nb, 3);
    const __m512i newc = _mm512_or_si512(
        _mm512_sllv_epi64(vcache, sh8),
        _mm512_srlv_epi64(raw, _mm512_sub_epi64(v64, sh8)));
    vcache = _mm512_mask_mov_epi64(vcache, dorf, newc);
    vnb = _mm512_mask_add_epi64(vnb, dorf, vnb, nb);
    vnc = _mm512_mask_add_epi64(vnc, dorf, vnc, sh8);
    const __mmask8 mg = dorf & _mm512_cmple_epi64_mask(vnb, vsz8);
    vraw = _mm512_mask_i64gather_epi64(vraw, mg, vnb, in, 1);
  };
  int32_t s = 0;
  for (; s < nmin;) {
    // margin (scalar loop gate): every lane has next_byte + 8 <= size
    if (_mm512_cmpgt_epi64_mask(vnb, vsz8) != 0) break;
    const int32_t tlim = (nmin - s) < 8 ? (nmin - s) : 8;
    int32_t ti = 0;
    for (; ti < tlim; ++ti) {
      if (_mm512_cmpgt_epi64_mask(vnb, vsz8) != 0) break;
      {
        const __mmask8 lowm =
            _mm512_cmple_epi64_mask(vnc, _mm512_set1_epi64(40));
        if (lowm) vrefill(lowm);
      }
      for (int ch = 0; ch < CH; ++ch) {
        if (CH >= 3 && ch > 0) {
          // many channels can drain the 64-bit cache mid-sample: top up
          // lanes running low (refill cadence does not affect the bits
          // any symbol consumes, so outputs are unchanged)
          const __mmask8 low =
              _mm512_cmple_epi64_mask(vnc, _mm512_set1_epi64(40)) &
              _mm512_cmple_epi64_mask(vnb, vsz8);  // keep the 8-byte margin
          if (low) vrefill(low);
        }
        __m512i p0 = vp[ch][0], p1 = vp[ch][1];
        // k parameters and their log2 (rice_param + log2_pow2):
        // kb = 64 - lzcnt(h - 1) == log2ceil(h), 0 for h == 1
        __m512i h0 = _mm512_srli_epi64(
            _mm512_add_epi64(_mm512_srli_epi64(p0, 1), vhalf), kFrac);
        h0 = _mm512_max_epu64(h0, v1);
        const __m512i kb0 =
            _mm512_sub_epi64(v64, _mm512_lzcnt_epi64(_mm512_sub_epi64(h0, v1)));
        __m512i h1 = _mm512_srli_epi64(
            _mm512_add_epi64(_mm512_srli_epi64(p1, 1), vhalf), kFrac);
        h1 = _mm512_max_epu64(h1, v1);
        const __m512i kb1 =
            _mm512_sub_epi64(v64, _mm512_lzcnt_epi64(_mm512_sub_epi64(h1, v1)));
        // exposed window + unary run (try_sym)
        const __m512i win = _mm512_sllv_epi64(_mm512_slli_epi64(vcache, 1),
                                              _mm512_sub_epi64(v63, vnc));
        const __m512i lead = _mm512_lzcnt_epi64(_mm512_or_si512(win, v1));
        const __mmask8 mstage = _mm512_cmpneq_epi64_mask(lead, v0);
        const __m512i kb = _mm512_mask_mov_epi64(kb0, mstage, kb1);
        const __m512i consumed =
            _mm512_add_epi64(_mm512_add_epi64(lead, v1), kb);
        const __mmask8 fail = _mm512_cmpge_epu64_mask(lead, v16) |
                              _mm512_cmpgt_epu64_mask(consumed, vnc);
        const __mmask8 ok = (__mmask8)(~fail);
        const __m512i nc2 = _mm512_sub_epi64(vnc, consumed);
        const __m512i rest = _mm512_and_si512(
            _mm512_srlv_epi64(vcache, nc2),
            _mm512_sub_epi64(_mm512_sllv_epi64(v1, kb), v1));
        const __m512i cache2 = _mm512_and_si512(
            vcache, _mm512_sub_epi64(_mm512_sllv_epi64(v1, nc2), v1));
        // reduced = k1 * (lead - 1) + rest, uint32 wrap like the scalar
        const __m512i reduced = _mm512_and_si512(
            _mm512_add_epi64(
                _mm512_sllv_epi64(_mm512_sub_epi64(lead, v1), kb1), rest),
            vu32);
        const __m512i k0v = _mm512_sllv_epi64(v1, kb0);
        const __m512i val = _mm512_and_si512(
            _mm512_mask_add_epi64(rest, mstage, k0v, reduced), vu32);
        // param_update(p, code) = (119 p + 9 (code << kFrac) + 64) >> 7
        // with the uint32 wrap of the 9*(code<<kFrac) term preserved
        const __m512i t0m = _mm512_and_si512(_mm512_slli_epi64(val, kFrac), vu32);
        const __m512i t0 = _mm512_and_si512(
            _mm512_add_epi64(_mm512_slli_epi64(t0m, 3), t0m), vu32);
        const __m512i p0x119 = _mm512_sub_epi64(
            _mm512_slli_epi64(p0, 7),
            _mm512_add_epi64(_mm512_slli_epi64(p0, 3), p0));
        const __m512i p0n = _mm512_srli_epi64(
            _mm512_add_epi64(_mm512_add_epi64(p0x119, t0), vrnd), 7);
        const __m512i t1m =
            _mm512_and_si512(_mm512_slli_epi64(reduced, kFrac), vu32);
        const __m512i t1 = _mm512_and_si512(
            _mm512_add_epi64(_mm512_slli_epi64(t1m, 3), t1m), vu32);
        const __m512i p1x119 = _mm512_sub_epi64(
            _mm512_slli_epi64(p1, 7),
            _mm512_add_epi64(_mm512_slli_epi64(p1, 3), p1));
        const __m512i p1n = _mm512_srli_epi64(
            _mm512_add_epi64(_mm512_add_epi64(p1x119, t1), vrnd), 7);
        vp[ch][0] = _mm512_mask_mov_epi64(p0, ok, p0n);
        vp[ch][1] = _mm512_mask_mov_epi64(p1, (__mmask8)(ok & mstage), p1n);
        vcache = _mm512_mask_mov_epi64(vcache, ok, cache2);
        vnc = _mm512_mask_mov_epi64(vnc, ok, nc2);
        // stage the unzigzagged values into the lane tile
        __m256i v32 = _mm512_cvtepi64_epi32(val);
        v32 = _mm256_xor_si256(
            _mm256_srli_epi32(v32, 1),
            _mm256_sub_epi32(_mm256_setzero_si256(),
                             _mm256_and_si256(v32, _mm256_set1_epi32(1))));
        _mm256_store_si256((__m256i*)tile[ch][ti], v32);
        if (fail) {
          // rare: escape or cache-short — redo those lanes byte-exactly
          // from their untouched state
          spill();
          for (int l = 0; l < 8; ++l) {
            if (!(fail & (1 << l))) continue;
            BitReader r;
            r.buf = in;
            r.size_bytes = in_size;
            r.next_byte = (int64_t)a_nb[l];
            r.cache = a_cache[l];
            r.ncache = (int)a_nc[l];
            RiceState st;
            st.params[0] = a_p[ch][0][l];
            st.params[1] = a_p[ch][1][l];
            const uint32_t u = get_recursive_rice(r, st);
            tile[ch][ti][l] = (uint32_t)unzigzag(u);
            a_nb[l] = (uint64_t)r.next_byte;
            a_cache[l] = r.cache;
            a_nc[l] = (uint64_t)(int64_t)r.ncache;
            a_p[ch][0][l] = st.params[0];
            a_p[ch][1][l] = st.params[1];
          }
          reload();
          // the scalar redo advanced vnb for the failed lanes: re-establish
          // the pipelined-gather invariant for every lane still in margin
          vraw = _mm512_mask_i64gather_epi64(
              vraw, _mm512_cmple_epi64_mask(vnb, vsz8), vnb, in, 1);
        }
      }
    }
    // flush the tile: transpose lanes to rows, contiguous per-lane stores
    for (int ch = 0; ch < CH; ++ch) {
      if (ti == 8) {
        __m256i m[8];
        for (int k = 0; k < 8; ++k) m[k] = _mm256_load_si256((__m256i*)tile[ch][k]);
        tile_transpose8(m);
        for (int l = 0; l < 8; ++l)
          _mm256_storeu_si256((__m256i*)(optr[ch][l] + s), m[l]);
      } else {
        for (int k = 0; k < ti; ++k)
          for (int l = 0; l < 8; ++l)
            optr[ch][l][s + k] = (int32_t)tile[ch][k][l];
      }
    }
    s += ti;
    if (ti < tlim) break;  // a lane left the 8-byte margin: scalar finish
  }
  // finish every lane through the scalar path (tails, margins, and any
  // lanes whose blocks are longer than nmin)
  spill();
  for (int l = 0; l < 8; ++l) {
    const int32_t blk = blks[l];
    BitReader r;
    r.buf = in;
    r.size_bytes = in_size;
    r.next_byte = (int64_t)a_nb[l];
    r.cache = a_cache[l];
    r.ncache = (int)a_nc[l];
    RiceState st[CH];
    int32_t* o[CH];
    for (int ch = 0; ch < CH; ++ch) {
      st[ch].params[0] = a_p[ch][0][l];
      st[ch].params[1] = a_p[ch][1][l];
      o[ch] = optr[ch][l];
    }
    vdec_finish_lane<CH>(r, st, o, s, ns[blk]);
    if (r.pos() > in_size * 8) return -((int64_t)blk + 2);
  }
  return 0;
}

// ---- 8-lane vectorized payload encode ------------------------------------
// The put-side twin: eight blocks' payloads emit concurrently, one block
// per 64-bit lane, each into its own byte buffer via 8-byte scattered
// drains. encode_recursive_rice vectorizes directly (it is already
// branchless); the rare gamma escape exports that lane's writer state and
// emits the escape through the scalar path, so every lane's byte stream
// is identical to the serial BitWriter's.

// Scalar remainder of one lane's payload from evolved writer state.
template <int CH>
static void venc_finish_lane(BitWriter& w, RiceState* st,
                             const int32_t* const* d, int32_t s, int32_t N) {
  for (; s < N; ++s) {  // fused pairs + odd remainder, like the serial path
    int ch = 0;
    for (; ch + 2 <= CH; ch += 2)
      put_rice_pair(w, st[ch], st[ch + 1], zigzag(d[ch][s]),
                    zigzag(d[ch + 1][s]));
    if (ch < CH) put_recursive_rice(w, st[ch], zigzag(d[ch][s]));
  }
}

// Encode payloads for eight adaptive COMPRESSDATA blocks into the eight
// lane buffers. BUFFER CONTRACT: each lane buffer must hold >= cap + 512
// bytes — the cap check runs once per 8-sample group (vcapg below), and
// within a group a lane can emit up to 8*CH symbols of unchecked 8-byte
// scatter drains (~320 bytes at CH=8) past the check point, plus the
// 8-byte drain slack. The sole caller (encode_block_run) allocates
// lane_cap + 1024. d[l*CH+ch] are the
// residual rows, n[l] the sample counts, init[l*CH+ch] the initial Rice
// parameters. Payload byte sizes (byte-aligned, flush-padded) land in
// psize[l]. Returns 0, or -1 if a lane approached its buffer cap (caller
// falls back to the scalar per-block path, which does exact cap checks).
template <int CH>
static int32_t encode_payloads_v8(const int32_t* const* d, const int32_t* n,
                                  const uint32_t* init, uint8_t* const* bufs,
                                  int64_t cap, int64_t* psize) {
  alignas(64) uint64_t a_acc[8], a_nacc[8], a_nbytes[8], a_p[CH][2][8],
      a_addr[8];
  int32_t nmin = INT32_MAX;
  for (int l = 0; l < 8; ++l) {
    a_acc[l] = 0;
    a_nacc[l] = 0;
    a_nbytes[l] = 0;
    a_addr[l] = (uint64_t)(uintptr_t)bufs[l];
    for (int ch = 0; ch < CH; ++ch) {
      const uint64_t p = param_set_fixed(init[l * CH + ch]);
      a_p[ch][0][l] = p;
      a_p[ch][1][l] = p;
    }
    nmin = n[l] < nmin ? n[l] : nmin;
  }
  __m512i vacc = _mm512_load_si512(a_acc);
  __m512i vnacc = _mm512_load_si512(a_nacc);
  __m512i vnbytes = _mm512_load_si512(a_nbytes);
  const __m512i vaddr = _mm512_load_si512(a_addr);
  __m512i vp[CH][2];
  for (int ch = 0; ch < CH; ++ch) {
    vp[ch][0] = _mm512_load_si512(a_p[ch][0]);
    vp[ch][1] = _mm512_load_si512(a_p[ch][1]);
  }
  const __m512i v0 = _mm512_setzero_si512();
  const __m512i v1 = _mm512_set1_epi64(1);
  const __m512i v7 = _mm512_set1_epi64(7);
  const __m512i v16 = _mm512_set1_epi64(16);
  const __m512i v64 = _mm512_set1_epi64(64);
  const __m512i vhalf = _mm512_set1_epi64((long long)kHalf);
  const __m512i vrnd = _mm512_set1_epi64(1 << 6);
  const __m512i vu32 = _mm512_set1_epi64(0xFFFFFFFFll);
  const __m512i vcapg = _mm512_set1_epi64(cap - 64);

  auto spill = [&]() {
    _mm512_store_si512(a_acc, vacc);
    _mm512_store_si512(a_nacc, vnacc);
    _mm512_store_si512(a_nbytes, vnbytes);
    for (int ch = 0; ch < CH; ++ch) {
      _mm512_store_si512(a_p[ch][0], vp[ch][0]);
      _mm512_store_si512(a_p[ch][1], vp[ch][1]);
    }
  };
  auto reload_w = [&]() {
    vacc = _mm512_load_si512(a_acc);
    vnacc = _mm512_load_si512(a_nacc);
    vnbytes = _mm512_load_si512(a_nbytes);
  };

  int32_t s = 0;
  bool capped = false;
  for (; s + 8 <= nmin && !capped;) {
    // stage: zigzag 8 consecutive samples per lane per channel, transpose
    // to per-sample lane vectors
    __m256i vals[CH][8];
    for (int ch = 0; ch < CH; ++ch) {
      __m256i m[8];
      for (int l = 0; l < 8; ++l) {
        __m256i x = _mm256_loadu_si256((const __m256i*)(d[l * CH + ch] + s));
        m[l] = _mm256_xor_si256(_mm256_slli_epi32(x, 1),
                                _mm256_srai_epi32(x, 31));
      }
      tile_transpose8(m);
      for (int k = 0; k < 8; ++k) vals[ch][k] = m[k];
    }
    for (int k = 0; k < 8; ++k) {
      for (int ch = 0; ch < CH; ++ch) {
        const __m512i val = _mm512_cvtepu32_epi64(vals[ch][k]);
        __m512i p0 = vp[ch][0], p1 = vp[ch][1];
        __m512i h0 = _mm512_srli_epi64(
            _mm512_add_epi64(_mm512_srli_epi64(p0, 1), vhalf), kFrac);
        h0 = _mm512_max_epu64(h0, v1);
        const __m512i kb0 =
            _mm512_sub_epi64(v64, _mm512_lzcnt_epi64(_mm512_sub_epi64(h0, v1)));
        __m512i h1 = _mm512_srli_epi64(
            _mm512_add_epi64(_mm512_srli_epi64(p1, 1), vhalf), kFrac);
        h1 = _mm512_max_epu64(h1, v1);
        const __m512i kb1 =
            _mm512_sub_epi64(v64, _mm512_lzcnt_epi64(_mm512_sub_epi64(h1, v1)));
        const __m512i k0v = _mm512_sllv_epi64(v1, kb0);
        const __mmask8 mstage = _mm512_cmpge_epu64_mask(val, k0v);
        const __m512i reduced =
            _mm512_and_si512(_mm512_sub_epi64(val, k0v), vu32);
        const __m512i tail_quot =
            _mm512_add_epi64(v1, _mm512_srlv_epi64(reduced, kb1));
        // parameter updates commit BEFORE the escape branch, exactly like
        // encode_recursive_rice
        const __m512i t0m = _mm512_and_si512(_mm512_slli_epi64(val, kFrac), vu32);
        const __m512i t0 = _mm512_and_si512(
            _mm512_add_epi64(_mm512_slli_epi64(t0m, 3), t0m), vu32);
        const __m512i p0x119 = _mm512_sub_epi64(
            _mm512_slli_epi64(p0, 7),
            _mm512_add_epi64(_mm512_slli_epi64(p0, 3), p0));
        vp[ch][0] = _mm512_srli_epi64(
            _mm512_add_epi64(_mm512_add_epi64(p0x119, t0), vrnd), 7);
        const __m512i t1m =
            _mm512_and_si512(_mm512_slli_epi64(reduced, kFrac), vu32);
        const __m512i t1 = _mm512_and_si512(
            _mm512_add_epi64(_mm512_slli_epi64(t1m, 3), t1m), vu32);
        const __m512i p1x119 = _mm512_sub_epi64(
            _mm512_slli_epi64(p1, 7),
            _mm512_add_epi64(_mm512_slli_epi64(p1, 3), p1));
        const __m512i p1n = _mm512_srli_epi64(
            _mm512_add_epi64(_mm512_add_epi64(p1x119, t1), vrnd), 7);
        vp[ch][1] = _mm512_mask_mov_epi64(p1, mstage, p1n);
        const __mmask8 esc =
            mstage & _mm512_cmpge_epu64_mask(tail_quot, v16);
        const __mmask8 put = (__mmask8)(~esc);
        const __m512i kb = _mm512_mask_mov_epi64(kb0, mstage, kb1);
        const __m512i rest = _mm512_and_si512(
            _mm512_mask_mov_epi64(val, mstage, reduced),
            _mm512_sub_epi64(_mm512_sllv_epi64(v1, kb), v1));
        const __m512i code =
            _mm512_or_si512(_mm512_sllv_epi64(v1, kb), rest);
        const __m512i nbits = _mm512_add_epi64(
            _mm512_add_epi64(v1, kb),
            _mm512_maskz_mov_epi64(mstage, tail_quot));
        // put: acc = (acc << nbits) | code on non-escape lanes
        vacc = _mm512_mask_mov_epi64(
            vacc, put,
            _mm512_or_si512(_mm512_sllv_epi64(vacc, nbits), code));
        vnacc = _mm512_mask_add_epi64(vnacc, put, vnacc, nbits);
        // drain whole bytes: one scattered 8-byte store per lane (tail
        // slack overwritten by the next drain, like BitWriter::drain)
        const __m512i outb = _mm512_srli_epi64(vnacc, 3);
        const __m512i keep = _mm512_and_si512(vnacc, v7);
        const __m512i be = vdec_bswap64(_mm512_sllv_epi64(
            _mm512_srlv_epi64(vacc, keep),
            _mm512_sub_epi64(v64, _mm512_slli_epi64(outb, 3))));
        _mm512_i64scatter_epi64(
            (void*)0, _mm512_add_epi64(vaddr, vnbytes), be, 1);
        vnbytes = _mm512_add_epi64(vnbytes, outb);
        vnacc = keep;
        vacc = _mm512_and_si512(
            vacc, _mm512_sub_epi64(_mm512_sllv_epi64(v1, keep), v1));
        if (esc) {
          // rare gamma escape: emit through the scalar writer per lane
          spill();
          for (int l = 0; l < 8; ++l) {
            if (!(esc & (1 << l))) continue;
            BitWriter w;
            w.buf = bufs[l];
            w.cap = cap;
            w.nbytes = (int64_t)a_nbytes[l];
            w.acc = a_acc[l];
            w.nacc = (int)a_nacc[l];
            w.overflow = false;
            RiceParts prt;
            prt.escape = true;
            alignas(64) uint64_t kb1_a[8], red_a[8];
            _mm512_store_si512(kb1_a, kb1);
            _mm512_store_si512(red_a, reduced);
            prt.reduced = (uint32_t)red_a[l];
            prt.kb1 = (int32_t)kb1_a[l];
            write_rice_parts(w, prt);
            a_nbytes[l] = (uint64_t)w.nbytes;
            a_acc[l] = w.acc;
            a_nacc[l] = (uint64_t)(int64_t)w.nacc;
          }
          reload_w();
        }
      }
    }
    s += 8;
    if (_mm512_cmpgt_epi64_mask(vnbytes, vcapg) != 0) capped = true;
  }
  // scalar tails from evolved state
  spill();
  for (int l = 0; l < 8; ++l) {
    BitWriter w;
    w.buf = bufs[l];
    w.cap = cap;
    w.nbytes = (int64_t)a_nbytes[l];
    w.acc = a_acc[l];
    w.nacc = (int)a_nacc[l];
    w.overflow = false;
    RiceState st[CH];
    const int32_t* dl[CH];
    for (int ch = 0; ch < CH; ++ch) {
      st[ch].params[0] = a_p[ch][0][l];
      st[ch].params[1] = a_p[ch][1][l];
      dl[ch] = d[l * CH + ch];
    }
    venc_finish_lane<CH>(w, st, dl, s, n[l]);
    w.flush();
    if (w.overflow) return -1;
    psize[l] = w.nbytes;
  }
  return 0;
}

}  // extern "C++"
#define SLA_HAVE_VDEC8 1
#endif  // AVX512 vector decode

// ---- dual-stream block decode -------------------------------------------
// The adaptive-Rice get loop is bounded by one serial dependency chain per
// bitstream: cursor -> symbol length -> next cursor, plus the per-channel
// parameter recurrence — single-stream decode leaves most of the core's
// issue width idle. Blocks are independent bitstreams, so decoding two
// blocks with their cursors interleaved in one loop keeps two chains in
// flight per core. Composes with the block-parallel threading (each
// thread pairs within its own range). Per-block bit consumption and
// outputs are identical to the single-stream path.
static bool rice_adaptive(const uint32_t* ip, int32_t C) {
  uint64_t eff_sum = 0;
  for (int32_t ch = 0; ch < C; ++ch)
    eff_sum += param_get(param_set_fixed(ip[ch]));
  return eff_sum / (uint32_t)C > kLowThreshold;
}

static int64_t decode_block_range(const uint8_t* in, int64_t in_size,
                                  const int64_t* bit_offsets, int32_t C,
                                  const int32_t* ns, const uint32_t* init,
                                  int32_t* out, const int64_t* out_offs,
                                  int64_t row_stride, const int32_t* order,
                                  int32_t b0, int32_t b1) {
  // order (nullable): position -> block id. The batched entry sorts
  // positions by descending sample count so the 8 lanes of a vector group
  // carry near-equal lengths (the vector loop runs to the GROUP MINIMUM;
  // unsorted variable-size partitions left most samples on the scalar
  // finish path). Blocks are independent bitstreams with disjoint output
  // rows, so processing order cannot affect any output byte.
  const auto ord = [&](int32_t i) { return order ? order[i] : i; };
  const auto rs = [&](int32_t b) {
    return row_stride ? row_stride : (int64_t)ns[b];
  };
  int32_t b = b0;
  while (b < b1) {
#if defined(SLA_HAVE_VDEC8)
    if (C >= 1 && C <= 8 && b + 8 <= b1) {
      bool all_adaptive = true;
      int32_t blks[8];
      for (int l = 0; l < 8 && all_adaptive; ++l) {
        blks[l] = ord(b + l);
        all_adaptive = rice_adaptive(init + (int64_t)blks[l] * C, C);
      }
      if (all_adaptive) {
        int64_t e = 0;
        switch (C) {
          case 1: e = decode_blocks_v8<1>(in, in_size, bit_offsets, C, ns, init, out, out_offs, row_stride, blks); break;
          case 2: e = decode_blocks_v8<2>(in, in_size, bit_offsets, C, ns, init, out, out_offs, row_stride, blks); break;
          case 3: e = decode_blocks_v8<3>(in, in_size, bit_offsets, C, ns, init, out, out_offs, row_stride, blks); break;
          case 4: e = decode_blocks_v8<4>(in, in_size, bit_offsets, C, ns, init, out, out_offs, row_stride, blks); break;
          case 5: e = decode_blocks_v8<5>(in, in_size, bit_offsets, C, ns, init, out, out_offs, row_stride, blks); break;
          case 6: e = decode_blocks_v8<6>(in, in_size, bit_offsets, C, ns, init, out, out_offs, row_stride, blks); break;
          case 7: e = decode_blocks_v8<7>(in, in_size, bit_offsets, C, ns, init, out, out_offs, row_stride, blks); break;
          case 8: e = decode_blocks_v8<8>(in, in_size, bit_offsets, C, ns, init, out, out_offs, row_stride, blks); break;
        }
        if (e) return e;
        b += 8;
        continue;
      }
    }
#endif
    const int32_t ba = ord(b);
    const int32_t bb = b + 1 < b1 ? ord(b + 1) : -1;
    const bool pairable =
        (C == 1 || C == 2) && b + 1 < b1 &&
        rice_adaptive(init + (int64_t)ba * C, C) &&
        rice_adaptive(init + (int64_t)bb * C, C);
    if (!pairable) {
      int64_t end = get_data_array_rs(in, in_size, bit_offsets[ba], C, ns[ba],
                                      init + (int64_t)ba * C,
                                      out + out_offs[ba], rs(ba));
      if (end < 0) return -1;  // scratch bound (C too large), not an over-read
      if (end > in_size * 8) return -((int64_t)ba + 2);
      ++b;
      continue;
    }
    BitReader ra, rb;
    ra.init(in, in_size, bit_offsets[ba]);
    rb.init(in, in_size, bit_offsets[bb]);
    const int32_t na = ns[ba], nb = ns[bb];
    const int32_t m = na < nb ? na : nb;
    if (C == 2) {
      RiceState sa0, sa1, sb0, sb1;
      sa0.init(init[(int64_t)ba * 2]);
      sa1.init(init[(int64_t)ba * 2 + 1]);
      sb0.init(init[(int64_t)bb * 2]);
      sb1.init(init[(int64_t)bb * 2 + 1]);
      int32_t* oa0 = out + out_offs[ba];
      int32_t* oa1 = oa0 + rs(ba);
      int32_t* ob0 = out + out_offs[bb];
      int32_t* ob1 = ob0 + rs(bb);
      // one refill per stream per sample; A/B alternation keeps maximal
      // distance between dependent ops of the same cursor chain
      int32_t s = 0;
      for (; s < m; ++s) {
        if (ra.next_byte + 8 > ra.size_bytes ||
            rb.next_byte + 8 > rb.size_bytes)
          break;
        ra.refill32();
        rb.refill32();
        uint32_t va0, va1, vb0, vb1;
        if (!try_sym(ra, sa0, &va0)) va0 = get_recursive_rice(ra, sa0);
        if (!try_sym(rb, sb0, &vb0)) vb0 = get_recursive_rice(rb, sb0);
        if (!try_sym(ra, sa1, &va1)) va1 = get_recursive_rice(ra, sa1);
        if (!try_sym(rb, sb1, &vb1)) vb1 = get_recursive_rice(rb, sb1);
        oa0[s] = unzigzag(va0);
        oa1[s] = unzigzag(va1);
        ob0[s] = unzigzag(vb0);
        ob1[s] = unzigzag(vb1);
      }
      for (; s < m; ++s) {  // one stream hit its buffer tail
        oa0[s] = unzigzag(get_sym_auto(ra, sa0));
        ob0[s] = unzigzag(get_sym_auto(rb, sb0));
        oa1[s] = unzigzag(get_sym_auto(ra, sa1));
        ob1[s] = unzigzag(get_sym_auto(rb, sb1));
      }
      for (s = m; s < na; ++s) {
        oa0[s] = unzigzag(get_sym_auto(ra, sa0));
        oa1[s] = unzigzag(get_sym_auto(ra, sa1));
      }
      for (s = m; s < nb; ++s) {
        ob0[s] = unzigzag(get_sym_auto(rb, sb0));
        ob1[s] = unzigzag(get_sym_auto(rb, sb1));
      }
    } else {
      RiceState sa, sb;
      sa.init(init[ba]);
      sb.init(init[bb]);
      int32_t* oa = out + out_offs[ba];
      int32_t* ob = out + out_offs[bb];
      int32_t s = 0;
      for (; s < m; ++s) {
        if (ra.next_byte + 8 > ra.size_bytes ||
            rb.next_byte + 8 > rb.size_bytes)
          break;
        ra.refill32();
        rb.refill32();
        uint32_t va, vb;
        if (!try_sym(ra, sa, &va)) va = get_recursive_rice(ra, sa);
        if (!try_sym(rb, sb, &vb)) vb = get_recursive_rice(rb, sb);
        oa[s] = unzigzag(va);
        ob[s] = unzigzag(vb);
      }
      for (; s < m; ++s) {
        oa[s] = unzigzag(get_sym_auto(ra, sa));
        ob[s] = unzigzag(get_sym_auto(rb, sb));
      }
      for (s = m; s < na; ++s)
        oa[s] = unzigzag(get_sym_auto(ra, sa));
      for (s = m; s < nb; ++s)
        ob[s] = unzigzag(get_sym_auto(rb, sb));
    }
    if (ra.pos() > in_size * 8) return -((int64_t)ba + 2);
    if (rb.pos() > in_size * 8) return -((int64_t)bb + 2);
    b += 2;
  }
  return 0;
}

// Batched payload decode: every COMPRESSDATA block's residual in one call.
// bit_offsets/ns/init are per block; out is the concatenation of the
// (C x ns[b]) row-major blocks at out_offs[b] int32 elements. Returns 0,
// -(b+2) when block b over-reads the buffer (zero-fill past the end, the
// caller surfaces INSUFFICIENT_DATA_SIZE), or -1 on a scratch bound —
// distinct codes for any block count.
int64_t sla_get_data_arrays(const uint8_t* in, int64_t in_size, int32_t W,
                            const int64_t* bit_offsets, int32_t C,
                            const int32_t* ns, const uint32_t* init /* W x C */,
                            int32_t* out, const int64_t* out_offs,
                            int64_t row_stride /* 0: compact (ns[b]) */) {
  if (C <= 0 || C > 64) return -1;
  // Sort positions by descending sample count (stable) so each vector
  // group's 8 lanes carry near-equal lengths; identity order when the
  // blocks are already uniform (the common fixed-block case).
  std::vector<int32_t> order_v;
  const int32_t* order = nullptr;
  {
    bool uniform = true;
    for (int32_t i = 1; i < W && uniform; ++i) uniform = ns[i] == ns[0];
    if (!uniform) {
      order_v.resize((size_t)W);
      for (int32_t i = 0; i < W; ++i) order_v[i] = i;
      std::stable_sort(order_v.begin(), order_v.end(),
                       [&](int32_t a, int32_t b) { return ns[a] > ns[b]; });
      order = order_v.data();
    }
  }
  const int T = entropy_threads();
  if (T > 1 && W >= 2 * T) {
    // block-parallel decode: disjoint output regions, read-only input.
    // Split by cumulative samples (sorted order front-loads the big
    // blocks; equal block COUNTS would leave thread 0 with most work).
    int64_t total = 0;
    for (int32_t i = 0; i < W; ++i) total += ns[i];
    std::atomic<int64_t> err{0};
    std::vector<std::thread> workers;
    int32_t b0 = 0;
    int64_t acc = 0;
    for (int t = 0; t < T; ++t) {
      const int64_t target = total * (t + 1) / T;
      int32_t b1 = b0;
      while (b1 < W && (acc < target || b1 == b0)) acc += ns[order ? order[b1] : b1], ++b1;
      if (t == T - 1) b1 = W;
      if (b1 == b0) continue;
      workers.emplace_back([&, b0, b1]() {
        int64_t e = decode_block_range(in, in_size, bit_offsets, C, ns, init,
                                       out, out_offs, row_stride, order, b0,
                                       b1);
        if (e) err.store(e);
      });
      b0 = b1;
    }
    for (auto& th : workers) th.join();
    return err.load();
  }
  return decode_block_range(in, in_size, bit_offsets, C, ns, init, out,
                            out_offs, row_stride, order, 0, W);
}

// Resumable channel-interleaved payload decode for the streaming decoder:
// decodes `num_samples` interleaved symbols starting at *bit_pos, carrying
// the adaptive parameter state across calls. param_state: C * 2 u64
// fixed-point parameters (initialize with sla_init_param_state).
// use_golomb selects the static-Golomb branch (decided once per block from
// the initial parameters, SLACoder.c:489-505). Returns 0.
int32_t sla_get_data_array_partial(const uint8_t* in, int64_t in_size,
                                   int64_t* bit_pos, int32_t C, int32_t num_samples,
                                   uint64_t* param_state, const uint32_t* eff_params,
                                   int32_t use_golomb, int32_t* out) {
  BitReader r;
  r.init(in, in_size, *bit_pos);
  if (use_golomb) {
    for (int s = 0; s < num_samples; ++s)
      for (int ch = 0; ch < C; ++ch)
        out[(int64_t)ch * num_samples + s] = unzigzag(get_golomb(r, eff_params[ch]));
  } else {
    if (C > 64) return -1;
    // load the adaptive states once per call, not per symbol: the 120 Hz
    // streaming tick decodes hundreds of symbols and the per-symbol
    // memcpy round-trips defeated keeping the parameters in registers
    RiceState st[64];
    for (int ch = 0; ch < C; ++ch)
      std::memcpy(st[ch].params, param_state + ch * kNumRecursiveParams,
                  sizeof(st[ch].params));
    if (C == 2) {  // stereo fast path: one refill per sample (same bit
                   // consumption as per-symbol get_sym_auto), with the
                   // whole loop-carried state — bit cache + 4 adaptive
                   // params — in registers; the reader/state structs are
                   // synced only around the rare escape calls
      int32_t* o0 = out;
      int32_t* o1 = out + num_samples;
      int s = 0;
      uint64_t cache = r.cache;
      int ncache = r.ncache;
      int64_t nxt = r.next_byte;
      const uint8_t* bp = r.buf;
      const int64_t sz = r.size_bytes;
      uint64_t a0 = st[0].params[0], a1 = st[0].params[1];
      uint64_t b0 = st[1].params[0], b1 = st[1].params[1];
      auto writeback = [&]() {
        r.cache = cache; r.ncache = ncache; r.next_byte = nxt;
        st[0].params[0] = a0; st[0].params[1] = a1;
        st[1].params[0] = b0; st[1].params[1] = b1;
      };
      auto reload = [&]() {
        cache = r.cache; ncache = r.ncache; nxt = r.next_byte;
        a0 = st[0].params[0]; a1 = st[0].params[1];
        b0 = st[1].params[0]; b1 = st[1].params[1];
      };
      for (; s < num_samples && nxt + 8 <= sz; ++s) {
        const int nb = (63 - ncache) >> 3;  // refill32, 8-byte margin form
        if (nb > 0) {
          uint64_t v;
          std::memcpy(&v, bp + nxt, 8);
          nxt += nb;
          cache = (cache << (8 * nb)) | (__builtin_bswap64(v) >> (64 - 8 * nb));
          ncache += 8 * nb;
        }
        uint32_t u0, u1;
        if (!try_sym_regs(cache, ncache, a0, a1, &u0)) {
          writeback();
          u0 = get_recursive_rice(r, st[0]);
          reload();
        }
        if (!try_sym_regs(cache, ncache, b0, b1, &u1)) {
          writeback();
          u1 = get_recursive_rice(r, st[1]);
          reload();
        }
        o0[s] = unzigzag(u0);
        o1[s] = unzigzag(u1);
      }
      writeback();
      for (; s < num_samples; ++s) {  // buffer tail: byte-exact slow path
        o0[s] = unzigzag(get_sym_auto(r, st[0]));
        o1[s] = unzigzag(get_sym_auto(r, st[1]));
      }
    } else if (C == 1) {  // mono: same register-resident loop, one channel
      int s = 0;
      uint64_t cache = r.cache;
      int ncache = r.ncache;
      int64_t nxt = r.next_byte;
      const uint8_t* bp = r.buf;
      const int64_t sz = r.size_bytes;
      uint64_t a0 = st[0].params[0], a1 = st[0].params[1];
      auto writeback = [&]() {
        r.cache = cache; r.ncache = ncache; r.next_byte = nxt;
        st[0].params[0] = a0; st[0].params[1] = a1;
      };
      auto reload = [&]() {
        cache = r.cache; ncache = r.ncache; nxt = r.next_byte;
        a0 = st[0].params[0]; a1 = st[0].params[1];
      };
      for (; s < num_samples && nxt + 8 <= sz; ++s) {
        const int nb = (63 - ncache) >> 3;
        if (nb > 0) {
          uint64_t v;
          std::memcpy(&v, bp + nxt, 8);
          nxt += nb;
          cache = (cache << (8 * nb)) | (__builtin_bswap64(v) >> (64 - 8 * nb));
          ncache += 8 * nb;
        }
        uint32_t u;
        if (!try_sym_regs(cache, ncache, a0, a1, &u)) {
          writeback();
          u = get_recursive_rice(r, st[0]);
          reload();
        }
        out[s] = unzigzag(u);
      }
      writeback();
      for (; s < num_samples; ++s)
        out[s] = unzigzag(get_sym_auto(r, st[0]));
    } else {
      // multichannel (3..64ch): cursor in registers, one refill per
      // sample; the adaptive params stay in st[] (runtime channel count),
      // still saving the per-symbol refill/branch of get_sym_auto.
      // kQuotThreshold+1+kb(<=32) bits per symbol can exceed the 56-bit
      // cache for later channels, so try_sym's consumed>ncache guard
      // falls back per symbol exactly like the stereo loop.
      int s = 0;
      uint64_t cache = r.cache;
      int ncache = r.ncache;
      int64_t nxt = r.next_byte;
      const uint8_t* bp = r.buf;
      const int64_t sz = r.size_bytes;
      for (; s < num_samples && nxt + 8 <= sz; ++s) {
        for (int ch = 0; ch < C; ++ch) {
          if (ncache <= 33 && nxt + 8 <= sz) {  // top up before each symbol
            const int nb = (63 - ncache) >> 3;
            uint64_t v;
            std::memcpy(&v, bp + nxt, 8);
            nxt += nb;
            cache = (cache << (8 * nb)) | (__builtin_bswap64(v) >> (64 - 8 * nb));
            ncache += 8 * nb;
          }
          uint32_t u;
          if (!try_sym_regs(cache, ncache, st[ch].params[0], st[ch].params[1],
                            &u)) {
            r.cache = cache; r.ncache = ncache; r.next_byte = nxt;
            u = get_recursive_rice(r, st[ch]);
            cache = r.cache; ncache = r.ncache; nxt = r.next_byte;
          }
          out[(int64_t)ch * num_samples + s] = unzigzag(u);
        }
      }
      r.cache = cache; r.ncache = ncache; r.next_byte = nxt;
      for (; s < num_samples; ++s)
        for (int ch = 0; ch < C; ++ch)
          out[(int64_t)ch * num_samples + s] = unzigzag(get_sym_auto(r, st[ch]));
    }
    for (int ch = 0; ch < C; ++ch)
      std::memcpy(param_state + ch * kNumRecursiveParams, st[ch].params,
                  sizeof(st[ch].params));
  }
  *bit_pos = r.pos();
  return 0;
}

// Initialize the resumable parameter state + effective params + branch flag
// for one block (mirrors the preamble of SLACoder_Get/PutDataArray).
void sla_init_param_state(const uint32_t* init_params, int32_t C,
                          uint64_t* param_state, uint32_t* eff_params,
                          int32_t* use_golomb) {
  if (C <= 0) { *use_golomb = 0; return; }  // no SIGFPE on the division below
  uint64_t eff_sum = 0;
  for (int ch = 0; ch < C; ++ch) {
    eff_params[ch] = param_get(param_set_fixed(init_params[ch]));
    eff_sum += eff_params[ch];
    for (int i = 0; i < kNumRecursiveParams; ++i)
      param_state[ch * kNumRecursiveParams + i] = param_set_fixed(init_params[ch]);
  }
  *use_golomb = (eff_sum / (uint32_t)C > kLowThreshold) ? 0 : 1;
}

// Branch-free bit emission for the device entropy path (rice_device.py):
// concatenate (value, length) parts MSB-first. Zero-length parts are
// skipped. Returns bytes written after the final flush, or -1 on overflow.
int64_t sla_pack_parts(const uint32_t* values, const int32_t* lengths,
                       int64_t count, uint8_t* out, int64_t out_capacity) {
  BitWriter w;
  w.init(out, out_capacity);
  for (int64_t i = 0; i < count; ++i) {
    int32_t len = lengths[i];
    if (len <= 0) continue;
    if (len > 32) {
      // only gamma value parts exceed 32 bits and their MSB is always 1
      w.put(1, len - 32);
      w.put(values[i], 32);
    } else {
      w.put(values[i], len);
    }
  }
  w.flush();
  return w.overflow ? -1 : w.nbytes;
}

// RAWDATA payload encode: zigzagged samples, channel-interleaved, with a
// per-channel bit width (SLAEncoder.c:741-763). Returns bytes written or -1.
int64_t sla_put_raw(const int32_t* data, int32_t C, int32_t N,
                    const int32_t* bits_per_ch, uint8_t* out,
                    int64_t out_capacity) {
  BitWriter w;
  w.init(out, out_capacity);
  for (int s = 0; s < N; ++s)
    for (int ch = 0; ch < C; ++ch)
      w.put(zigzag(data[(int64_t)ch * N + s]), bits_per_ch[ch]);
  w.flush();
  return w.overflow ? -1 : w.nbytes;
}

// RAWDATA payload decode. Returns the bit position after the payload.
int64_t sla_get_raw(const uint8_t* in, int64_t in_size, int64_t bit_offset,
                    int32_t C, int32_t N, const int32_t* bits_per_ch,
                    int32_t* out) {
  BitReader r;
  r.init(in, in_size, bit_offset);
  for (int s = 0; s < N; ++s)
    for (int ch = 0; ch < C; ++ch)
      out[(int64_t)ch * N + s] = unzigzag((uint32_t)r.get(bits_per_ch[ch]));
  return r.pos();
}

// Initial Rice parameter per channel: mean zigzag magnitude, >= 1, as a
// uint32 (SLACoder.c:361-385).
// Batched initial Rice parameters over a (B, stride) row batch with
// per-row valid lengths — the mean of zigzag magnitudes, >= 1
// (SLACoder.c:361-385), one pass, no per-block copies.
void sla_initial_params_rows(const int32_t* base, int64_t stride, int32_t B,
                             const int64_t* lengths, uint32_t* out_params) {
  for (int32_t b = 0; b < B; ++b) {
    const int32_t* row = base + (int64_t)b * stride;
    const int64_t n = lengths[b];
    uint64_t sum = 0;
    for (int64_t s = 0; s < n; ++s) sum += zigzag(row[s]);
    uint64_t mean = sum / (uint64_t)(n > 0 ? n : 1);
    out_params[b] = (uint32_t)(mean < 1 ? 1 : mean);
  }
}

void sla_initial_params(const int32_t* data, int32_t C, int32_t N,
                        uint32_t* out_params) {
  // chunked over the stack scratch so ANY C fills out_params (a silent
  // early return would hand the caller uninitialized Rice parameters)
  for (int32_t c0 = 0; c0 < C; c0 += 64) {
    int64_t lens[64];
    const int32_t nb = (C - c0) < 64 ? (C - c0) : 64;
    for (int32_t ch = 0; ch < nb; ++ch) lens[ch] = N;
    sla_initial_params_rows(data + (int64_t)c0 * N, N, nb, lens,
                            out_params + c0);
  }
}

}  // extern "C"

// ------------------------------------------------------------- real FFT
// Classic Numerical-Recipes radix-2 real FFT (four1/realft, public domain;
// the reference uses the same routines, src/SLAUtility.c:218-319). The
// encoder's pitch decisions depend on the exact float64 rounding of this
// specific butterfly order, so the operation sequence is replicated
// precisely — a different (faster) FFT would change streams.
namespace {

void four1(double* data, unsigned long nn, int isign) {
  // data is 1-indexed (data[1..2*nn]); interleaved re/im
  unsigned long n = nn << 1, j = 1;
  for (unsigned long i = 1; i < n; i += 2) {
    if (j > i) {
      double t;
      t = data[j]; data[j] = data[i]; data[i] = t;
      t = data[j + 1]; data[j + 1] = data[i + 1]; data[i + 1] = t;
    }
    unsigned long m = n >> 1;
    while (m >= 2 && j > m) { j -= m; m >>= 1; }
    j += m;
  }
  unsigned long mmax = 2;
  while (n > mmax) {
    unsigned long istep = mmax << 1;
    double theta = isign * (6.28318530717959 / (double)mmax);
    double wtemp = std::sin(0.5 * theta);
    double wpr = -2.0 * wtemp * wtemp;
    double wpi = std::sin(theta);
    double wr = 1.0, wi = 0.0;
    for (unsigned long m = 1; m < mmax; m += 2) {
      for (unsigned long i = m; i <= n; i += istep) {
        unsigned long jj = i + mmax;
        double tempr = wr * data[jj] - wi * data[jj + 1];
        double tempi = wr * data[jj + 1] + wi * data[jj];
        data[jj] = data[i] - tempr;
        data[jj + 1] = data[i + 1] - tempi;
        data[i] += tempr;
        data[i + 1] += tempi;
      }
      wr = (wtemp = wr) * wpr - wi * wpi + wr;
      wi = wi * wpr + wtemp * wpi + wi;
    }
    mmax = istep;
  }
}

void realft(double* data, unsigned long n, int isign) {
  // data is 1-indexed (data[1..n])
  double c1 = 0.5, c2;
  double theta = 3.141592653589793 / (double)(n >> 1);
  if (isign == 1) {
    c2 = -0.5;
    four1(data, n >> 1, 1);
  } else {
    c2 = 0.5;
    theta = -theta;
  }
  double wtemp = std::sin(0.5 * theta);
  double wpr = -2.0 * wtemp * wtemp;
  double wpi = std::sin(theta);
  double wr = 1.0 + wpr, wi = wpi;
  unsigned long np3 = n + 3;
  for (unsigned long i = 2; i <= (n >> 2); i++) {
    unsigned long i1 = i + i - 1, i2 = 1 + i1, i3 = np3 - i2, i4 = 1 + i3;
    double h1r = c1 * (data[i1] + data[i3]);
    double h1i = c1 * (data[i2] - data[i4]);
    double h2r = -c2 * (data[i2] + data[i4]);
    double h2i = c2 * (data[i1] - data[i3]);
    data[i1] = h1r + wr * h2r - wi * h2i;
    data[i2] = h1i + wr * h2i + wi * h2r;
    data[i3] = h1r - wr * h2r + wi * h2i;
    data[i4] = -h1i + wr * h2i + wi * h2r;
    wr = (wtemp = wr) * wpr - wi * wpi + wr;
    wi = wi * wpr + wtemp * wpi + wi;
  }
  if (isign == 1) {
    double h1r = data[1];
    data[1] = h1r + data[2];
    data[2] = h1r - data[2];
  } else {
    double h1r = data[1];
    data[1] = c1 * (h1r + data[2]);
    data[2] = c1 * (h1r - data[2]);
    four1(data, n >> 1, -1);
  }
}

// Crout LU decomposition with implicit row scaling and partial pivoting
// (semantics of SLALESolver_LUDecomposion, src/SLAUtility.c:487-572).
// A: row-major dim x dim, decomposed in place.
int lu_decompose(double* A, int dim, int* change_index, double* row_scale) {
  constexpr double kFltEps = 1.1920928955078125e-07;  // FLT_EPSILON
  for (int row = 0; row < dim; ++row) {
    double max = 0.0;
    for (int col = 0; col < dim; ++col)
      if (std::fabs(A[row * dim + col]) > max) max = std::fabs(A[row * dim + col]);
    if (std::fabs(max) <= kFltEps) return -1;
    row_scale[row] = 1.0 / max;
  }
  for (int col = 0; col < dim; ++col) {
    for (int row = 0; row < col; ++row) {
      double sum = A[row * dim + col];
      for (int k = 0; k < row; ++k) sum -= A[row * dim + k] * A[k * dim + col];
      A[row * dim + col] = sum;
    }
    double max = 0.0;
    int max_index = col;
    for (int row = col; row < dim; ++row) {
      double sum = A[row * dim + col];
      for (int k = 0; k < col; ++k) sum -= A[row * dim + k] * A[k * dim + col];
      A[row * dim + col] = sum;
      if (row_scale[row] * std::fabs(sum) >= max) {
        max = row_scale[row] * std::fabs(sum);
        max_index = row;
      }
    }
    if (col != max_index) {
      for (int k = 0; k < dim; ++k) {
        double tmp = A[max_index * dim + k];
        A[max_index * dim + k] = A[col * dim + k];
        A[col * dim + k] = tmp;
      }
      row_scale[max_index] = row_scale[col];
    }
    change_index[col] = max_index;
    if (std::fabs(A[col * dim + col]) <= kFltEps) return -1;
    if (col != dim - 1) {
      double denom = 1.0 / A[col * dim + col];
      for (int row = col + 1; row < dim; ++row) A[row * dim + col] *= denom;
    }
  }
  return 0;
}

// Forward/back substitution with the leading-zero skip
// (SLALESolver_LUDecomposionForwardBack, src/SLAUtility.c:575-618).
void lu_forward_back(const double* A, double* b, int dim, const int* change_index) {
  int nonzero_row = 0;
  for (int row = 0; row < dim; ++row) {
    int pivot = change_index[row];
    double sum = b[pivot];
    b[pivot] = b[row];
    if (nonzero_row != 0) {
      for (int col = nonzero_row; col < row; ++col) sum -= A[row * dim + col] * b[col];
    } else if (sum != 0.0) {
      nonzero_row = row;
    }
    b[row] = sum;
  }
  for (int row = dim - 1; row >= 0; --row) {
    double sum = b[row];
    for (int col = row + 1; col < dim; ++col) sum -= A[row * dim + col] * b[col];
    b[row] = sum / A[row * dim + row];
  }
}

// Eight-row variants: identical operation sequence per row (twiddle
// recurrences and butterfly order unchanged), eight rows interleaved in the
// last axis so every scalar op becomes an 8-wide vector op. Layout:
// d[i][r] = d[i * 8 + r], 1-indexed like the scalar versions.
enum { FFTR = 8 };

// Explicit 8-wide double vector: GCC cannot prove the four butterfly
// pointers into one array don't alias, so the scalar formulation compiles
// to scalar AVX ops. Vector extensions make the 8-row lane dimension a
// single zmm op. Elementwise vector mul/add/sub round identically to the
// scalar ops (and -ffp-contract=off forbids FMA contraction either way),
// so each row's float64 result is bit-identical to the scalar four1.
typedef double v8df __attribute__((vector_size(64), aligned(8), may_alias));

static inline v8df v8splat(double x) {
  return (v8df){x, x, x, x, x, x, x, x};
}

// Twiddle factors for every stage, generated by the SAME scalar recurrence
// the reference's four1 steps through (the last-ulp drift of the recurrence
// vs a direct sin/cos evaluation is load-bearing for byte-identity). Built
// once per (n, isign) and cached; shared by every block of a stage and
// every 8-row group.
struct TwiddleTables {
  unsigned long n = 0;
  int isign = 0;
  std::vector<double> wr, wi;   // concatenated per stage
  std::vector<size_t> offs;     // entry offset per stage (log2(mmax) - 1)

  void build(unsigned long n_, int isign_) {
    if (n == n_ && isign == isign_) return;
    n = n_;
    isign = isign_;
    wr.clear(); wi.clear(); offs.clear();
    for (unsigned long mmax = 2; n > mmax; mmax <<= 1) {
      offs.push_back(wr.size());
      double theta = isign * (6.28318530717959 / (double)mmax);
      double wtemp = std::sin(0.5 * theta);
      double wpr = -2.0 * wtemp * wtemp;
      double wpi = std::sin(theta);
      double w_r = 1.0, w_i = 0.0;
      for (unsigned long m = 1; m < mmax; m += 2) {
        wr.push_back(w_r);
        wi.push_back(w_i);
        w_r = (wtemp = w_r) * wpr - w_i * wpi + w_r;
        w_i = w_i * wpr + wtemp * wpi + w_i;
      }
    }
  }
};

static inline int stage_index(unsigned long mmax) {
  return __builtin_ctzl(mmax) - 1;
}

// Iterative stages over one cache-resident block [base+1 .. base+len]
// (1-indexed doubles). Butterfly order within a stage only permutes
// independent butterflies, so results are bit-identical to the flat sweep.
static void fft_v8_base(v8df* data, unsigned long base, unsigned long len,
                        const TwiddleTables& tw) {
  for (unsigned long mmax = 2; len > mmax; mmax <<= 1) {
    unsigned long istep = mmax << 1;
    const double* wrs = tw.wr.data() + tw.offs[stage_index(mmax)];
    const double* wis = tw.wi.data() + tw.offs[stage_index(mmax)];
    for (unsigned long m = 1, t = 0; m < mmax; m += 2, ++t) {
      const v8df wrv = v8splat(wrs[t]), wiv = v8splat(wis[t]);
      for (unsigned long i = base + m; i < base + len; i += istep) {
        unsigned long jj = i + mmax;
        v8df pj = data[jj], pj1 = data[jj + 1];
        v8df tempr = wrv * pj - wiv * pj1;
        v8df tempi = wrv * pj1 + wiv * pj;
        data[jj] = data[i] - tempr;
        data[jj + 1] = data[i + 1] - tempi;
        data[i] = data[i] + tempr;
        data[i + 1] = data[i + 1] + tempi;
      }
    }
  }
}

// Depth-first blocked schedule: transform each half while it is still hot,
// then run the combine stage. Stage-by-stage dependencies are respected, so
// every butterfly consumes exactly the values the flat schedule would —
// identical float64 output, a fraction of the cache traffic (the flat
// sweep walks the full 64B-per-element array once per stage).
static const unsigned long FFT_V8_BASE_LEN = 512;  // 32 KB block, L1-resident

// `need`: how many leading output doubles of this block the caller will
// read. Butterflies whose results fall entirely past `need` are skipped —
// output pruning computes exactly the same values for the kept positions
// (a combine butterfly writes doubles (m, m+1) and (m+mmax, m+mmax+1); the
// front pair needs front outputs of BOTH halves, so the recursion passes
// min(need, half) down). Callers that read everything pass need = len.
// Fused two-stage combine over [base+1 .. base+len]: applies stage
// mmax=len/4 (pairs (A,B) and (C,D) across the four quarters) then stage
// mmax=len/2 (pairs (A,C) and (B,D)) with the intermediate values held in
// registers. Exactly the butterflies the two separate sweeps would run, in
// a valid dependency order (only independent butterflies interleave), so
// the float64 results are bit-identical — at half the memory traffic: one
// read+write of the block instead of two.
static void fft_v8_combine2(v8df* data, unsigned long base, unsigned long len,
                            const TwiddleTables& tw) {
  const unsigned long Q = len >> 2;
  const double* w1r = tw.wr.data() + tw.offs[stage_index(Q)];
  const double* w1i = tw.wi.data() + tw.offs[stage_index(Q)];
  const double* w2r = tw.wr.data() + tw.offs[stage_index(2 * Q)];
  const double* w2i = tw.wi.data() + tw.offs[stage_index(2 * Q)];
  const unsigned long Qh = Q >> 1;  // twiddle index offset for m + Q
  for (unsigned long m = 1, t = 0; m < Q; m += 2, ++t) {
    const v8df w1rv = v8splat(w1r[t]), w1iv = v8splat(w1i[t]);
    const v8df w2rv = v8splat(w2r[t]), w2iv = v8splat(w2i[t]);
    const v8df w3rv = v8splat(w2r[t + Qh]), w3iv = v8splat(w2i[t + Qh]);
    const unsigned long ia = base + m, ib = ia + Q, ic = ib + Q, id = ic + Q;
    v8df ar = data[ia], ai = data[ia + 1];
    v8df br = data[ib], bi = data[ib + 1];
    v8df cr = data[ic], ci = data[ic + 1];
    v8df dr = data[id], di = data[id + 1];
    // stage mmax=Q: butterfly (a,b) and (c,d), shared twiddle
    v8df tr = w1rv * br - w1iv * bi, ti = w1rv * bi + w1iv * br;
    br = ar - tr; bi = ai - ti; ar = ar + tr; ai = ai + ti;
    tr = w1rv * dr - w1iv * di; ti = w1rv * di + w1iv * dr;
    dr = cr - tr; di = ci - ti; cr = cr + tr; ci = ci + ti;
    // stage mmax=2Q: butterfly (a,c) at offset m, (b,d) at offset m+Q
    tr = w2rv * cr - w2iv * ci; ti = w2rv * ci + w2iv * cr;
    cr = ar - tr; ci = ai - ti; ar = ar + tr; ai = ai + ti;
    tr = w3rv * dr - w3iv * di; ti = w3rv * di + w3iv * dr;
    dr = br - tr; di = bi - ti; br = br + tr; bi = bi + ti;
    data[ia] = ar; data[ia + 1] = ai;
    data[ib] = br; data[ib + 1] = bi;
    data[ic] = cr; data[ic + 1] = ci;
    data[id] = dr; data[id + 1] = di;
  }
}

// Fused three-stage combine (radix-8 schedule): stages mmax = len/8,
// len/4, len/2 applied to the eight eighths with intermediates in
// registers. Same butterflies, valid dependency order, one pass of
// traffic instead of three.
static void fft_v8_combine3(v8df* data, unsigned long base, unsigned long len,
                            const TwiddleTables& tw) {
  const unsigned long E = len >> 3;
  const double* w1r = tw.wr.data() + tw.offs[stage_index(E)];
  const double* w1i = tw.wi.data() + tw.offs[stage_index(E)];
  const double* w2r = tw.wr.data() + tw.offs[stage_index(2 * E)];
  const double* w2i = tw.wi.data() + tw.offs[stage_index(2 * E)];
  const double* w4r = tw.wr.data() + tw.offs[stage_index(4 * E)];
  const double* w4i = tw.wi.data() + tw.offs[stage_index(4 * E)];
  const unsigned long Eh = E >> 1;
  v8df re[8], im[8];
  for (unsigned long m = 1, t = 0; m < E; m += 2, ++t) {
    for (int e = 0; e < 8; ++e) {
      re[e] = data[base + m + (unsigned long)e * E];
      im[e] = data[base + m + (unsigned long)e * E + 1];
    }
    // stage mmax=E: (0,1) (2,3) (4,5) (6,7), twiddle offset m
    {
      const v8df wr = v8splat(w1r[t]), wi = v8splat(w1i[t]);
      for (int e = 0; e < 8; e += 2) {
        v8df tr = wr * re[e + 1] - wi * im[e + 1];
        v8df ti = wr * im[e + 1] + wi * re[e + 1];
        re[e + 1] = re[e] - tr; im[e + 1] = im[e] - ti;
        re[e] = re[e] + tr; im[e] = im[e] + ti;
      }
    }
    // stage mmax=2E: (0,2) (4,6) at offset m; (1,3) (5,7) at offset m+E
    {
      const v8df war = v8splat(w2r[t]), wai = v8splat(w2i[t]);
      const v8df wbr = v8splat(w2r[t + Eh]), wbi = v8splat(w2i[t + Eh]);
      for (int e = 0; e < 8; e += 4) {
        v8df tr = war * re[e + 2] - wai * im[e + 2];
        v8df ti = war * im[e + 2] + wai * re[e + 2];
        re[e + 2] = re[e] - tr; im[e + 2] = im[e] - ti;
        re[e] = re[e] + tr; im[e] = im[e] + ti;
        tr = wbr * re[e + 3] - wbi * im[e + 3];
        ti = wbr * im[e + 3] + wbi * re[e + 3];
        re[e + 3] = re[e + 1] - tr; im[e + 3] = im[e + 1] - ti;
        re[e + 1] = re[e + 1] + tr; im[e + 1] = im[e + 1] + ti;
      }
    }
    // stage mmax=4E: (e, e+4) at offsets m + e*E, twiddles t + e*Eh
    for (int e = 0; e < 4; ++e) {
      const v8df wr = v8splat(w4r[t + (unsigned long)e * Eh]);
      const v8df wi = v8splat(w4i[t + (unsigned long)e * Eh]);
      v8df tr = wr * re[e + 4] - wi * im[e + 4];
      v8df ti = wr * im[e + 4] + wi * re[e + 4];
      re[e + 4] = re[e] - tr; im[e + 4] = im[e] - ti;
      re[e] = re[e] + tr; im[e] = im[e] + ti;
    }
    for (int e = 0; e < 8; ++e) {
      data[base + m + (unsigned long)e * E] = re[e];
      data[base + m + (unsigned long)e * E + 1] = im[e];
    }
  }
}

static void fft_v8_rec(v8df* data, unsigned long base, unsigned long len,
                       unsigned long need, const TwiddleTables& tw) {
  if (len <= FFT_V8_BASE_LEN) {
    fft_v8_base(data, base, len, tw);
    return;
  }
  if (need >= len && len >= (FFT_V8_BASE_LEN << 3)) {
    // unpruned path: recurse to eighths, then one fused triple-stage
    // combine sweep (a third of the combine traffic)
    const unsigned long e = len >> 3;
    for (int k = 0; k < 8; ++k) fft_v8_rec(data, base + k * e, e, e, tw);
    fft_v8_combine3(data, base, len, tw);
    return;
  }
  if (need >= len && len >= (FFT_V8_BASE_LEN << 2)) {
    // unpruned path: recurse to quarters, then one fused double-stage
    // combine sweep (half the combine traffic of two single sweeps)
    const unsigned long q = len >> 2;
    fft_v8_rec(data, base, q, q, tw);
    fft_v8_rec(data, base + q, q, q, tw);
    fft_v8_rec(data, base + 2 * q, q, q, tw);
    fft_v8_rec(data, base + 3 * q, q, q, tw);
    fft_v8_combine2(data, base, len, tw);
    return;
  }
  unsigned long half = len >> 1;
  unsigned long sub_need = need < half ? need : half;
  fft_v8_rec(data, base, half, sub_need, tw);
  fft_v8_rec(data, base + half, half, sub_need, tw);
  unsigned long mmax = half;  // the combine stage for this block size
  const double* wrs = tw.wr.data() + tw.offs[stage_index(mmax)];
  const double* wis = tw.wi.data() + tw.offs[stage_index(mmax)];
  unsigned long mlim = need < mmax ? need : mmax;  // m odd, writes m and m+1
  for (unsigned long m = 1, t = 0; m < mlim; m += 2, ++t) {
    const v8df wrv = v8splat(wrs[t]), wiv = v8splat(wis[t]);
    unsigned long i = base + m, jj = i + mmax;
    v8df pj = data[jj], pj1 = data[jj + 1];
    v8df tempr = wrv * pj - wiv * pj1;
    v8df tempi = wrv * pj1 + wiv * pj;
    data[jj] = data[i] - tempr;
    data[jj + 1] = data[i + 1] - tempi;
    data[i] = data[i] + tempr;
    data[i + 1] = data[i + 1] + tempi;
  }
}

// Butterfly stages only — callers must already have the data in
// bit-reversed order (either via four1_v8's swap pass or a scatter fill).
static void four1_v8_core(v8df* data, unsigned long n, int isign,
                          unsigned long need_doubles) {
  static thread_local TwiddleTables tw_fwd, tw_inv;
  TwiddleTables& tw = (isign == 1) ? tw_fwd : tw_inv;
  tw.build(n, isign);
  unsigned long need = (need_doubles == 0 || need_doubles > n) ? n : need_doubles;
  fft_v8_rec(data, 0, n, need, tw);
}

void four1_v8(double* data_s, unsigned long nn, int isign,
              unsigned long need_doubles = 0) {
  v8df* data = (v8df*)data_s;  // element i == data_s[i*FFTR .. i*FFTR+7]
  unsigned long n = nn << 1, j = 1;
  for (unsigned long i = 1; i < n; i += 2) {
    if (j > i) {
      v8df t;
      t = data[j]; data[j] = data[i]; data[i] = t;
      t = data[j + 1]; data[j + 1] = data[i + 1]; data[i + 1] = t;
    }
    unsigned long m = n >> 1;
    while (m >= 2 && j > m) { j -= m; m >>= 1; }
    j += m;
  }
  four1_v8_core(data, n, isign, need_doubles);
}

void realft_v8(double* data_s, unsigned long n, int isign,
               unsigned long need_doubles = 0) {
  v8df* data = (v8df*)data_s;
  double c1 = 0.5, c2;
  double theta = 3.141592653589793 / (double)(n >> 1);
  if (isign == 1) {
    c2 = -0.5;
    four1_v8(data_s, n >> 1, 1);
  } else {
    c2 = 0.5;
    theta = -theta;
  }
  double wtemp = std::sin(0.5 * theta);
  double wpr = -2.0 * wtemp * wtemp;
  double wpi = std::sin(theta);
  double wr = 1.0 + wpr, wi = wpi;
  unsigned long np3 = n + 3;
  const v8df c1v = v8splat(c1), c2v = v8splat(-c2), c2pv = v8splat(c2);
  for (unsigned long i = 2; i <= (n >> 2); i++) {
    unsigned long i1 = i + i - 1, i2 = 1 + i1, i3 = np3 - i2, i4 = 1 + i3;
    const v8df wrv = v8splat(wr), wiv = v8splat(wi);
    v8df p1 = data[i1], p2 = data[i2], p3 = data[i3], p4 = data[i4];
    v8df h1r = c1v * (p1 + p3);
    v8df h1i = c1v * (p2 - p4);
    v8df h2r = c2v * (p2 + p4);
    v8df h2i = c2pv * (p1 - p3);
    data[i1] = h1r + wrv * h2r - wiv * h2i;
    data[i2] = h1i + wrv * h2i + wiv * h2r;
    data[i3] = h1r - wrv * h2r + wiv * h2i;
    data[i4] = -h1i + wrv * h2i + wiv * h2r;
    wr = (wtemp = wr) * wpr - wi * wpi + wr;
    wi = wi * wpr + wtemp * wpi + wi;
  }
  if (isign == 1) {
    v8df h1r = data[1];
    data[1] = h1r + data[2];
    data[2] = h1r - data[2];
  } else {
    v8df h1r = data[1];
    data[1] = c1v * (h1r + data[2]);
    data[2] = c1v * (h1r - data[2]);
    four1_v8(data_s, n >> 1, -1, need_doubles);
  }
}

// four1's complex bit-reversal permutation, cached per size
struct BitrevTable {
  uint32_t nn = 0;
  std::vector<uint32_t> rev;
  void build(uint32_t nn_) {
    if (nn == nn_) return;
    nn = nn_;
    rev.assign(nn, 0);
    const int bits = __builtin_ctz(nn);
    for (uint32_t c = 0; c < nn; ++c) {
      uint32_t r = 0, x = c;
      for (int b = 0; b < bits; ++b) { r = (r << 1) | (x & 1u); x >>= 1; }
      rev[c] = r;
    }
  }
};
thread_local BitrevTable g_revtab;

// Scatter form of realft_power_fused_v8: identical per-quad arithmetic,
// but each result complex element lands in `outv` (0-indexed v8df pairs)
// at its FOUR1 BIT-REVERSED position, so the inverse transform needs no
// swap pass at all — its base stages read `outv` contiguously. `rev` is
// the n/2-element complex bit-reversal table.
static void realft_power_scatter_v8(const double* data_s, v8df* outv,
                                    const uint32_t* rev, unsigned long n) {
  const v8df* data = (const v8df*)data_s;  // 1-indexed like realft
  const double c1 = 0.5;
  double thetaF = 3.141592653589793 / (double)(n >> 1);
  double wtempF = std::sin(0.5 * thetaF);
  double wprF = -2.0 * wtempF * wtempF;
  double wpiF = std::sin(thetaF);
  double wrF = 1.0 + wprF, wiF = wpiF;
  double thetaI = -thetaF;
  double wtempI = std::sin(0.5 * thetaI);
  double wprI = -2.0 * wtempI * wtempI;
  double wpiI = std::sin(thetaI);
  double wrI = 1.0 + wprI, wiI = wpiI;
  const unsigned long np3 = n + 3;
  const v8df c1v = v8splat(c1);
  const v8df c2vF = v8splat(0.5), c2pvF = v8splat(-0.5);
  const v8df c2vI = v8splat(-0.5), c2pvI = v8splat(0.5);
  const v8df zero = v8splat(0.0);
  for (unsigned long i = 2; i <= (n >> 2); i++) {
    const unsigned long i1 = i + i - 1, i2 = 1 + i1, i3 = np3 - i2, i4 = 1 + i3;
    v8df q1, q2, q3, q4;
    {  // forward recombination
      const v8df wrv = v8splat(wrF), wiv = v8splat(wiF);
      v8df p1 = data[i1], p2 = data[i2], p3 = data[i3], p4 = data[i4];
      v8df h1r = c1v * (p1 + p3);
      v8df h1i = c1v * (p2 - p4);
      v8df h2r = c2vF * (p2 + p4);
      v8df h2i = c2pvF * (p1 - p3);
      q1 = h1r + wrv * h2r - wiv * h2i;
      q2 = h1i + wrv * h2i + wiv * h2r;
      q3 = h1r - wrv * h2r + wiv * h2i;
      q4 = -h1i + wrv * h2i + wiv * h2r;
      wrF = (wtempF = wrF) * wprF - wiF * wpiF + wrF;
      wiF = wiF * wprF + wtempF * wpiF + wiF;
    }
    q1 = q1 * q1 + q2 * q2;  // power spectrum, imaginaries +0.0
    q3 = q3 * q3 + q4 * q4;
    {  // inverse pre-recombination, scattered to bit-reversed positions
      const v8df wrv = v8splat(wrI), wiv = v8splat(wiI);
      const v8df p2 = zero, p4 = zero;
      v8df h1r = c1v * (q1 + q3);
      v8df h1i = c1v * (p2 - p4);
      v8df h2r = c2vI * (p2 + p4);
      v8df h2i = c2pvI * (q1 - q3);
      const unsigned long pf = rev[i - 1];               // front bin i-1
      const unsigned long pb = rev[(n >> 1) - i + 1];    // back bin n/2-i+1
      outv[2 * pf] = h1r + wrv * h2r - wiv * h2i;
      outv[2 * pf + 1] = h1i + wrv * h2i + wiv * h2r;
      outv[2 * pb] = h1r - wrv * h2r + wiv * h2i;
      outv[2 * pb + 1] = -h1i + wrv * h2i + wiv * h2r;
      wrI = (wtempI = wrI) * wprI - wiI * wpiI + wrI;
      wiI = wiI * wprI + wtempI * wpiI + wiI;
    }
  }
  // specials: DC/Nyquist (bin 0, rev[0] == 0) and the self-conjugate
  // middle bin n/4
  v8df h1r = data[1];
  v8df dc = h1r + data[2];
  v8df ny = h1r - data[2];
  dc = dc * dc;
  ny = ny * ny;
  outv[0] = c1v * (dc + ny);
  outv[1] = c1v * (dc - ny);
  {
    const unsigned long mid = (n >> 1) + 1;
    v8df re = data[mid], im = data[mid + 1];
    const unsigned long pm = rev[n >> 2];
    outv[2 * pm] = re * re + im * im;
    outv[2 * pm + 1] = zero;
  }
}

#if defined(__AVX512F__)
// Scatter-fill for the 8-row FFT: convert int32 samples to scaled float64
// lanes (cvt then *2^-31 — the scalar fill's exact arithmetic) and write
// each complex element directly at its bit-reversed position, replacing
// the sequential fill + four1 swap pass (one 2 MB pass instead of two-plus,
// identical buffer contents including +0.0 padding). Rows transpose in
// registers (lane-filling with scalar inserts stalls on store forwarding).
static void fill_bitrev_rows8(const int32_t* data, const int32_t* lengths,
                              int32_t row_stride, double* work,
                              int32_t fft_size) {
  const uint32_t nn = (uint32_t)fft_size >> 1;  // complex elements
  g_revtab.build(nn);
  const uint32_t* rev = g_revtab.rev.data();
  const __m512d scale = _mm512_set1_pd(0x1p-31);
  const __m512d zerod = _mm512_setzero_pd();
  v8df* wv = (v8df*)work;
  int32_t maxlen = 0;
  for (int r = 0; r < FFTR; ++r) maxlen = std::max(maxlen, lengths[r]);
  uint32_t g = 0;
  const uint32_t ngroups = nn / 8;  // nn is a power of two
  for (; g < ngroups; ++g) {  // 8 complex = 16 samples per chunk
    const int32_t s0 = (int32_t)(16 * g);
    if (s0 >= maxlen) break;  // the rest of the padded buffer is zeros
    const uint32_t c0 = 8 * g;
    __m512d T0[8], T1[8];
    bool full = true;
    for (int r = 0; r < FFTR; ++r) full &= (s0 + 16 <= lengths[r]);
    if (full) {
      for (int r = 0; r < FFTR; ++r) {
        __m512i v = _mm512_loadu_si512(
            (const void*)(data + (int64_t)r * row_stride + s0));
        T0[r] = _mm512_mul_pd(
            _mm512_cvtepi32_pd(_mm512_castsi512_si256(v)), scale);
        T1[r] = _mm512_mul_pd(
            _mm512_cvtepi32_pd(_mm512_extracti64x4_epi64(v, 1)), scale);
      }
      transpose8d(T0);
      transpose8d(T1);
    } else {
      // chunk straddles a row end: scalar per-lane pad (at most one
      // chunk per distinct row length)
      alignas(64) double buf[16][FFTR];
      for (int r = 0; r < FFTR; ++r) {
        const int32_t nr = lengths[r];
        const int32_t* src = data + (int64_t)r * row_stride;
        for (int d = 0; d < 16; ++d) {
          const int32_t s = s0 + d;
          buf[d][r] = (s < nr) ? (double)src[s] * 0x1p-31 : 0.0;
        }
      }
      for (int d = 0; d < 8; ++d) T0[d] = _mm512_load_pd(buf[d]);
      for (int d = 0; d < 8; ++d) T1[d] = _mm512_load_pd(buf[8 + d]);
    }
    for (int k = 0; k < 4; ++k) {
      const uint32_t p = rev[c0 + k], q = rev[c0 + 4 + k];
      wv[2 * p] = (v8df)T0[2 * k];
      wv[2 * p + 1] = (v8df)T0[2 * k + 1];
      wv[2 * q] = (v8df)T1[2 * k];
      wv[2 * q + 1] = (v8df)T1[2 * k + 1];
    }
  }
  for (; g < ngroups; ++g) {  // zero padding, scattered like the data
    const uint32_t c0 = 8 * g;
    for (int k = 0; k < 8; ++k) {
      const uint32_t p = rev[c0 + k];
      wv[2 * p] = (v8df)zerod;
      wv[2 * p + 1] = (v8df)zerod;
    }
  }
  for (uint32_t c = ngroups * 8; c < nn; ++c) {  // nn < 8: scalar fallback
    const uint32_t p = rev[c];
    for (int r = 0; r < FFTR; ++r) {
      const int32_t nr = lengths[r];
      const int32_t* src = data + (int64_t)r * row_stride;
      const int32_t sa = 2 * (int32_t)c, sb = sa + 1;
      wv[2 * p][r] = (sa < nr) ? (double)src[sa] * 0x1p-31 : 0.0;
      wv[2 * p + 1][r] = (sb < nr) ? (double)src[sb] * 0x1p-31 : 0.0;
    }
  }
}
#endif  // __AVX512F__

}  // namespace

extern "C" {

// In-place real FFT with the reference's index convention
// (SLAUtility_FFT, src/SLAUtility.c:315-319): data[0..n-1], sign +1/-1.
void sla_fft(double* data, uint32_t n, int32_t sign) {
  realft(data - 1, n, (int)sign);
}

// Long-term autocorrelation for eight rows at once: exact per-row
// arithmetic of sla_longterm_autocorr, rows interleaved through the
// vectorized FFT. data: 8 x max_n row-major int32; lengths: per-row sample
// counts; out: 8 x out_lags row-major.
void sla_longterm_autocorr_rows8(const int32_t* data, const int32_t* lengths,
                                 int32_t row_stride, double* work /* fft*8 */,
                                 int32_t fft_size, double* out,
                                 int32_t out_lags) {
  if (fft_size < 8) {  // tiny transforms: the plain in-place sequence
    const double scale = std::ldexp(1.0, -31);
    for (int i = 0; i < fft_size; ++i)
      for (int r = 0; r < FFTR; ++r)
        work[i * FFTR + r] =
            (i < lengths[r]) ? (double)data[(int64_t)r * row_stride + i] * scale : 0.0;
    realft_v8(work - FFTR, (unsigned long)fft_size, 1);
    v8df* w = (v8df*)work;
    w[0] *= w[0];
    w[1] *= w[1];
    const v8df zero = v8splat(0.0);
    for (int i = 1; i < fft_size / 2; ++i) {
      v8df re = w[2 * i], im = w[2 * i + 1];
      w[2 * i] = re * re + im * im;
      w[2 * i + 1] = zero;
    }
    realft_v8(work - FFTR, (unsigned long)fft_size, -1,
              ((unsigned long)out_lags + 1) & ~1ul);
    for (int i = 0; i < out_lags; ++i)
      for (int r = 0; r < FFTR; ++r)
        out[(int64_t)r * out_lags + i] = work[i * FFTR + r];
    return;
  }
#if defined(__AVX512F__)
  // scatter-fill straight into bit-reversed order, then butterflies only
  // (saves the sequential fill + swap passes; identical buffer contents)
  fill_bitrev_rows8(data, lengths, row_stride, work, fft_size);
  four1_v8_core((v8df*)work - 1, (unsigned long)fft_size, 1, 0);
#else
  const double scale = std::ldexp(1.0, -31);
  for (int i = 0; i < fft_size; ++i)
    for (int r = 0; r < FFTR; ++r)
      work[i * FFTR + r] =
          (i < lengths[r]) ? (double)data[(int64_t)r * row_stride + i] * scale : 0.0;
  four1_v8(work - FFTR, (unsigned long)fft_size >> 1, 1);
#endif
  // fused sweep: forward realft recombination + power spectrum + inverse
  // realft pre-recombination, scattered straight into the inverse
  // transform's bit-reversed input order in a second buffer — one pass,
  // and the inverse transform needs no swap pass at all
  g_revtab.build((uint32_t)fft_size >> 1);
  static thread_local std::vector<double> buf2_store;
  if (buf2_store.size() < (size_t)fft_size * FFTR + 8)
    buf2_store.resize((size_t)fft_size * FFTR + 8);
  double* b2 = buf2_store.data();
  b2 += (8 - (((uintptr_t)b2 & 63) >> 3)) & 7;  // 64B align
  v8df* b2v = (v8df*)b2;
  realft_power_scatter_v8(work - FFTR, b2v, g_revtab.rev.data(),
                          (unsigned long)fft_size);
  // only the first out_lags autocorrelation values are read: prune the
  // inverse transform's unread outputs (identical arithmetic for the rest)
  four1_v8_core(b2v - 1, (unsigned long)fft_size, -1,
                ((unsigned long)out_lags + 1) & ~1ul);
  for (int i = 0; i < out_lags; ++i)
    for (int r = 0; r < FFTR; ++r) out[(int64_t)r * out_lags + i] = b2[i * FFTR + r];
}

// Linear solve with iterative refinement (SLALESolver_Solve semantics,
// src/SLAUtility.c:621-674): A row-major dim x dim (unmodified), b in/out.
// Residuals accumulate in long double. Returns 0 ok, -1 singular.
int32_t sla_lesolve(const double* A, double* b, int32_t dim,
                    int32_t iteration_count) {
  double A_lu[64 * 64];
  double x_vec[64], err_vec[64], row_scale[64];
  int change_index[64];
  if (dim > 64) return -1;
  std::memcpy(A_lu, A, sizeof(double) * dim * dim);
  std::memcpy(x_vec, b, sizeof(double) * dim);
  if (lu_decompose(A_lu, dim, change_index, row_scale) != 0) return -1;
  lu_forward_back(A_lu, x_vec, dim, change_index);
  for (int count = 0; count < iteration_count; ++count) {
    for (int row = 0; row < dim; ++row) {
      long double error = -b[row];
      for (int col = 0; col < dim; ++col)
        // product rounds to DOUBLE first (the reference multiplies two
        // doubles, then accumulates in long double — SLAUtility.c:654-656)
        error += (long double)(A[row * dim + col] * x_vec[col]);
      err_vec[row] = (double)error;
    }
    lu_forward_back(A_lu, err_vec, dim, change_index);
    for (int row = 0; row < dim; ++row) x_vec[row] -= err_vec[row];
  }
  std::memcpy(b, x_vec, sizeof(double) * dim);
  return 0;
}

// Incremental single-channel synthesis chain for the streaming decoder:
// LMS synth -> long-term synth -> PARCOR lattice synth -> de-emphasis
// (decode order, SLADecoder.c:494-537), processing `n` samples while
// mutating caller-owned filter state so decode can resume mid-block.
//
// State layout (all int32 unless noted), matching the JAX kernel states
// (sla_tpu/kernels/*.py) exactly:
//   lms:      fc[M] | ic[M] | xb[M] | pb[M]   (+ scalar processed count)
//   longterm: hist[LT_HIST] ring, newest at the end (+ processed count)
//   lattice:  backward[p+1]
//   deemph:   prev (1 int32)
// All int32 arithmetic wraps (build uses -fwrapv); shifts are arithmetic.
static inline int32_t qmul15(int32_t c, int32_t v) {
  return (int32_t)((c * v + (1 << 14)) >> 15);
}

}  // extern "C" (reopened after the static impl below)

// ---- tap-vectorized resumable synthesis (AVX-512) --------------------------
//
// The scalar cascade below is bound by its per-sample dependency chain:
// the lattice alone chains p dependent imuls (~3 cycles each), so one
// channel-sample costs ~230 cycles. Re-expressing the lattice in the
// suffix-sum form the batch kernels already use (lattice_synth_coreT)
// puts the p taps in the LANES of one vector: the f-dependent multiply
// happens ONCE on the whole fpart vector, and the suffix sum runs in
// log2(p) shifted adds. All regrouped additions are wrapping int32
// (-fwrapv) — associative and commutative — and every multiply sees
// identical operands, so the output is bit-identical to the scalar loop
// for EVERY input, valid or corrupt (same argument as synth_rowsT).
// Debug builds keep the scalar path (it carries the SLA_DBG_ASSERTs).
#if defined(__AVX512F__) && defined(__AVX512VL__)
namespace tapvec {

// inclusive suffix sum over 16 int32 lanes: s[k] = sum_{j>=k} s[j]
static inline __attribute__((always_inline)) __m512i suffix_scan16(__m512i s) {
  const __m512i z = _mm512_setzero_si512();
  s = _mm512_add_epi32(s, _mm512_alignr_epi32(z, s, 1));
  s = _mm512_add_epi32(s, _mm512_alignr_epi32(z, s, 2));
  s = _mm512_add_epi32(s, _mm512_alignr_epi32(z, s, 4));
  s = _mm512_add_epi32(s, _mm512_alignr_epi32(z, s, 8));
  return s;
}

static inline __attribute__((always_inline)) __m512i q15v(__m512i c, __m512i v) {
  const __m512i half = _mm512_set1_epi32(1 << 14);
  return _mm512_srai_epi32(
      _mm512_add_epi32(_mm512_mullo_epi32(c, v), half), 15);
}

// PARCOR lattice synthesis, p taps in vector lanes. NZ = 1 covers p <= 16,
// NZ = 2 covers p <= 32. Coefficient lanes >= p are zero, which makes
// their m lanes exactly 0 ((0*x + 2^14) >> 15 == 0), so padding never
// leaks into the suffix sums.
template <int NZ>
struct LatticeVec {
  __m512i vc[NZ], vlat[NZ], vt[NZ];
  int32_t p;
  bool stepped;
  void load(const int32_t* coef, const int32_t* state, int32_t p_) {
    p = p_;
    stepped = false;
    alignas(64) int32_t tmp[NZ * 16];
    for (int32_t i = 0; i < NZ * 16; ++i) tmp[i] = i < p ? coef[i] : 0;
    for (int z = 0; z < NZ; ++z)
      vc[z] = _mm512_load_si512((const void*)(tmp + 16 * z));
    // state has p+1 live entries: lane p must survive a zero-sample chunk
    // (the resumable API allows them), so it loads too when it fits; the
    // p == NZ*16 overflow lane is handled at store via `stepped`
    for (int32_t i = 0; i < NZ * 16; ++i) tmp[i] = i <= p ? state[i] : 0;
    for (int z = 0; z < NZ; ++z)
      vlat[z] = _mm512_load_si512((const void*)(tmp + 16 * z));
  }
  inline __attribute__((always_inline)) int32_t step(int32_t y) {
    if constexpr (NZ == 1) {
      const __m512i m = q15v(vc[0], vlat[0]);
      const __m512i fp =
          _mm512_add_epi32(suffix_scan16(m), _mm512_set1_epi32(y));
      vt[0] = _mm512_sub_epi32(vlat[0], q15v(vc[0], fp));
      const int32_t f = _mm_cvtsi128_si32(_mm512_castsi512_si128(fp));
      vlat[0] = _mm512_alignr_epi32(vt[0], _mm512_set1_epi32(f), 15);
      return f;
    }
    const __m512i m0 = q15v(vc[0], vlat[0]);
    const __m512i m1 = q15v(vc[1], vlat[1]);
    const __m512i s1 = suffix_scan16(m1);
    const __m512i vy = _mm512_set1_epi32(y);
    // fp0 needs the FULL tail sum: all of m1 plus this zmm's own suffix
    const __m512i tot1 = _mm512_broadcastd_epi32(_mm512_castsi512_si128(s1));
    const __m512i fp0 = _mm512_add_epi32(
        _mm512_add_epi32(suffix_scan16(m0), tot1), vy);
    const __m512i fp1 = _mm512_add_epi32(s1, vy);
    vt[0] = _mm512_sub_epi32(vlat[0], q15v(vc[0], fp0));
    vt[1] = _mm512_sub_epi32(vlat[1], q15v(vc[1], fp1));
    const int32_t f = _mm_cvtsi128_si32(_mm512_castsi512_si128(fp0));
    vlat[0] = _mm512_alignr_epi32(vt[0], _mm512_set1_epi32(f), 15);
    vlat[1] = _mm512_alignr_epi32(vt[1], vt[0], 15);
    return f;
  }
  void store(int32_t* state) const {
    alignas(64) int32_t tmp[NZ * 16 + 16];
    for (int z = 0; z < NZ; ++z)
      _mm512_store_si512((void*)(tmp + 16 * z), vlat[z]);
    // lane p (== state[p]) only exists in the shifted-out tail when
    // p == 16*NZ: take it from the last step's t vector
    if (p == NZ * 16 && stepped) {
      alignas(64) int32_t tt[16];
      _mm512_store_si512((void*)tt, vt[NZ - 1]);
      tmp[p] = tt[15];
    } else if (p == NZ * 16) {
      return;  // no samples processed: state unchanged
    }
    for (int32_t i = 0; i <= p; ++i) state[i] = tmp[i];
  }
};

// Sign-sign LMS synthesis, M taps in vector lanes (M = 8 -> ymm, 4 -> xmm).
// The x/pred history windows live IN REGISTERS, newest-first (the external
// state layout), refreshed by a one-lane valignd shift-insert per sample —
// a memory ring would make the next sample's vector load overlap this
// sample's scalar store, a guaranteed store-forwarding stall (~20 cycles,
// measured: the ring variant ran barely faster than the scalar cascade).
template <int MV>
struct LmsVec {
  typedef typename std::conditional<MV == 8, __m256i, __m128i>::type vreg;
  vreg fc, ic, xb, pb;
  int32_t proc;
  static inline vreg vload(const int32_t* x) {
    if constexpr (MV == 8) return (vreg)_mm256_loadu_si256((const __m256i*)x);
    else return (vreg)_mm_loadu_si128((const __m128i*)x);
  }
  static inline void vstore(int32_t* x, vreg v) {
    if constexpr (MV == 8) _mm256_storeu_si256((__m256i*)x, (__m256i)v);
    else _mm_storeu_si128((__m128i*)x, (__m128i)v);
  }
  static inline vreg vadd(vreg a, vreg b) {
    if constexpr (MV == 8) return (vreg)_mm256_add_epi32((__m256i)a, (__m256i)b);
    else return (vreg)_mm_add_epi32((__m128i)a, (__m128i)b);
  }
  static inline vreg vmul(vreg a, vreg b) {
    if constexpr (MV == 8) return (vreg)_mm256_mullo_epi32((__m256i)a, (__m256i)b);
    else return (vreg)_mm_mullo_epi32((__m128i)a, (__m128i)b);
  }
  static inline vreg vsign(vreg a, vreg b) {  // a * sign(b), 0 when b == 0
    if constexpr (MV == 8) return (vreg)_mm256_sign_epi32((__m256i)a, (__m256i)b);
    else return (vreg)_mm_sign_epi32((__m128i)a, (__m128i)b);
  }
  static inline vreg vset1(int32_t v) {
    if constexpr (MV == 8) return (vreg)_mm256_set1_epi32(v);
    else return (vreg)_mm_set1_epi32(v);
  }
  static inline int32_t hsum(vreg v) {  // wrapping adds: order-free
    __m128i lo;
    if constexpr (MV == 8) {
      const __m256i w = (__m256i)v;
      lo = _mm_add_epi32(_mm256_castsi256_si128(w),
                         _mm256_extracti128_si256(w, 1));
    } else {
      lo = (__m128i)v;
    }
    lo = _mm_add_epi32(lo, _mm_shuffle_epi32(lo, 0x4e));
    lo = _mm_add_epi32(lo, _mm_shuffle_epi32(lo, 0xb1));
    return _mm_cvtsi128_si32(lo);
  }
  static inline vreg shift_insert(vreg w, int32_t v) {  // newest into lane 0
    if constexpr (MV == 8)
      return (vreg)_mm256_alignr_epi32((__m256i)w, _mm256_set1_epi32(v), 7);
    else
      return (vreg)_mm_alignr_epi32((__m128i)w, _mm_set1_epi32(v), 3);
  }
  void load(const int32_t* ls) {
    fc = vload(ls);
    ic = vload(ls + MV);
    xb = vload(ls + 2 * MV);
    pb = vload(ls + 3 * MV);
  }
  inline __attribute__((always_inline)) int32_t step(int32_t x) {
    const int32_t acc = 512 + hsum(vadd(vmul(fc, xb), vmul(ic, pb)));
    const int32_t pred = acc >> 10;
    const bool warm = proc < MV;
    int32_t y = x + pred;
    if (!warm) {
      const uint32_t mag = (uint32_t)(x < 0 ? -x : x);
      const int32_t bl = (mag == 0) ? 0 : (32 - __builtin_clz(mag));
      const int32_t step_v = ((x > 0) - (x < 0)) * (bl >> 1);
      const vreg sv = vset1(step_v);
      fc = vadd(fc, vsign(sv, xb));
      ic = vadd(ic, vsign(sv, pb));
    }
    const int32_t new_sample = y;
    const int32_t ins_p = warm ? new_sample : pred;
    xb = shift_insert(xb, new_sample);
    pb = shift_insert(pb, ins_p);
    ++proc;
    return warm ? x : y;
  }
  void store(int32_t* ls) const {
    vstore(ls, fc);
    vstore(ls + MV, ic);
    vstore(ls + 2 * MV, xb);
    vstore(ls + 3 * MV, pb);
  }
};

// Full per-channel resumable cascade lane: LMS -> long-term -> lattice ->
// de-emphasis, identical state layouts to synth_chunk_impl.
template <int NZ, int MV>
struct SynthLane {
  LmsVec<MV> lms;
  LatticeVec<NZ> lat;
  int32_t lt_ring[1024];
  int32_t q15c[8];
  int32_t lt_head, lt_proc, pitch, max_delay, num_taps, deemph;
  inline __attribute__((always_inline)) int32_t step(int32_t x) {
    int32_t y = lms.step(x);
    if (pitch > 0) {
      int64_t s64 = 0;
      for (int32_t j = 0; j < num_taps; ++j)
        s64 += (int64_t)q15c[j] *
               lt_ring[(lt_head - (max_delay - j)) & 1023];
      const int32_t lpred = (int32_t)((s64 + (1 << 14)) >> 15);
      const int32_t lout = (lt_proc >= max_delay) ? y + lpred : y;
      lt_ring[lt_head & 1023] = lout;
      ++lt_head;
      y = lout;
    }
    ++lt_proc;
    y = lat.step(y);
    y += (deemph * 31) >> 5;
    deemph = y;
    return y;
  }
};

// NCH-channel chunk with the scalar impls' exact state contracts.
// noinline: each instantiation compiles as its own function — inlining all
// of them into one impl body wrecked register allocation (measured ~5x).
template <int NCH, int NZ, int MV>
__attribute__((noinline)) static int32_t synth_chunk_vec(
    const int32_t* residual, int32_t* out, int32_t n,
    const int32_t* parcor_coef, int32_t coef_stride, int32_t parcor_order,
    int32_t* lattice_state, const int32_t* pitch, const int32_t* ltm_coef,
    int32_t ltm_stride, int32_t num_taps, int32_t* lt_hist,
    int32_t lt_hist_len, int32_t* lt_processed, int32_t lms_order,
    int32_t* lms_state, int32_t* lms_processed, int32_t* deemph_prev) {
  (void)lms_order;
  // Explicitly unrolled per-channel lanes (ln0/ln1 locals, never indexed
  // by a runtime subscript): with the lanes in an array, the runtime
  // ln[c] access blocked scalar-replacement and every step round-tripped
  // the vector state through the stack (measured ~4x slower).
  SynthLane<NZ, MV> ln0, ln1;
  auto load_lane = [&](SynthLane<NZ, MV>& ln, int c) {
    ln.lms.load(lms_state + (int64_t)c * 4 * MV);
    ln.lms.proc = lms_processed[c];
    ln.lat.load(parcor_coef + (int64_t)c * coef_stride,
                lattice_state + (int64_t)c * (parcor_order + 1),
                parcor_order);
    ln.deemph = deemph_prev[c];
    ln.pitch = pitch[c];
    ln.num_taps = num_taps;
    ln.max_delay = pitch[c] + num_taps / 2;
    ln.lt_head = lt_hist_len;
    ln.lt_proc = lt_processed[c];
    if (pitch[c] > 0) {
      // zeroed ring ONLY for degenerate corrupt-stream shapes: taps past
      // the history must read deterministic zeros (matches the scalar
      // impls + reference); normal parameters never reach unseeded slots
      if (ln.max_delay < num_taps || ln.max_delay > lt_hist_len)
        std::memset(ln.lt_ring, 0, sizeof(ln.lt_ring));
      for (int32_t i = 0; i < lt_hist_len; ++i)
        ln.lt_ring[i] = lt_hist[(int64_t)c * lt_hist_len + i];
    }
    for (int32_t j = 0; j < num_taps; ++j)
      ln.q15c[j] = ltm_coef[(int64_t)c * ltm_stride + j] >> 16;
  };
  auto store_lane = [&](SynthLane<NZ, MV>& ln, int c) {
    ln.lms.store(lms_state + (int64_t)c * 4 * MV);
    lms_processed[c] = ln.lms.proc;
    ln.lat.store(lattice_state + (int64_t)c * (parcor_order + 1));
    deemph_prev[c] = ln.deemph;
    lt_processed[c] = ln.lt_proc;
    if (pitch[c] > 0)
      for (int32_t i = 0; i < lt_hist_len; ++i)
        lt_hist[(int64_t)c * lt_hist_len + i] =
            ln.lt_ring[(ln.lt_head - lt_hist_len + i) & 1023];
  };
  load_lane(ln0, 0);
  if constexpr (NCH == 2) load_lane(ln1, 1);
  if (n > 0) {  // hoisted out of step(): one flag write, not one per sample
    ln0.lat.stepped = true;
    if constexpr (NCH == 2) ln1.lat.stepped = true;
  }
  if constexpr (NCH == 2) {
    int32_t* out1 = out + n;
    const int32_t* res1 = residual + n;
    for (int32_t s = 0; s < n; ++s) {
      out[s] = ln0.step(residual[s]);
      out1[s] = ln1.step(res1[s]);
    }
  } else {
    for (int32_t s = 0; s < n; ++s) out[s] = ln0.step(residual[s]);
  }
  store_lane(ln0, 0);
  if constexpr (NCH == 2) store_lane(ln1, 1);
  return 0;
}

// Dispatcher: 0 = not eligible (caller falls back to the scalar loop).
template <int NCH>
static inline bool synth_chunk_vec_dispatch(
    const int32_t* residual, int32_t* out, int32_t n,
    const int32_t* parcor_coef, int32_t coef_stride, int32_t parcor_order,
    int32_t* lattice_state, const int32_t* pitch, const int32_t* ltm_coef,
    int32_t ltm_stride, int32_t num_taps, int32_t* lt_hist,
    int32_t lt_hist_len, int32_t* lt_processed, int32_t lms_order,
    int32_t* lms_state, int32_t* lms_processed, int32_t* deemph_prev,
    int32_t* rc) {
  if (parcor_order > 32 || num_taps > 8 || lt_hist_len > 1024 ||
      (lms_order != 4 && lms_order != 8))
    return false;
  const bool nz2 = parcor_order > 16;
  if (lms_order == 8) {
    *rc = nz2 ? synth_chunk_vec<NCH, 2, 8>(
                    residual, out, n, parcor_coef, coef_stride, parcor_order,
                    lattice_state, pitch, ltm_coef, ltm_stride, num_taps,
                    lt_hist, lt_hist_len, lt_processed, lms_order, lms_state,
                    lms_processed, deemph_prev)
              : synth_chunk_vec<NCH, 1, 8>(
                    residual, out, n, parcor_coef, coef_stride, parcor_order,
                    lattice_state, pitch, ltm_coef, ltm_stride, num_taps,
                    lt_hist, lt_hist_len, lt_processed, lms_order, lms_state,
                    lms_processed, deemph_prev);
  } else {
    *rc = nz2 ? synth_chunk_vec<NCH, 2, 4>(
                    residual, out, n, parcor_coef, coef_stride, parcor_order,
                    lattice_state, pitch, ltm_coef, ltm_stride, num_taps,
                    lt_hist, lt_hist_len, lt_processed, lms_order, lms_state,
                    lms_processed, deemph_prev)
              : synth_chunk_vec<NCH, 1, 4>(
                    residual, out, n, parcor_coef, coef_stride, parcor_order,
                    lattice_state, pitch, ltm_coef, ltm_stride, num_taps,
                    lt_hist, lt_hist_len, lt_processed, lms_order, lms_state,
                    lms_processed, deemph_prev);
  }
  return true;
}

}  // namespace tapvec
#endif  // __AVX512F__ && __AVX512VL__

// Runtime-order body with register-resident serial state (lattice,
// LMS coefficient rows, processed counters, de-emphasis): measured ~6%
// faster than the pointer-chasing original; compile-time preset-order
// specializations were tried and did NOT pay off here — the scalar
// cascade is bound by its loop-carried dependency chain, not by memory
// (unlike the 8/16-row vectorized kernels, where they won big). The
// tap-vectorized AVX-512 form above breaks exactly that chain; this
// scalar body remains the semantic reference, the non-AVX-512 fallback,
// the debug-assert carrier, and the non-preset-order path.
static int32_t synth_chunk_impl(
    const int32_t* residual, int32_t* out, int32_t n,
    // lattice
    const int32_t* parcor_coef /* p entries, orders 1..p */, int32_t parcor_order,
    int32_t* lattice_state /* p+1 */,
    // longterm
    int32_t pitch, const int32_t* ltm_coef /* T Q31 */, int32_t num_taps,
    int32_t* lt_hist /* lt_hist_len */, int32_t lt_hist_len, int32_t* lt_processed,
    // lms
    int32_t lms_order, int32_t* lms_state /* 4*M */, int32_t* lms_processed,
    // emphasis
    int32_t* deemph_prev) {
  const int32_t p = parcor_order;
  const int32_t M = lms_order;
  if (p > 64 || M > 64) return -1;  // scratch capacity: don't trust callers
#if defined(__AVX512F__) && defined(__AVX512VL__) && \
    !defined(SLA_TPU_DEBUG) && !defined(SLA_TPU_FORCE_SCALAR_SYNTH)
  {
    int32_t rc;
    if (tapvec::synth_chunk_vec_dispatch<1>(
            residual, out, n, parcor_coef, p, p, lattice_state, &pitch,
            ltm_coef, num_taps, num_taps, lt_hist, lt_hist_len, lt_processed,
            M, lms_state, lms_processed, deemph_prev, &rc))
      return rc;
  }
#endif
  // register/L1-resident copies of the serial filter state (written back
  // at the end)
  int32_t pc[64];
  int32_t lat[64 + 1];
  for (int32_t i = 0; i < p; ++i) pc[i] = parcor_coef[i];
  for (int32_t i = 0; i <= p; ++i) lat[i] = lattice_state[i];
  int32_t fcl[64], icl[64];
  for (int32_t i = 0; i < M; ++i) fcl[i] = lms_state[i];
  for (int32_t i = 0; i < M; ++i) icl[i] = lms_state[M + i];
  int32_t deemph = *deemph_prev;
  int32_t* xb_ext = lms_state + 2 * M;
  int32_t* pb_ext = lms_state + 3 * M;
  int32_t lms_proc = *lms_processed;
  int32_t lt_proc = *lt_processed;
  const int32_t max_delay = pitch + num_taps / 2;

  // Doubled LMS ring buffers (newest at xd[xpos]); avoids the per-sample
  // shift of the external newest-first layout. Copied in/out per call.
  int32_t xd[2 * 64], pd[2 * 64];
  int32_t xpos = 64;  // room to decrement for up to 64 samples before refill
  for (int32_t i = 0; i < M; ++i) {
    xd[xpos + i] = xb_ext[i];
    pd[xpos + i] = pb_ext[i];
  }
  // Long-term history ring: hist value k steps back = ring[(head - k) & mask]
  // with a power-of-two ring of >= 2 * lt_hist_len entries.
  int32_t lt_ring[1024];
  const int32_t lt_mask = 1023;
  int32_t lt_head = lt_hist_len;  // position of the NEXT write
  if (pitch > 0) {
    if (lt_hist_len > 1024) return -1;  // scratch capacity: don't trust callers
    // Degenerate (corrupt-stream) parameters — max_delay < num_taps, or a
    // caller hist shorter than max_delay — make taps reach slots no
    // history covers; the reference's ring is memset at reset, so those
    // reads must be deterministic zeros, not stack garbage. Normal
    // parameters read only seeded or already-written slots, so the 4 KB
    // memset (measurable at 120 Hz tick rate) is gated on the degenerate
    // shapes.
    if (max_delay < num_taps || max_delay > lt_hist_len)
      std::memset(lt_ring, 0, sizeof(lt_ring));
    for (int32_t i = 0; i < lt_hist_len; ++i) lt_ring[i] = lt_hist[i];
  }
  int32_t q15c[8];
  if (num_taps > 8) return -1;
  for (int32_t j = 0; j < num_taps; ++j) q15c[j] = ltm_coef[j] >> 16;

  for (int32_t s = 0; s < n; ++s) {
    // ---- LMS synthesis (kernels/lms.py step, synthesize=True)
    int32_t x = residual[s];
    const int32_t* xb = xd + xpos;
    const int32_t* pb = pd + xpos;
    int32_t acc = 512;
    for (int32_t i = 0; i < M; ++i) acc += fcl[i] * xb[i];
    for (int32_t i = 0; i < M; ++i) acc += icl[i] * pb[i];
    int32_t pred = acc >> 10;
    bool warm = lms_proc < M;
    int32_t res = x;
    int32_t y = x + pred;
    if (!warm) {
      uint32_t mag = (uint32_t)(res < 0 ? -res : res);
      int32_t bl = (mag == 0) ? 0 : (32 - __builtin_clz(mag));
      int32_t step = ((res > 0) - (res < 0)) * (bl >> 1);
      for (int32_t i = 0; i < M; ++i) {
        fcl[i] += step * ((xb[i] > 0) - (xb[i] < 0));
        icl[i] += step * ((pb[i] > 0) - (pb[i] < 0));
      }
    }
    int32_t new_sample = y;
    int32_t ins_p = warm ? new_sample : pred;
    if (xpos == 0) {  // refill headroom
      for (int32_t i = M - 1; i >= 0; --i) { xd[64 + i] = xd[i]; pd[64 + i] = pd[i]; }
      xpos = 64;
    }
    --xpos;
    xd[xpos] = new_sample;
    pd[xpos] = ins_p;
    if (warm) y = x;
    ++lms_proc;

    // ---- long-term synthesis (kernels/longterm.py step)
    if (pitch > 0) {
      int64_t s64 = 0;
      for (int32_t j = 0; j < num_taps; ++j) {
        int32_t back = max_delay - j;  // samples back (>= 1)
        s64 += (int64_t)q15c[j] * lt_ring[(lt_head - back) & lt_mask];
      }
      int32_t lpred = (int32_t)((s64 + (1 << 14)) >> 15);
      int32_t lout = (lt_proc >= max_delay) ? y + lpred : y;
      lt_ring[lt_head & lt_mask] = lout;
      ++lt_head;
      y = lout;
    }
    ++lt_proc;

    // ---- PARCOR lattice synthesis (kernels/lattice.py step)
    {
      int32_t f = y;
      for (int32_t k = p; k >= 1; --k) {
        f += qmul15(pc[k - 1], lat[k - 1]);
        lat[k] = lat[k - 1] - qmul15(pc[k - 1], f);
      }
      lat[0] = f;
      y = f;
    }

    // ---- de-emphasis (kernels/emphasis.py)
    y = y + ((deemph * 31) >> 5);
    deemph = y;
    out[s] = y;
  }

  // write the register-resident and ring states back to the caller's
  // canonical layouts
  for (int32_t i = 0; i <= p; ++i) lattice_state[i] = lat[i];
  for (int32_t i = 0; i < M; ++i) lms_state[i] = fcl[i];
  for (int32_t i = 0; i < M; ++i) lms_state[M + i] = icl[i];
  *lms_processed = lms_proc;
  *lt_processed = lt_proc;
  *deemph_prev = deemph;
  for (int32_t i = 0; i < M; ++i) {
    xb_ext[i] = xd[xpos + i];
    pb_ext[i] = pd[xpos + i];
  }
  if (pitch > 0) {
    for (int32_t i = 0; i < lt_hist_len; ++i)
      lt_hist[i] = lt_ring[(lt_head - lt_hist_len + i) & lt_mask];
  }
  return 0;
}

// Two-channel interleaved resumable synthesis: both channels' cascades
// advance in lockstep within one sample loop. Each chain is latency-bound
// (its per-sample dependency runs through the LMS update, long-term ring,
// and p lattice stages), so a second independent chain in the out-of-order
// window roughly doubles throughput; per-channel arithmetic and state
// evolution are identical to synth_chunk_impl.
static int32_t synth_chunk2_impl(
    const int32_t* residual /* 2 x n */, int32_t* out /* 2 x n */, int32_t n,
    const int32_t* parcor_coef /* 2 x coef_stride */, int32_t coef_stride,
    int32_t parcor_order, int32_t* lattice_state /* 2 x (p+1) */,
    const int32_t* pitch /* 2 */, const int32_t* ltm_coef /* 2 x stride */,
    int32_t ltm_stride, int32_t num_taps, int32_t* lt_hist /* 2 x len */,
    int32_t lt_hist_len, int32_t* lt_processed /* 2 */, int32_t lms_order,
    int32_t* lms_state /* 2 x 4M */, int32_t* lms_processed /* 2 */,
    int32_t* deemph_prev /* 2 */) {
  const int32_t p = parcor_order;
  const int32_t M = lms_order;
  if (p > 64 || M > 64 || num_taps > 8) return -1;
  if (lt_hist_len > 1024) return -1;
#if defined(__AVX512F__) && defined(__AVX512VL__) && \
    !defined(SLA_TPU_DEBUG) && !defined(SLA_TPU_FORCE_SCALAR_SYNTH)
  {
    int32_t rc;
    if (tapvec::synth_chunk_vec_dispatch<2>(
            residual, out, n, parcor_coef, coef_stride, p, lattice_state,
            pitch, ltm_coef, ltm_stride, num_taps, lt_hist, lt_hist_len,
            lt_processed, M, lms_state, lms_processed, deemph_prev, &rc))
      return rc;
  }
#endif
  int32_t pc[2][64], lat[2][65], fcl[2][64], icl[2][64];
  int32_t xd[2][128], pd[2][128], lt_ring[2][1024], q15c[2][8];
  int32_t deemph[2], xpos[2], lt_head[2], lms_proc[2], lt_proc[2], mdel[2];
  for (int c = 0; c < 2; ++c) {
    for (int32_t i = 0; i < p; ++i) pc[c][i] = parcor_coef[(int64_t)c * coef_stride + i];
    for (int32_t i = 0; i <= p; ++i) lat[c][i] = lattice_state[(int64_t)c * (p + 1) + i];
    int32_t* ls = lms_state + (int64_t)c * 4 * M;
    for (int32_t i = 0; i < M; ++i) fcl[c][i] = ls[i];
    for (int32_t i = 0; i < M; ++i) icl[c][i] = ls[M + i];
    deemph[c] = deemph_prev[c];
    xpos[c] = 64;
    for (int32_t i = 0; i < M; ++i) {
      xd[c][64 + i] = ls[2 * M + i];
      pd[c][64 + i] = ls[3 * M + i];
    }
    lt_head[c] = lt_hist_len;
    if (pitch[c] > 0) {
      const int32_t md = pitch[c] + num_taps / 2;  // see synth_chunk_impl
      if (md < num_taps || md > lt_hist_len)
        std::memset(lt_ring[c], 0, sizeof(lt_ring[c]));
      for (int32_t i = 0; i < lt_hist_len; ++i)
        lt_ring[c][i] = lt_hist[(int64_t)c * lt_hist_len + i];
    }
    for (int32_t j = 0; j < num_taps; ++j)
      q15c[c][j] = ltm_coef[(int64_t)c * ltm_stride + j] >> 16;
    lms_proc[c] = lms_processed[c];
    lt_proc[c] = lt_processed[c];
    mdel[c] = pitch[c] + num_taps / 2;
  }
  const int32_t lt_mask = 1023;
  for (int32_t s = 0; s < n; ++s) {
    for (int c = 0; c < 2; ++c) {
      // ---- LMS synthesis
      int32_t x = residual[(int64_t)c * n + s];
      const int32_t* xb = xd[c] + xpos[c];
      const int32_t* pb = pd[c] + xpos[c];
      int32_t acc = 512;
      for (int32_t i = 0; i < M; ++i) acc += fcl[c][i] * xb[i];
      for (int32_t i = 0; i < M; ++i) acc += icl[c][i] * pb[i];
      int32_t pred = acc >> 10;
      bool warm = lms_proc[c] < M;
      int32_t res = x;
      int32_t y = x + pred;
      if (!warm) {
        uint32_t mag = (uint32_t)(res < 0 ? -res : res);
        int32_t bl = (mag == 0) ? 0 : (32 - __builtin_clz(mag));
        int32_t step = ((res > 0) - (res < 0)) * (bl >> 1);
        for (int32_t i = 0; i < M; ++i) {
          fcl[c][i] += step * ((xb[i] > 0) - (xb[i] < 0));
          icl[c][i] += step * ((pb[i] > 0) - (pb[i] < 0));
        }
      }
      int32_t new_sample = y;
      int32_t ins_p = warm ? new_sample : pred;
      if (xpos[c] == 0) {  // refill headroom
        for (int32_t i = M - 1; i >= 0; --i) {
          xd[c][64 + i] = xd[c][i];
          pd[c][64 + i] = pd[c][i];
        }
        xpos[c] = 64;
      }
      --xpos[c];
      xd[c][xpos[c]] = new_sample;
      pd[c][xpos[c]] = ins_p;
      if (warm) y = x;
      ++lms_proc[c];
      // ---- long-term synthesis
      if (pitch[c] > 0) {
        int64_t s64 = 0;
        for (int32_t j = 0; j < num_taps; ++j) {
          int32_t back = mdel[c] - j;
          s64 += (int64_t)q15c[c][j] * lt_ring[c][(lt_head[c] - back) & lt_mask];
        }
        int32_t lpred = (int32_t)((s64 + (1 << 14)) >> 15);
        int32_t lout = (lt_proc[c] >= mdel[c]) ? y + lpred : y;
        lt_ring[c][lt_head[c] & lt_mask] = lout;
        ++lt_head[c];
        y = lout;
      }
      ++lt_proc[c];
      // ---- PARCOR lattice synthesis
      {
        int32_t f = y;
        for (int32_t k = p; k >= 1; --k) {
          f += qmul15(pc[c][k - 1], lat[c][k - 1]);
          lat[c][k] = lat[c][k - 1] - qmul15(pc[c][k - 1], f);
        }
        lat[c][0] = f;
        y = f;
      }
      // ---- de-emphasis
      y = y + ((deemph[c] * 31) >> 5);
      deemph[c] = y;
      out[(int64_t)c * n + s] = y;
    }
  }
  for (int c = 0; c < 2; ++c) {
    for (int32_t i = 0; i <= p; ++i) lattice_state[(int64_t)c * (p + 1) + i] = lat[c][i];
    int32_t* ls = lms_state + (int64_t)c * 4 * M;
    for (int32_t i = 0; i < M; ++i) ls[i] = fcl[c][i];
    for (int32_t i = 0; i < M; ++i) ls[M + i] = icl[c][i];
    lms_processed[c] = lms_proc[c];
    lt_processed[c] = lt_proc[c];
    deemph_prev[c] = deemph[c];
    for (int32_t i = 0; i < M; ++i) {
      ls[2 * M + i] = xd[c][xpos[c] + i];
      ls[3 * M + i] = pd[c][xpos[c] + i];
    }
    if (pitch[c] > 0)
      for (int32_t i = 0; i < lt_hist_len; ++i)
        lt_hist[(int64_t)c * lt_hist_len + i] =
            lt_ring[c][(lt_head[c] - lt_hist_len + i) & lt_mask];
  }
  return 0;
}

extern "C" {

int32_t sla_synth_chunk(
    const int32_t* residual, int32_t* out, int32_t n,
    const int32_t* parcor_coef, int32_t parcor_order,
    int32_t* lattice_state,
    int32_t pitch, const int32_t* ltm_coef, int32_t num_taps,
    int32_t* lt_hist, int32_t lt_hist_len, int32_t* lt_processed,
    int32_t lms_order, int32_t* lms_state, int32_t* lms_processed,
    int32_t* deemph_prev) {
  return synth_chunk_impl(
      residual, out, n, parcor_coef, parcor_order, lattice_state, pitch,
      ltm_coef, num_taps, lt_hist, lt_hist_len, lt_processed, lms_order,
      lms_state, lms_processed, deemph_prev);
}

// Streaming-tick synthesis for ALL channels in one call: per-channel
// sla_synth_chunk (identical state layouts, stacked row-major), then the
// mid/side inverse (SLAUtility.c:415-433 int32 wrap semantics) and the
// final left shift, so a 120 Hz decode tick costs one FFI crossing instead
// of per-channel calls plus three NumPy passes. coef/ltm strides are the
// row widths of their (C, w) arrays; ms requires exactly 2 channels.
int32_t sla_synth_chunk_rows(
    const int32_t* residual, int32_t* out, int32_t C, int32_t n,
    const int32_t* parcor_coef, int32_t coef_stride, int32_t parcor_order,
    int32_t* lattice_state,
    const int32_t* pitch,
    const int32_t* ltm_coef, int32_t ltm_stride, int32_t num_taps,
    int32_t* lt_hist, int32_t lt_hist_len,
    int32_t* lt_processed,
    int32_t lms_order, int32_t* lms_state,
    int32_t* lms_processed,
    int32_t* deemph_prev,
    int32_t ms, int32_t shift) {
  if (ms && C != 2) return -2;
  if (C == 2) {
    const int32_t rc = synth_chunk2_impl(
        residual, out, n, parcor_coef, coef_stride, parcor_order,
        lattice_state, pitch, ltm_coef, ltm_stride, num_taps, lt_hist,
        lt_hist_len, lt_processed, lms_order, lms_state, lms_processed,
        deemph_prev);
    if (rc != 0) return rc;
  } else
  for (int32_t ch = 0; ch < C; ++ch) {
    int32_t rc = sla_synth_chunk(
        residual + (int64_t)ch * n, out + (int64_t)ch * n, n,
        parcor_coef + (int64_t)ch * coef_stride, parcor_order,
        lattice_state + (int64_t)ch * (parcor_order + 1),
        pitch[ch], ltm_coef + (int64_t)ch * ltm_stride, num_taps,
        lt_hist + (int64_t)ch * lt_hist_len, lt_hist_len, lt_processed + ch,
        lms_order, lms_state + (int64_t)ch * 4 * lms_order,
        lms_processed + ch, deemph_prev + ch);
    if (rc != 0) return rc;
  }
  if (ms) {
    int32_t* mid = out;
    int32_t* side = out + n;
    for (int32_t s = 0; s < n; ++s) {
      int32_t m = mid[s], sd = side[s];
      int32_t full = (m << 1) | (sd & 1);  // -fwrapv: int32 wrap like the ref
      mid[s] = (full + sd) >> 1;
      side[s] = (full - sd) >> 1;
    }
  }
  if (shift) {
    const int64_t total = (int64_t)C * n;
    for (int64_t i = 0; i < total; ++i) out[i] <<= shift;
  }
  return 0;
}

// One fused streaming decode tick: resumable entropy read + underrun check
// + all-channel synthesis (+ MS inverse + left shift), replacing three FFI
// crossings and a Python-side filter-state snapshot per 120 Hz tick. On
// underrun (*bit_pos past the buffered end, i.e. the feed contract of
// SLADecoder.c:1008-1097 was violated) the cursor state is rolled back and
// 1 is returned with the filter state untouched — the cascade only runs
// after the check passes, mirroring the Python-path ordering in
// streaming._decode_wave_data. residual_scratch must hold C*n int32s.
int32_t sla_stream_tick(
    const uint8_t* buf, int64_t buf_len, int64_t* bit_pos,
    uint64_t* param_state, const uint32_t* eff_params, int32_t use_golomb,
    int32_t* residual_scratch,
    int32_t* out, int32_t C, int32_t n,
    const int32_t* parcor_coef, int32_t coef_stride, int32_t parcor_order,
    int32_t* lattice_state, const int32_t* pitch,
    const int32_t* ltm_coef, int32_t ltm_stride, int32_t num_taps,
    int32_t* lt_hist, int32_t lt_hist_len, int32_t* lt_processed,
    int32_t lms_order, int32_t* lms_state, int32_t* lms_processed,
    int32_t* deemph_prev, int32_t ms, int32_t shift) {
  if (C > 64) return -1;
  const int64_t save_pos = *bit_pos;
  uint64_t save_params[64 * kNumRecursiveParams];
  // (sla_stream_tick_packed below passes these same arguments through one
  // int64 block — a 120 Hz caller marshals one pointer instead of 27)
  if (!use_golomb)
    std::memcpy(save_params, param_state,
                sizeof(uint64_t) * (size_t)C * kNumRecursiveParams);
  int32_t rc = sla_get_data_array_partial(buf, buf_len, bit_pos, C, n,
                                          param_state, eff_params, use_golomb,
                                          residual_scratch);
  if (rc != 0) return rc;
  if (*bit_pos > 8 * buf_len) {
    *bit_pos = save_pos;
    if (!use_golomb)
      std::memcpy(param_state, save_params,
                  sizeof(uint64_t) * (size_t)C * kNumRecursiveParams);
    return 1;  // underrun: caller feeds more data and retries this tick
  }
  return sla_synth_chunk_rows(
      residual_scratch, out, C, n, parcor_coef, coef_stride, parcor_order,
      lattice_state, pitch, ltm_coef, ltm_stride, num_taps, lt_hist,
      lt_hist_len, lt_processed, lms_order, lms_state, lms_processed,
      deemph_prev, ms, shift);
}

// Packed-argument form of sla_stream_tick: `a` is a 27-slot int64 block
// (pointers as integers, scalars widened). ctypes marshaling of 27
// arguments measured ~18 us per call — at a 120 Hz tick cadence that was
// a third of the whole tick; one pointer is ~1.5 us.
int32_t sla_stream_tick_packed(const int64_t* a) {
  return sla_stream_tick(
      (const uint8_t*)(uintptr_t)a[0], a[1], (int64_t*)(uintptr_t)a[2],
      (uint64_t*)(uintptr_t)a[3], (const uint32_t*)(uintptr_t)a[4],
      (int32_t)a[5], (int32_t*)(uintptr_t)a[6], (int32_t*)(uintptr_t)a[7],
      (int32_t)a[8], (int32_t)a[9], (const int32_t*)(uintptr_t)a[10],
      (int32_t)a[11], (int32_t)a[12], (int32_t*)(uintptr_t)a[13],
      (const int32_t*)(uintptr_t)a[14], (const int32_t*)(uintptr_t)a[15],
      (int32_t)a[16], (int32_t)a[17], (int32_t*)(uintptr_t)a[18],
      (int32_t)a[19], (int32_t*)(uintptr_t)a[20], (int32_t)a[21],
      (int32_t*)(uintptr_t)a[22], (int32_t*)(uintptr_t)a[23],
      (int32_t*)(uintptr_t)a[24], (int32_t)a[25], (int32_t)a[26]);
}

// sla_stream_tick_packed with a strided landing buffer: a[27] is a second
// C*n int32 scratch, a[28] the output ROW stride in elements. The tick
// synthesizes into the contiguous scratch, then row-copies into
// out + c*stride — so decode_into() can land samples at a column offset
// of the caller's whole-stream array (the reference decodes through a
// `buffer + offset` pointer the same way, SLADecoder.c:1008-1097) with no
// Python-side copy. stride == n writes direct, no extra copy.
int32_t sla_stream_tick_strided(const int64_t* a) {
  const int32_t C = (int32_t)a[8];
  const int32_t n = (int32_t)a[9];
  const int64_t stride = a[28];
  int32_t* out = (int32_t*)(uintptr_t)a[7];
  int32_t* synth = (stride == n) ? out : (int32_t*)(uintptr_t)a[27];
  const int32_t rc = sla_stream_tick(
      (const uint8_t*)(uintptr_t)a[0], a[1], (int64_t*)(uintptr_t)a[2],
      (uint64_t*)(uintptr_t)a[3], (const uint32_t*)(uintptr_t)a[4],
      (int32_t)a[5], (int32_t*)(uintptr_t)a[6], synth,
      C, n, (const int32_t*)(uintptr_t)a[10],
      (int32_t)a[11], (int32_t)a[12], (int32_t*)(uintptr_t)a[13],
      (const int32_t*)(uintptr_t)a[14], (const int32_t*)(uintptr_t)a[15],
      (int32_t)a[16], (int32_t)a[17], (int32_t*)(uintptr_t)a[18],
      (int32_t)a[19], (int32_t*)(uintptr_t)a[20], (int32_t)a[21],
      (int32_t*)(uintptr_t)a[22], (int32_t*)(uintptr_t)a[23],
      (int32_t*)(uintptr_t)a[24], (int32_t)a[25], (int32_t)a[26]);
  if (rc == 0 && synth != out)
    for (int32_t c = 0; c < C; ++c)
      std::memcpy(out + (int64_t)c * stride, synth + (int64_t)c * n,
                  sizeof(int32_t) * (size_t)n);
  return rc;
}

// Encode-side filter cascade for one channel row: pre-emphasis -> PARCOR
// lattice predict -> long-term predict -> LMS predict (SLAEncoder.c:598-672
// order), whole block in one call. This is the host backend of the
// encoder's batched device pipeline (pipeline.py) — used when the batch is
// too small to amortize device dispatch + transfer, with identical wrapping
// int32 semantics (cross-checked by tests against the JAX path).
//
// in/out may alias for stage 1 (per-sample read-then-write). Stage 2's
// long-term FIR reads lagged INPUT history, so its in/out must be
// DISTINCT buffers — aliasing would replace the history with residuals
// and diverge from the JAX kernel. pitch 0 disables the long-term stage.
// Stage 1: pre-emphasis + lattice predict (produces the residual the pitch
// analysis runs on).
int32_t sla_predict_stage1(const int32_t* in, int32_t* out, int32_t n,
                           const int32_t* parcor_coef, int32_t parcor_order) {
  const int32_t p = parcor_order;
  int32_t b[64 + 1] = {0};
  int32_t x_prev = 0;
  for (int32_t s = 0; s < n; ++s) {
    int32_t x = in[s] - ((x_prev * 31) >> 5);
    x_prev = in[s];
    // forward recursion f[k] = f[k-1] - q(c[k], b[k-1]); then backward
    int32_t f = x;
    int32_t b_prev_km1 = b[0];  // b_prev[k-1] walking up
    int32_t new_b_km1 = x;      // b_new[0] = x
    for (int32_t k = 1; k <= p; ++k) {
      int32_t b_prev_k = b[k];
      int32_t f_prev = f;  // f[k-1]
      f = f - qmul15(parcor_coef[k - 1], b_prev_km1);
      int32_t nb = b_prev_km1 - qmul15(parcor_coef[k - 1], f_prev);
      b[k - 1] = new_b_km1;
      new_b_km1 = nb;
      b_prev_km1 = b_prev_k;
    }
    b[p] = new_b_km1;
    out[s] = f;
  }
  return 0;
}

// Stage 2: long-term predict (FIR, history = input) + LMS predict.
int32_t sla_predict_stage2(const int32_t* in, int32_t* out, int32_t n,
                           int32_t pitch, const int32_t* ltm_coef,
                           int32_t num_taps, int32_t lms_order) {
  const int32_t* lt_in = in;
  int32_t* lt_out = out;
  if (pitch > 0) {
    const int32_t max_delay = pitch + num_taps / 2;
    for (int32_t s = 0; s < n; ++s) {
      if (s < max_delay) {
        lt_out[s] = lt_in[s];
      } else {
        int64_t acc = 0;
        for (int32_t j = 0; j < num_taps; ++j)
          acc += (int64_t)(ltm_coef[j] >> 16) * lt_in[s - (max_delay - j)];
        lt_out[s] = lt_in[s] - (int32_t)((acc + (1 << 14)) >> 15);
      }
    }
  } else if (lt_out != lt_in) {
    std::memmove(lt_out, lt_in, sizeof(int32_t) * n);
  }
  // LMS predict in place over lt_out
  {
    const int32_t M = lms_order;
    int32_t fc[64] = {0}, ic[64] = {0}, xb[64] = {0}, pb[64] = {0};
    for (int32_t s = 0; s < n; ++s) {
      int32_t x = lt_out[s];
      int32_t acc = 512;
      for (int32_t i = 0; i < M; ++i) acc += fc[i] * xb[i];
      for (int32_t i = 0; i < M; ++i) acc += ic[i] * pb[i];
      int32_t pred = acc >> 10;
      bool warm = s < M;
      int32_t res = x - pred;
      if (!warm) {
        uint32_t mag = (uint32_t)(res < 0 ? -res : res);
        int32_t bl = (mag == 0) ? 0 : (32 - __builtin_clz(mag));
        int32_t step = ((res > 0) - (res < 0)) * (bl >> 1);
        for (int32_t i = 0; i < M; ++i) {
          fc[i] += step * ((xb[i] > 0) - (xb[i] < 0));
          ic[i] += step * ((pb[i] > 0) - (pb[i] < 0));
        }
      }
      int32_t ins_p = warm ? x : pred;
      for (int32_t i = M - 1; i > 0; --i) { xb[i] = xb[i - 1]; pb[i] = pb[i - 1]; }
      xb[0] = x;
      pb[0] = ins_p;
      lt_out[s] = warm ? x : res;
    }
  }
  return 0;
}

// Span autocorrelations for the Dijkstra partition cost model: for each lag
// k and each span [start, end), sum_{n in [start, end-k)} x[n] * x[n+k].
// Sums run per segment between query boundaries then combine (the same
// association as the NumPy reduceat path it replaces). data: C x N row-major
// float64; spans: S x 2 node indices; positions: V sample offsets.
// out: S x C x (order+1).
// Shared per-lag span geometry: sorted unique boundary positions (span
// starts and clamped ends) plus each span's prefix indices into them.
// ONE implementation serves all three span-autocorrelation variants —
// this clamp/boundary logic must never fork.
static int32_t span_lag_geometry(const int64_t* positions, const int64_t* spans,
                                 int32_t S, int32_t k, int64_t* qp,
                                 int32_t* si, int32_t* ei) {
  int64_t tmp[4096];
  int32_t nq = 0;
  for (int32_t s = 0; s < S; ++s) {
    int64_t st = positions[spans[2 * s]];
    int64_t e = positions[spans[2 * s + 1]] - k;
    if (e < st) e = st;
    tmp[nq++] = st;
    tmp[nq++] = e;
  }
  std::sort(tmp, tmp + nq);
  int32_t nu = 0;
  for (int32_t i = 0; i < nq; ++i)
    if (i == 0 || tmp[i] != tmp[i - 1]) qp[nu++] = tmp[i];
  for (int32_t s = 0; s < S; ++s) {
    int64_t st = positions[spans[2 * s]];
    int64_t e = positions[spans[2 * s + 1]] - k;
    if (e < st) e = st;
    int32_t lo = 0, hi = nu - 1;
    while (lo <= hi) { int32_t mid = (lo + hi) / 2; if (qp[mid] < st) lo = mid + 1; else hi = mid - 1; }
    si[s] = lo;
    lo = 0; hi = nu - 1;
    while (lo <= hi) { int32_t mid = (lo + hi) / 2; if (qp[mid] < e) lo = mid + 1; else hi = mid - 1; }
    ei[s] = lo;
  }
  return nu;
}

// Multi-window variant: W windows of identical geometry (same positions,
// spans, and window length) over one (C, file_n) base signal. The per-lag
// boundary sort and the per-span prefix-index binary searches run ONCE and
// are reused by every window — only the product-prefix pass repeats. Also
// avoids the per-window copies a view-based call would need. out:
// W x S x C x (order+1). Same association as sla_span_autocorr, so costs
// are identical.
static int32_t span_autocorr_multi_impl(
    const double* data, const int32_t* ibase, int64_t icstride, int32_t ms,
    int32_t C, int64_t file_n, const int64_t* win_off, int32_t W,
    int64_t win_len, const int64_t* positions,
    int32_t V, const int64_t* spans, int32_t S,
    int32_t order, double* out) {
  if (S <= 0 || 2 * S > 4096 || W <= 0) return -1;
  if (ibase && ms && C != 2) return -1;
  (void)V;
  const int32_t lags = order + 1;
  // optional int32 source (see span_autocorr_multi_onepass_impl): rows
  // convert into an L2-resident scratch with convert_ms's exact float64
  // arithmetic, so sums are bit-identical to the materialized-double call
  static thread_local std::vector<double> cbuf;
  double* conv = nullptr;
  if (ibase) {
    cbuf.resize((size_t)win_len + 16);
    conv = cbuf.data();
    conv += ((64 - ((uintptr_t)conv & 63)) & 63) / sizeof(double);
  }
  const double cscale = std::ldexp(1.0, -31);
  // phase 1: per-lag geometry (boundary sort + span prefix indices), once
  std::vector<int64_t> qpos((size_t)lags * 2 * S);
  std::vector<int32_t> nu_k(lags), sidx((size_t)lags * S), eidx((size_t)lags * S);
  for (int32_t k = 0; k < lags; ++k) {
    nu_k[k] = span_lag_geometry(positions, spans, S, k,
                                qpos.data() + (size_t)k * 2 * S,
                                sidx.data() + (size_t)k * S,
                                eidx.data() + (size_t)k * S);
  }
  // phase 2: window-outer product passes — each window's samples stay
  // cache-resident across all lags instead of streaming the whole base
  // signal once per lag
  double pf[4096];
  for (int32_t w = 0; w < W; ++w) {
    for (int32_t ch = 0; ch < C; ++ch) {
      const double* x;
      if (ibase) {
        if (ms) {
          const int32_t* lp = ibase + win_off[w];
          const int32_t* rp = ibase + icstride + win_off[w];
          if (ch == 0)
            for (int64_t i = 0; i < win_len; ++i)
              conv[i] = ((double)lp[i] * cscale + (double)rp[i] * cscale) / 2.0;
          else
            for (int64_t i = 0; i < win_len; ++i)
              conv[i] = (double)lp[i] * cscale - (double)rp[i] * cscale;
        } else {
          const int32_t* pp = ibase + (int64_t)ch * icstride + win_off[w];
          for (int64_t i = 0; i < win_len; ++i) conv[i] = (double)pp[i] * cscale;
        }
        x = conv;
      } else {
        x = data + (int64_t)ch * file_n + win_off[w];
      }
      for (int32_t k = 0; k < lags; ++k) {
        const int64_t* qp = qpos.data() + (size_t)k * 2 * S;
        const int32_t nu = nu_k[k];
        const int64_t limit = win_len - k;
        double acc = 0.0;
        int64_t pos = 0;
        for (int32_t j = 0; j < nu; ++j) {
          int64_t q = qp[j] < limit ? qp[j] : limit;
          v8df av = v8splat(0.0);
          for (; pos + 8 <= q; pos += 8) {
            v8df xa = *(const v8df*)(x + pos);
            v8df xb = *(const v8df*)(x + pos + k);
            av = av + xa * xb;
          }
          acc += ((av[0] + av[1]) + (av[2] + av[3])) +
                 ((av[4] + av[5]) + (av[6] + av[7]));
          for (; pos < q; ++pos) acc += x[pos] * x[pos + k];
          pf[j] = acc;
        }
        const int32_t* si = sidx.data() + (size_t)k * S;
        const int32_t* ei = eidx.data() + (size_t)k * S;
        double* o = out + (((int64_t)w * S) * C + ch) * lags + k;
        for (int32_t s = 0; s < S; ++s)
          o[(int64_t)s * C * lags] = pf[ei[s]] - pf[si[s]];
      }
    }
  }
  return 0;
}

int32_t sla_span_autocorr_multi(const double* data, int32_t C, int64_t file_n,
                                const int64_t* win_off, int32_t W,
                                int64_t win_len, const int64_t* positions,
                                int32_t V, const int64_t* spans, int32_t S,
                                int32_t order, double* out) {
  return span_autocorr_multi_impl(data, nullptr, 0, 0, C, file_n, win_off, W,
                                  win_len, positions, V, spans, S, order, out);
}

int32_t sla_span_autocorr_multi_i32(
    const int32_t* base, int64_t cstride, int32_t ms, int32_t C,
    const int64_t* win_off, int32_t W, int64_t win_len,
    const int64_t* positions, int32_t V, const int64_t* spans, int32_t S,
    int32_t order, double* out) {
  return span_autocorr_multi_impl(nullptr, base, cstride, ms, C, 0, win_off,
                                  W, win_len, positions, V, spans, S, order,
                                  out);
}

// One-pass variant: a single sweep over each window accumulates ALL lags'
// products (17 striped v8df accumulators, explicit FMA — this is the fast
// estimator, not byte-identity-pinned arithmetic; -ffp-contract=off keeps
// protecting the exact FFT/LPC elsewhere). Snapshots land at 8-aligned
// block boundaries with a scalar overshoot correction per event, so the
// memory traffic drops from lags passes over the window to one. Values
// differ from the per-lag variant only by float association (~1e-16
// relative), ten orders below the near-tie exact-reprice margin.
struct OnepassEvent { int64_t pos; int32_t lag; int32_t j; };

extern "C++" {  // templates are not C-linkage entities
// Register-resident segment kernel for the one-pass sweep: LAGS striped
// accumulators held in named zmm registers across a whole event-free run
// (the array-indexed form spills — GCC emits a stack load + store of
// av[k] around every FMA, making the sweep store-port-bound; measured
// ~2x). Returns the advanced position.
template <int32_t LAGS>
static inline int64_t onepass_run_segment(const double* x, int64_t pos,
                                          int64_t seg_end, v8df* av) {
  v8df a[LAGS];
  for (int32_t k = 0; k < LAGS; ++k) a[k] = av[k];
  for (; pos + 8 <= seg_end; pos += 8) {
    const v8df xa = *(const v8df*)(x + pos);
    for (int32_t k = 0; k < LAGS; ++k) {
      const v8df xb = *(const v8df*)(x + pos + k);
#if defined(__AVX512F__)
      a[k] = (v8df)_mm512_fmadd_pd((__m512d)xa, (__m512d)xb, (__m512d)a[k]);
#else
      a[k] = a[k] + xa * xb;
#endif
    }
  }
  for (int32_t k = 0; k < LAGS; ++k) av[k] = a[k];
  return pos;
}

// Whole-(window, channel) sweep with compile-time lag count: snapshot
// events flush once per 1024-sample segment instead of per 8-sample step.
// Events sit within `order` samples below node boundaries (multiples of
// 1024), so the backward overshoot correction stays <= order + 7 samples;
// values differ from the per-step flush only by float association, which
// the partition near-tie margin covers by ~10 orders.
template <int32_t LAGS>
static void onepass_sweep_reg(const double* x, int64_t vec_end_cap,
                              int64_t win_len, const OnepassEvent* events,
                              size_t n_events, double* pf, int64_t twoS) {
  (void)win_len;
  v8df av[LAGS];
  for (int32_t k = 0; k < LAGS; ++k) av[k] = v8splat(0.0);
  auto vec_total = [&](int32_t k) {
    return ((av[k][0] + av[k][1]) + (av[k][2] + av[k][3])) +
           ((av[k][4] + av[k][5]) + (av[k][6] + av[k][7]));
  };
  size_t ev = 0;
  int64_t pos = 0;
  while (pos + 8 <= vec_end_cap) {
    while (ev < n_events && events[ev].pos <= pos) {
      const OnepassEvent& e = events[ev++];
      double t = vec_total(e.lag);
      for (int64_t p = e.pos; p < pos; ++p) t -= x[p] * x[p + e.lag];
      pf[(size_t)e.lag * twoS + e.j] = t;
    }
    int64_t seg_end = ((pos >> 10) + 1) << 10;  // next 1024 boundary
    if (seg_end > vec_end_cap) seg_end = vec_end_cap;
    pos = onepass_run_segment<LAGS>(x, pos, seg_end, av);
    if (pos + 8 > seg_end && seg_end == vec_end_cap) break;
  }
  for (; ev < n_events; ++ev) {
    const OnepassEvent& e = events[ev];
    double t = vec_total(e.lag);
    if (e.pos >= pos) {
      for (int64_t p = pos; p < e.pos; ++p) t += x[p] * x[p + e.lag];
    } else {
      for (int64_t p = e.pos; p < pos; ++p) t -= x[p] * x[p + e.lag];
    }
    pf[(size_t)e.lag * twoS + e.j] = t;
  }
}
}  // extern "C++"

// Impl behind the two exports below. Either `data` (a materialized
// float64 (C, file_n) signal) or `ibase` (the ORIGINAL int32 signal,
// channel rows icstride elements apart, ms selecting the mid/side double
// transform) feeds the sweep; the int32 source converts each (window,
// channel) row into an L2-resident scratch with exactly convert_ms's
// float64 arithmetic — every step (x*2^-31, (l+r)/2, l-r) is EXACT in
// float64, so the sweep consumes bit-identical doubles while the
// whole-file 8-byte/sample array never materializes.
static int32_t span_autocorr_multi_onepass_impl(
    const double* data, const int32_t* ibase, int64_t icstride, int32_t ms,
    int32_t C, int64_t file_n, const int64_t* win_off,
    int32_t W, int64_t win_len, const int64_t* positions, int32_t V,
    const int64_t* spans, int32_t S, int32_t order, double* out) {
  if (S <= 0 || 2 * S > 4096 || W <= 0 || order > 32) return -1;
  if (ibase && ms && C != 2) return -1;
  (void)V;
  const int32_t lags = order + 1;
  static thread_local std::vector<double> cbuf;
  double* conv = nullptr;
  if (ibase) {
    cbuf.resize((size_t)win_len + 16);
    conv = cbuf.data();
    conv += ((64 - ((uintptr_t)conv & 63)) & 63) / sizeof(double);  // 64B-align
  }
  // phase 1: per-lag snapshot positions + per-span prefix indices (same
  // geometry logic as the per-lag variant)
  std::vector<int64_t> qpos((size_t)lags * 2 * S);
  std::vector<int32_t> nu_k(lags), sidx((size_t)lags * S), eidx((size_t)lags * S);
  typedef OnepassEvent Event;
  std::vector<Event> events;
  events.reserve((size_t)lags * 2 * S);
  for (int32_t k = 0; k < lags; ++k) {
    int64_t* qp = qpos.data() + (size_t)k * 2 * S;
    const int32_t nu = span_lag_geometry(positions, spans, S, k, qp,
                                         sidx.data() + (size_t)k * S,
                                         eidx.data() + (size_t)k * S);
    nu_k[k] = nu;
    const int64_t limit = win_len - k;
    for (int32_t j = 0; j < nu; ++j)
      events.push_back({qp[j] < limit ? qp[j] : limit, k, j});
  }
  std::sort(events.begin(), events.end(),
            [](const Event& a, const Event& b) { return a.pos < b.pos; });
  // main loop can read x[pos + 7 + (lags-1)]; beyond this cap it finishes
  // scalar per lag so no read ever passes the window end
  const int64_t vec_end_cap = win_len - 8 - (lags - 1) + 1;  // pos < cap
  std::vector<double> pf((size_t)lags * 2 * S);
  const double scale = std::ldexp(1.0, -31);  // 2^-31, exact
  for (int32_t w = 0; w < W; ++w) {
    for (int32_t ch = 0; ch < C; ++ch) {
      const double* x;
      if (ibase) {
        if (ms) {
          const int32_t* lp = ibase + win_off[w];
          const int32_t* rp = ibase + icstride + win_off[w];
          if (ch == 0)
            for (int64_t i = 0; i < win_len; ++i)
              conv[i] = ((double)lp[i] * scale + (double)rp[i] * scale) / 2.0;
          else
            for (int64_t i = 0; i < win_len; ++i)
              conv[i] = (double)lp[i] * scale - (double)rp[i] * scale;
        } else {
          const int32_t* p = ibase + (int64_t)ch * icstride + win_off[w];
          for (int64_t i = 0; i < win_len; ++i) conv[i] = (double)p[i] * scale;
        }
        x = conv;
      } else {
        x = data + (int64_t)ch * file_n + win_off[w];
      }
      // compile-time lag counts for the preset orders keep the striped
      // accumulators in registers (see onepass_run_segment)
      if (order == 16 || order == 8) {
        if (order == 16)
          onepass_sweep_reg<17>(x, vec_end_cap, win_len, events.data(),
                                events.size(), pf.data(), 2 * S);
        else
          onepass_sweep_reg<9>(x, vec_end_cap, win_len, events.data(),
                               events.size(), pf.data(), 2 * S);
        for (int32_t k = 0; k < lags; ++k) {
          const int32_t* si = sidx.data() + (size_t)k * S;
          const int32_t* ei = eidx.data() + (size_t)k * S;
          const double* pk = pf.data() + (size_t)k * 2 * S;
          double* o = out + (((int64_t)w * S) * C + ch) * lags + k;
          for (int32_t s = 0; s < S; ++s)
            o[(int64_t)s * C * lags] = pk[ei[s]] - pk[si[s]];
        }
        continue;
      }
      v8df av[33];
      for (int32_t k = 0; k < lags; ++k) av[k] = v8splat(0.0);
      size_t ev = 0;
      int64_t pos = 0;
      auto vec_total = [&](int32_t k) {
        return ((av[k][0] + av[k][1]) + (av[k][2] + av[k][3])) +
               ((av[k][4] + av[k][5]) + (av[k][6] + av[k][7]));
      };
      while (pos + 8 <= vec_end_cap) {
        // flush every event at or before the current aligned position:
        // striped vector total minus the < 8-sample overshoot
        while (ev < events.size() && events[ev].pos <= pos) {
          const Event& e = events[ev++];
          double t = vec_total(e.lag);
          for (int64_t p = e.pos; p < pos; ++p) t -= x[p] * x[p + e.lag];
          pf[(size_t)e.lag * 2 * S + e.j] = t;
        }
        const v8df xa = *(const v8df*)(x + pos);
        for (int32_t k = 0; k < lags; ++k) {
          const v8df xb = *(const v8df*)(x + pos + k);
#if defined(__AVX512F__)
          av[k] = (v8df)_mm512_fmadd_pd((__m512d)xa, (__m512d)xb, (__m512d)av[k]);
#else
          av[k] = av[k] + xa * xb;
#endif
        }
        pos += 8;
      }
      // remaining events sit past the vector cap (or behind the final
      // position): vector total plus a scalar run from `pos`
      for (; ev < events.size(); ++ev) {
        const Event& e = events[ev];
        double t = vec_total(e.lag);
        if (e.pos >= pos) {
          for (int64_t p = pos; p < e.pos; ++p) t += x[p] * x[p + e.lag];
        } else {
          for (int64_t p = e.pos; p < pos; ++p) t -= x[p] * x[p + e.lag];
        }
        pf[(size_t)e.lag * 2 * S + e.j] = t;
      }
      for (int32_t k = 0; k < lags; ++k) {
        const int32_t* si = sidx.data() + (size_t)k * S;
        const int32_t* ei = eidx.data() + (size_t)k * S;
        const double* pk = pf.data() + (size_t)k * 2 * S;
        double* o = out + (((int64_t)w * S) * C + ch) * lags + k;
        for (int32_t s = 0; s < S; ++s)
          o[(int64_t)s * C * lags] = pk[ei[s]] - pk[si[s]];
      }
    }
  }
  return 0;
}

int32_t sla_span_autocorr_multi_onepass(
    const double* data, int32_t C, int64_t file_n, const int64_t* win_off,
    int32_t W, int64_t win_len, const int64_t* positions, int32_t V,
    const int64_t* spans, int32_t S, int32_t order, double* out) {
  return span_autocorr_multi_onepass_impl(
      data, nullptr, 0, 0, C, file_n, win_off, W, win_len, positions, V,
      spans, S, order, out);
}

// int32-source export: base = the original (C, N) canonical int32 signal
// (rows cstride elements apart), ms selects the mid/side double transform.
int32_t sla_span_autocorr_multi_onepass_i32(
    const int32_t* base, int64_t cstride, int32_t ms, int32_t C,
    const int64_t* win_off, int32_t W, int64_t win_len,
    const int64_t* positions, int32_t V, const int64_t* spans, int32_t S,
    int32_t order, double* out) {
  return span_autocorr_multi_onepass_impl(
      nullptr, base, cstride, ms, C, 0, win_off, W, win_len, positions, V,
      spans, S, order, out);
}

// KEEP IN SYNC with span_autocorr_multi_impl: this single-window entry is
// the W=1/win_off=0/win_len=N special case of the multi variant and forks
// the same span-geometry + prefix-product machinery (see the 'must never
// fork' note there) — any boundary/association change must land in both.
int32_t sla_span_autocorr(const double* data, int32_t C, int32_t N,
                          const int64_t* positions, int32_t V,
                          const int64_t* spans, int32_t S, int32_t order,
                          double* out) {
  (void)V;  // geometry arg kept for ABI symmetry with the multi variants
  if (S <= 0 || 2 * S > 4096) return -1;  // scratch capacity bound
  const int32_t lags = order + 1;
  // scratch: query positions, span prefix indices, prefix values per lag
  int64_t qpos[4096];
  int32_t sidx[2048], eidx[2048];
  double pf[4096];  // prefix values, reused per channel
  for (int32_t k = 0; k < lags; ++k) {
    const int32_t nu = span_lag_geometry(positions, spans, S, k, qpos, sidx, eidx);
    const int64_t limit = N - k;
    for (int32_t ch = 0; ch < C; ++ch) {
      const double* x = data + (int64_t)ch * N;
      // pf[j] = sum of products over [0, qpos[j])
      double acc = 0.0;
      int64_t pos = 0;
      for (int32_t j = 0; j < nu; ++j) {
        int64_t q = qpos[j] < limit ? qpos[j] : limit;
        // 8-wide vector accumulator with a fixed pairwise reduction (this
        // estimator is not reference-exact arithmetic — near-ties fall
        // back to the exact cost model upstream; fuzz-validated)
        {
          v8df av = v8splat(0.0);
          for (; pos + 8 <= q; pos += 8) {
            v8df xa = *(const v8df*)(x + pos);
            v8df xb = *(const v8df*)(x + pos + k);
            av = av + xa * xb;
          }
          acc += ((av[0] + av[1]) + (av[2] + av[3])) +
                 ((av[4] + av[5]) + (av[6] + av[7]));
          for (; pos < q; ++pos) acc += x[pos] * x[pos + k];
        }
        pf[j] = acc;
      }
      for (int32_t s = 0; s < S; ++s) {
        out[((int64_t)s * C + ch) * lags + k] = pf[eidx[s]] - pf[sidx[s]];
      }
    }
  }
  return 0;
}

// Dijkstra span costs for the partition fast path: per (span, channel) a
// Levinson-Durbin recursion on the prefix-estimated autocorrelation plus
// the Laplace code-length estimate, summed over channels. Mirrors the
// NumPy fast path in analysis/partition.py (NOT the reference-exact
// arithmetic — near-ties fall back to exact pricing upstream).
// R: S x C x (order+1) row-major; span_len: S; out: S (code bytes, before
// the header/penalty constants).
// out: S costs. sens_out/e_out (nullable, Q = S*C each): ingredients for
#if defined(__AVX512F__)
// 8x8 float64 in-register transpose (same rationale as tile_transpose16
// below: lane-filling vectors with scalar inserts stalls on store
// forwarding; 8 loads + 24 shuffles do not).
static inline void transpose8d(__m512d m[8]) {
  __m512d t[8], u[8];
  for (int i = 0; i < 4; ++i) {
    t[2 * i] = _mm512_unpacklo_pd(m[2 * i], m[2 * i + 1]);
    t[2 * i + 1] = _mm512_unpackhi_pd(m[2 * i], m[2 * i + 1]);
  }
  for (int h = 0; h < 2; ++h) {
    u[4 * h + 0] = _mm512_shuffle_f64x2(t[4 * h + 0], t[4 * h + 2], 0x88);
    u[4 * h + 1] = _mm512_shuffle_f64x2(t[4 * h + 1], t[4 * h + 3], 0x88);
    u[4 * h + 2] = _mm512_shuffle_f64x2(t[4 * h + 0], t[4 * h + 2], 0xdd);
    u[4 * h + 3] = _mm512_shuffle_f64x2(t[4 * h + 1], t[4 * h + 3], 0xdd);
  }
  for (int j = 0; j < 4; ++j) {
    m[j] = _mm512_shuffle_f64x2(u[j], u[4 + j], 0x88);
    m[4 + j] = _mm512_shuffle_f64x2(u[j], u[4 + j], 0xdd);
  }
}

// Load 8 consecutive rows of a (rows, lags) float64 matrix into column
// vectors col[0..lags): 8-column transposed tiles + a scalar remainder.
static inline void rows8_load_cols(const double* base, int64_t lags,
                                   v8df* col) {
  int64_t c = 0;
  for (; c + 8 <= lags; c += 8) {
    __m512d m[8];
    for (int l = 0; l < 8; ++l) m[l] = _mm512_loadu_pd(base + l * lags + c);
    transpose8d(m);
    for (int j = 0; j < 8; ++j) col[c + j] = (v8df)m[j];
  }
  for (; c < lags; ++c)
    for (int l = 0; l < 8; ++l) col[c][l] = base[l * lags + c];
}

// Transposed store of column vectors back into 8 consecutive rows.
static inline void rows8_store_cols(double* base, int64_t lags,
                                    const v8df* col) {
  int64_t c = 0;
  for (; c + 8 <= lags; c += 8) {
    __m512d m[8];
    for (int j = 0; j < 8; ++j) m[j] = (__m512d)col[c + j];
    transpose8d(m);
    for (int l = 0; l < 8; ++l) _mm512_storeu_pd(base + l * lags + c, m[l]);
  }
  for (; c < lags; ++c)
    for (int l = 0; l < 8; ++l) base[l * lags + c] = col[c][l];
}
#endif

// the derived fast-vs-exact error bound (partition.span_cost_error_bound)
// — sens = ||a (*) a||_1 / e_p (envelope-theorem cost gradient scale) and
// e_p = R0 * prod(1-k^2), per (span, channel).
int32_t sla_span_cost(const double* R, const double* span_len, int32_t S,
                      int32_t C, int32_t order, int32_t bits_per_sample,
                      double* out, double* sens_out, double* e_out) {
  if (order < 1 || order > 64) return -1;  // scratch capacity bound
  const double kFltEps = 1.1920928955078125e-07;  // FLT_EPSILON
  const double kFltMin = 1.1754943508222875e-38;  // FLT_MIN
  const double kBeta = 1.9426950408889634;        // sqrt(2 e^2)
  const double pow_scale = std::ldexp(1.0, 2 * (bits_per_sample - 1));
  // The O(p^2) Levinson-Durbin recursions run eight (span, channel) pairs
  // per vector op (independent lanes, identical per-lane op order — the
  // results match the scalar loop bit for bit; dead lanes compute garbage
  // that the epilogue's live check discards). Pair q = s*C + ch.
  const int64_t Q = (int64_t)S * C;
  static thread_local std::vector<double> kbuf;
  kbuf.resize((size_t)Q * (order + 1));
  double* kall = kbuf.data();  // parcor per pair, zeros when dead
  std::memset(kall, 0, sizeof(double) * (size_t)Q * (order + 1));
  {
    int64_t q0 = 0;
    for (; q0 + 8 <= Q; q0 += 8) {
      v8df r[65];
#if defined(__AVX512F__)
      rows8_load_cols(R + q0 * (order + 1), order + 1, r);
#else
      for (int32_t i = 0; i <= order; ++i)
        for (int32_t l = 0; l < 8; ++l)
          r[i][l] = R[(q0 + l) * (order + 1) + i];
#endif
      const v8df R0 = r[0];
      v8df e = R0 + r[1] * (v8splat(0.0) - r[1] / R0);
      v8df a[65], anew[65], k[65];
      a[1] = v8splat(0.0) - r[1] / R0;
      k[1] = r[1] / R0;
      for (int32_t delay = 1; delay < order; ++delay) {
        // same summation order as the scalar loop (i = 0 first, a[0] == 1)
        v8df gamma = r[delay + 1];
        for (int32_t i = 1; i <= delay; ++i) gamma = gamma + a[i] * r[delay + 1 - i];
        v8df denom;
        for (int32_t l = 0; l < 8; ++l)
          denom[l] = std::fabs(e[l]) > 0.0 ? e[l] : 1.0;
        gamma = (v8splat(0.0) - gamma) / denom;
        e = (v8splat(1.0) - gamma * gamma) * e;
        for (int32_t i = 1; i <= delay; ++i)
          anew[i] = a[i] + gamma * a[delay + 1 - i];
        for (int32_t i = 1; i <= delay; ++i) a[i] = anew[i];
        a[delay + 1] = gamma;
        k[delay + 1] = v8splat(0.0) - gamma;
      }
#if defined(__AVX512F__)
      {
        __mmask8 live = 0;
        for (int32_t l = 0; l < 8; ++l) {
          const double n_sp = span_len[(q0 + l) / C];
          if (std::fabs(r[0][l]) >= kFltEps && n_sp >= order)
            live |= (__mmask8)(1u << l);
        }
        k[0] = v8splat(0.0);
        for (int32_t i = 1; i <= order; ++i)
          k[i] = (v8df)_mm512_maskz_mov_pd(live, (__m512d)k[i]);
        rows8_store_cols(kall + q0 * (order + 1), order + 1, k);
      }
#else
      for (int32_t l = 0; l < 8; ++l) {
        const double n_sp = span_len[(q0 + l) / C];
        const bool live = std::fabs(r[0][l]) >= kFltEps && n_sp >= order;
        if (live)
          for (int32_t i = 1; i <= order; ++i)
            kall[(q0 + l) * (order + 1) + i] = k[i][l];
      }
#endif
    }
    // scalar tail
    double a[65];
    for (; q0 < Q; ++q0) {
      const double* r = R + q0 * (order + 1);
      double* kp = kall + q0 * (order + 1);
      const double n_sp = span_len[q0 / C];
      if (!(std::fabs(r[0]) >= kFltEps && n_sp >= order)) continue;
      const double R0 = r[0];
      double e = R0 + r[1] * (-r[1] / R0);
      a[0] = 1.0;
      a[1] = -r[1] / R0;
      kp[1] = r[1] / R0;
      double anew[65];
      for (int32_t delay = 1; delay < order; ++delay) {
        double gamma = 0.0;
        for (int32_t i = 0; i <= delay; ++i) gamma += a[i] * r[delay + 1 - i];
        gamma /= -(std::fabs(e) > 0.0 ? e : 1.0);
        e = (1.0 - gamma * gamma) * e;
        for (int32_t i = 1; i <= delay; ++i)
          anew[i] = a[i] + gamma * a[delay + 1 - i];
        for (int32_t i = 1; i <= delay; ++i) a[i] = anew[i];
        a[delay + 1] = gamma;
        kp[delay + 1] = -gamma;
      }
    }
  }
  for (int32_t s = 0; s < S; ++s) {
    double cost = 0.0;
    const double n_sp = span_len[s];
    for (int32_t ch = 0; ch < C; ++ch) {
      const double* r = R + ((int64_t)s * C + ch) * (order + 1);
      const double* parcor = kall + ((int64_t)s * C + ch) * (order + 1);
      // code length per sample (bytes). One log2 of the product replaces
      // order+2 log2 calls (this is the fast estimator, not the
      // reference-exact cost: the ~1e-14 association difference is 13
      // orders below the near-tie guard's 0.25-byte exact-reprice margin;
      // an underflowing product gives -inf -> the same 1/8 clamp the very
      // negative log-sum would hit).
      const double power = r[0] * pow_scale;
      if (std::fabs(power) <= kFltMin) continue;  // silent -> 0 bytes
      double var_prod = 1.0;
      for (int32_t i = 1; i <= order; ++i) {
        double one_minus = 1.0 - parcor[i] * parcor[i];
        var_prod *= (one_minus > 1e-300 ? one_minus : 1e-300);
      }
      double length =
          (kBeta + 0.5 * std::log2(power * var_prod / n_sp)) / 8.0;
      if (length <= 0.0) length = 1.0 / 8.0;
      cost += n_sp * length;
    }
    out[s] = cost;
  }
  if (sens_out && e_out) {
    int64_t q = 0;
#if defined(__AVX512F__)
    // 8 pairs per vector op, same recurrences as the scalar loop below
    // (dead lanes read the zeros the epilogue stored: a = [1,0..], the
    // exact values the scalar pass computes for them)
    for (; q + 8 <= (int64_t)S * C; q += 8) {
      v8df kv[65];
      rows8_load_cols(kall + q * (order + 1), order + 1, kv);
      v8df a[65], an[65];
      a[0] = v8splat(1.0);
      v8df var_prod = v8splat(1.0);
      for (int32_t j = 1; j <= order; ++j) {
        const v8df gamma = v8splat(0.0) - kv[j];
        for (int32_t i = 1; i < j; ++i) an[i] = a[i] + gamma * a[j - i];
        for (int32_t i = 1; i < j; ++i) a[i] = an[i];
        a[j] = gamma;
        v8df om = v8splat(1.0) - kv[j] * kv[j];
        om = (v8df)_mm512_max_pd((__m512d)om, (__m512d)v8splat(1e-300));
        var_prod = var_prod * om;
      }
      v8df corr = v8splat(0.0);
      for (int32_t i = 0; i <= order; ++i) corr = corr + a[i] * a[i];
      for (int32_t lag = 1; lag <= order; ++lag) {
        v8df c2 = v8splat(0.0);
        for (int32_t i = 0; i + lag <= order; ++i)
          c2 = c2 + a[i] * a[i + lag];
        corr = corr + v8splat(2.0) * (v8df)_mm512_abs_pd((__m512d)c2);
      }
      v8df r0v;
      for (int32_t l = 0; l < 8; ++l) r0v[l] = R[(q + l) * (order + 1)];
      const v8df e_p = (v8df)_mm512_abs_pd((__m512d)r0v) * var_prod;
      const v8df denom =
          (v8df)_mm512_max_pd((__m512d)e_p, (__m512d)v8splat(1e-300));
      _mm512_storeu_pd(e_out + q, (__m512d)e_p);
      _mm512_storeu_pd(sens_out + q, (__m512d)(corr / denom));
    }
#endif
    for (; q < (int64_t)S * C; ++q) {
      const double* r = R + q * (order + 1);
      const double* parcor = kall + q * (order + 1);
      // step-up recursion: rebuild the predictor a from the parcor ks
      // (feeds a first-order error BOUND — op order is not identity-
      // critical here, unlike everything above)
      double a[65], an[65];
      a[0] = 1.0;
      double var_prod = 1.0;
      for (int32_t j = 1; j <= order; ++j) {
        const double gamma = -parcor[j];
        for (int32_t i = 1; i < j; ++i) an[i] = a[i] + gamma * a[j - i];
        for (int32_t i = 1; i < j; ++i) a[i] = an[i];
        a[j] = gamma;
        double om = 1.0 - parcor[j] * parcor[j];
        var_prod *= (om > 1e-300 ? om : 1e-300);
      }
      double corr_l1 = 0.0;
      for (int32_t i = 0; i <= order; ++i) corr_l1 += a[i] * a[i];
      for (int32_t lag = 1; lag <= order; ++lag) {
        double c2 = 0.0;
        for (int32_t i = 0; i + lag <= order; ++i) c2 += a[i] * a[i + lag];
        corr_l1 += 2.0 * std::fabs(c2);
      }
      const double e_p = std::fabs(r[0]) * var_prod;
      e_out[q] = e_p;
      sens_out[q] = corr_l1 / (e_p > 1e-300 ? e_p : 1e-300);
    }
  }
  return 0;
}

// Whole-block serialization (SLAEncoder_EncodeBlock framing,
// SLAEncoder.c:682-795): sync + placeholders + per-channel coefficient
// fields, byte-align, payload (recursive-Rice / raw / none), byte-align,
// then back-patch the next-block offset and CRC16 (calc from byte 8).
// block_type: 0 compress / 1 silent / 2 raw. residual: C x n row-major —
// the final residual for compress, the raw int32 samples for raw.
// raw_bits: per-channel raw bit widths (raw only). Returns bytes written,
// or -1 on overflow / capacity violation.
static int64_t encode_block_core(
    int32_t num_samples, int32_t block_type, int32_t C, int32_t parcor_order,
    int32_t num_taps, int32_t bits_per_sample, int32_t pitch_threshold,
    const int32_t* parcor_code /* C x (p+1) */,
    const int32_t* parcor_rshift /* C */, const int32_t* pitch /* C */,
    const int32_t* ltm_coef /* C x max(T,1) */, const uint32_t* init_rice,
    const int32_t* residual /* C rows */, int64_t row_stride,
    const int32_t* raw_bits /* C, raw only */, uint8_t* out, int64_t cap,
    // pre-encoded byte-aligned payload (vectorized lane encoder output);
    // when set, the COMPRESSDATA payload is appended verbatim
    const uint8_t* vpayload = nullptr, int64_t vpayload_len = 0) {
  if (C <= 0 || C > 64) return -2;  // scratch capacity, not an overflow
  BitWriter w;
  w.init(out, cap);
  w.put(0xFFFF, 16);
  w.put(0, 32);  // next-block offset placeholder
  w.put(0, 16);  // CRC16 placeholder
  w.put((uint32_t)num_samples, 16);
  w.put((uint32_t)block_type, 2);
  if (block_type == 0) {  // COMPRESSDATA: per-channel coefficient fields
    for (int32_t ch = 0; ch < C; ++ch) {
      w.put((uint32_t)parcor_rshift[ch], 4);
      for (int32_t ord = 1; ord <= parcor_order; ++ord) {
        int bits = (ord < 4) ? 16 : 8;  // SLA_GET_PARCOR_QUANTIZE_BIT_WIDTH
        w.put(zigzag(parcor_code[(int64_t)ch * (parcor_order + 1) + ord]), bits);
      }
      if (pitch[ch] >= pitch_threshold) {
        w.put(1, 1);
        w.put((uint32_t)pitch[ch], 10);
        for (int32_t t = 0; t < num_taps; ++t)
          w.put(zigzag(ltm_coef[(int64_t)ch * (num_taps > 0 ? num_taps : 1) + t] >> 16), 16);
      } else {
        w.put(0, 1);
      }
      w.put(param_get(param_set_fixed(init_rice[ch])), bits_per_sample);
    }
  }
  w.flush();
  if (block_type == 0 && vpayload != nullptr) {
    if (w.nbytes + vpayload_len > cap) return -1;
    std::memcpy(out + w.nbytes, vpayload, (size_t)vpayload_len);
    w.nbytes += vpayload_len;
  } else if (block_type == 0) {
    // KEEP IN SYNC with sla_put_data_array's payload body above: this is
    // the same adaptive/golomb emission inlined so the block writer keeps
    // one BitWriter across header + payload. Any change to the escape,
    // pair-fusing, or golomb logic must land in BOTH places (a divergence
    // silently splits the -V self-check path from the normal path).
    uint64_t eff_sum = 0;
    uint32_t eff[64];
    for (int32_t ch = 0; ch < C; ++ch) {
      eff[ch] = param_get(param_set_fixed(init_rice[ch]));
      eff_sum += eff[ch];
    }
    if (eff_sum / (uint32_t)C > kLowThreshold) {
      RiceState st[64];
      for (int32_t ch = 0; ch < C; ++ch) st[ch].init(init_rice[ch]);
      if (C == 2) {
        const int32_t* d0 = residual;
        const int32_t* d1 = residual + row_stride;
        const uint32_t *z0, *z1;
        stage_zigzag_stereo(d0, d1, num_samples, &z0, &z1);
        for (int32_t s = 0; s < num_samples; ++s)
          put_rice_pair(w, st[0], st[1], z0[s], z1[s]);
      } else {
        for (int32_t s = 0; s < num_samples; ++s) {
          int32_t ch = 0;
          for (; ch + 2 <= C; ch += 2)
            put_rice_pair(w, st[ch], st[ch + 1],
                          zigzag(residual[(int64_t)ch * row_stride + s]),
                          zigzag(residual[(int64_t)(ch + 1) * row_stride + s]));
          if (ch < C)
            put_recursive_rice(w, st[ch],
                               zigzag(residual[(int64_t)ch * row_stride + s]));
        }
      }
    } else {
      for (int32_t s = 0; s < num_samples; ++s)
        for (int32_t ch = 0; ch < C; ++ch)
          put_golomb(w, eff[ch], zigzag(residual[(int64_t)ch * row_stride + s]));
    }
  } else if (block_type == 2) {  // RAWDATA
    for (int32_t s = 0; s < num_samples; ++s)
      for (int32_t ch = 0; ch < C; ++ch)
        w.put(zigzag(residual[(int64_t)ch * row_stride + s]), raw_bits[ch]);
  }
  w.flush();
  if (w.fatal) return -3;  // pathological static-Golomb run
  if (w.overflow) return -1;
  int64_t size = w.nbytes;
  // back-patch next-block offset (bytes 2..5) and CRC16 (bytes 6..7)
  uint32_t next_off = (uint32_t)(size - 6);
  out[2] = (uint8_t)(next_off >> 24);
  out[3] = (uint8_t)(next_off >> 16);
  out[4] = (uint8_t)(next_off >> 8);
  out[5] = (uint8_t)next_off;
  uint16_t crc = sla_crc16(out + 8, size - 8);
  out[6] = (uint8_t)(crc >> 8);
  out[7] = (uint8_t)crc;
  return size;
}

int64_t sla_encode_block(int32_t num_samples, int32_t block_type, int32_t C,
                         int32_t parcor_order, int32_t num_taps,
                         int32_t bits_per_sample, int32_t pitch_threshold,
                         const int32_t* parcor_code, const int32_t* parcor_rshift,
                         const int32_t* pitch, const int32_t* ltm_coef,
                         const uint32_t* init_rice, const int32_t* residual,
                         const int32_t* raw_bits, uint8_t* out, int64_t cap) {
  return encode_block_core(num_samples, block_type, C, parcor_order, num_taps,
                           bits_per_sample, pitch_threshold, parcor_code,
                           parcor_rshift, pitch, ltm_coef, init_rice, residual,
                           num_samples, raw_bits, out, cap);
}

// Serialize EVERY block of a stream in one call: blocks write back to back
// (each is byte-aligned) into `out`, per-block byte sizes land in
// sizes_out. Residual rows come as per-block base pointers + row strides
// (views into the batch filter output — no gather copies). Returns total
// bytes, -1 on out-capacity overflow (caller grows and retries), -2 on a
// scratch bound violation.
// Serialize blocks [b0, b1) back to back into `out` (capacity `cap`).
// A pre-pass runs every eligible adaptive COMPRESSDATA block's payload
// through the 8-lane vector coder in SIZE-SORTED groups of eight (the
// vector loop runs to the group minimum, so near-equal lane lengths keep
// it off the scalar finish path; payload bytes are identical either way
// and blocks are independent, so grouping order cannot change the
// stream). Framing then walks [b0, b1) in block order, splicing the
// prebuilt payloads. Returns bytes written or the encode_block_core
// error codes.
static int64_t encode_block_run(
    int32_t b0, int32_t b1, int32_t C, int32_t parcor_order, int32_t num_taps,
    int32_t bits_per_sample, int32_t pitch_threshold, const int32_t* nsamp,
    const int32_t* btype, const int32_t* parcor_code,
    const int32_t* parcor_rshift, const int32_t* pitch,
    const int32_t* ltm_coef, const uint32_t* init_rice,
    const uint64_t* res_ptrs, const int64_t* res_strides,
    const int32_t* raw_bits, uint8_t* out, int64_t cap, int64_t* sizes_out) {
  const int32_t pc = parcor_order + 1;
  const int32_t mt = num_taps > 0 ? num_taps : 1;
  const int32_t R = b1 - b0;
  // per-block prebuilt payload (offset into arena, size); -1 = none
  std::vector<int64_t> poff, psz;
#if defined(SLA_HAVE_VDEC8)
  static thread_local std::vector<uint8_t> arena;
  if (C >= 1 && C <= 8 && R >= 8) {
    std::vector<int32_t> elig;
    elig.reserve((size_t)R);
    for (int32_t b = b0; b < b1; ++b)
      if (btype[b] == 0 && nsamp[b] > 0 &&
          rice_adaptive(init_rice + (int64_t)b * C, C))
        elig.push_back(b);
    if ((int32_t)elig.size() >= 8) {
      std::stable_sort(elig.begin(), elig.end(), [&](int32_t a, int32_t b) {
        return nsamp[a] > nsamp[b];
      });
      poff.assign((size_t)R, -1);
      psz.assign((size_t)R, 0);
      static thread_local std::vector<uint8_t> pool;
      int64_t arena_used = 0;
      for (size_t g = 0; g + 8 <= elig.size(); g += 8) {
        const int32_t* grp = elig.data() + g;
        const int32_t nmax = nsamp[grp[0]];  // sorted descending
        const int64_t lane_cap = 16LL * nmax * C + 1024;
        if ((int64_t)pool.size() < 8 * lane_cap)
          pool.resize((size_t)(8 * lane_cap));
        const int32_t* dptr[64];
        uint8_t* bufs[8];
        int32_t nn8[8];
        uint32_t ini8[64];
        for (int l = 0; l < 8; ++l) {
          const int32_t blk = grp[l];
          bufs[l] = pool.data() + (size_t)l * lane_cap;
          nn8[l] = nsamp[blk];
          const int32_t* base = (const int32_t*)(uintptr_t)res_ptrs[blk];
          for (int ch = 0; ch < C; ++ch) {
            dptr[l * C + ch] = base + (int64_t)ch * res_strides[blk];
            ini8[l * C + ch] = init_rice[(int64_t)blk * C + ch];
          }
        }
        int64_t ps[8];
        int32_t rc = -1;
        switch (C) {
          case 1: rc = encode_payloads_v8<1>(dptr, nn8, ini8, bufs, lane_cap, ps); break;
          case 2: rc = encode_payloads_v8<2>(dptr, nn8, ini8, bufs, lane_cap, ps); break;
          case 3: rc = encode_payloads_v8<3>(dptr, nn8, ini8, bufs, lane_cap, ps); break;
          case 4: rc = encode_payloads_v8<4>(dptr, nn8, ini8, bufs, lane_cap, ps); break;
          case 5: rc = encode_payloads_v8<5>(dptr, nn8, ini8, bufs, lane_cap, ps); break;
          case 6: rc = encode_payloads_v8<6>(dptr, nn8, ini8, bufs, lane_cap, ps); break;
          case 7: rc = encode_payloads_v8<7>(dptr, nn8, ini8, bufs, lane_cap, ps); break;
          case 8: rc = encode_payloads_v8<8>(dptr, nn8, ini8, bufs, lane_cap, ps); break;
        }
        if (rc != 0) continue;  // lane cap hit: these frame via scalar path
        int64_t add = 0;
        for (int l = 0; l < 8; ++l) add += ps[l];
        if ((int64_t)arena.size() < arena_used + add)
          arena.resize((size_t)(arena_used + add + (arena_used + add) / 2));
        for (int l = 0; l < 8; ++l) {
          std::memcpy(arena.data() + arena_used, bufs[l], (size_t)ps[l]);
          poff[(size_t)(grp[l] - b0)] = arena_used;
          psz[(size_t)(grp[l] - b0)] = ps[l];
          arena_used += ps[l];
        }
      }
      // (the arena may reallocate while growing, so blocks record offsets;
      // the framing loop resolves pointers after the last insertion)
    }
  }
#endif
  int64_t pos = 0;
  for (int32_t b = b0; b < b1; ++b) {
    const uint8_t* vp = nullptr;
    int64_t vl = 0;
#if defined(SLA_HAVE_VDEC8)
    if (!poff.empty() && poff[(size_t)(b - b0)] >= 0) {
      vp = arena.data() + poff[(size_t)(b - b0)];
      vl = psz[(size_t)(b - b0)];
    }
#endif
    int64_t nby;
    if (vl > 0) {
      nby = encode_block_core(
          nsamp[b], 0, C, parcor_order, num_taps, bits_per_sample,
          pitch_threshold, parcor_code + (int64_t)b * C * pc,
          parcor_rshift + (int64_t)b * C, pitch + (int64_t)b * C,
          ltm_coef + (int64_t)b * C * mt, init_rice + (int64_t)b * C,
          (const int32_t*)(uintptr_t)res_ptrs[b], res_strides[b], raw_bits,
          out + pos, cap - pos, vp, vl);
    } else {
      nby = encode_block_core(
          nsamp[b], btype[b], C, parcor_order, num_taps, bits_per_sample,
          pitch_threshold, parcor_code + (int64_t)b * C * pc,
          parcor_rshift + (int64_t)b * C, pitch + (int64_t)b * C,
          ltm_coef + (int64_t)b * C * mt, init_rice + (int64_t)b * C,
          (const int32_t*)(uintptr_t)res_ptrs[b], res_strides[b], raw_bits,
          out + pos, cap - pos);
    }
    if (nby < 0) return nby;
    sizes_out[b] = nby;
    pos += nby;
  }
  return pos;
}

int64_t sla_encode_blocks(int32_t W, int32_t C, int32_t parcor_order,
                          int32_t num_taps, int32_t bits_per_sample,
                          int32_t pitch_threshold, const int32_t* nsamp,
                          const int32_t* btype,
                          const int32_t* parcor_code /* W x C x (p+1) */,
                          const int32_t* parcor_rshift /* W x C */,
                          const int32_t* pitch /* W x C */,
                          const int32_t* ltm_coef /* W x C x max(T,1) */,
                          const uint32_t* init_rice /* W x C */,
                          const uint64_t* res_ptrs /* W */,
                          const int64_t* res_strides /* W */,
                          const int32_t* raw_bits /* C */, uint8_t* out,
                          int64_t cap, int64_t* sizes_out) {
  if (C <= 0 || C > 64) return -2;
  const int32_t pc = parcor_order + 1;
  const int32_t mt = num_taps > 0 ? num_taps : 1;
  const int T = entropy_threads();
  if (T > 1 && W >= 2 * T) {
    // block-parallel serialization: blocks are independent and
    // byte-aligned, so threads serialize disjoint ranges into pooled
    // buffers which then concatenate in block order (identical bytes to
    // the serial loop). CRC tables initialize before spawning. Buffers
    // come from a process-wide pool (mutex-guarded) so repeated calls
    // reuse pages instead of first-touching fresh ones, and the
    // per-thread budget scales with the caller's `cap` so its
    // grow-and-retry contract still terminates on pathological blocks.
    if (!crc16_init_done) crc16_init();
    static std::mutex pool_mu;
    static std::vector<std::vector<uint8_t>> pool;
    int64_t base_total = 0;
    for (int32_t b = 0; b < W; ++b)
      base_total += 2LL * 4 * C * nsamp[b] + 4096;
    const double scale =
        base_total > 0 && cap > base_total ? (double)cap / base_total : 1.0;
    std::vector<std::vector<uint8_t>> bufs(T);
    {
      std::lock_guard<std::mutex> g(pool_mu);
      for (int t = 0; t < T && !pool.empty(); ++t) {
        bufs[t] = std::move(pool.back());
        pool.pop_back();
      }
    }
    std::vector<int64_t> used(T, 0);
    std::atomic<int64_t> err{0};
    std::vector<std::thread> workers;
    // split by cumulative SAMPLES, not block count: partitioned streams
    // mix 2048..16384-sample blocks, and an equal block-count split can
    // hand one thread ~8x the work (same reasoning as the decode split
    // in sla_get_data_arrays)
    std::vector<int32_t> tsplit(T + 1, 0);
    {
      int64_t total_ns = 0;
      for (int32_t b = 0; b < W; ++b) total_ns += nsamp[b];
      int64_t acc_ns = 0;
      int32_t b = 0;
      for (int t = 1; t < T; ++t) {
        const int64_t want = total_ns * t / T;
        while (b < W && acc_ns < want) acc_ns += nsamp[b++];
        tsplit[t] = b;
      }
      tsplit[T] = W;
    }
    for (int t = 0; t < T; ++t) {
      const int32_t b0 = tsplit[t];
      const int32_t b1 = tsplit[t + 1];
      workers.emplace_back([&, t, b0, b1]() {
        try {
          int64_t local_cap = 64;
          for (int32_t b = b0; b < b1; ++b)
            local_cap += (int64_t)((2LL * 4 * C * nsamp[b] + 4096) * scale);
          if ((int64_t)bufs[t].size() < local_cap)
            bufs[t].resize((size_t)local_cap);
          const int64_t pos = encode_block_run(
              b0, b1, C, parcor_order, num_taps, bits_per_sample,
              pitch_threshold, nsamp, btype, parcor_code, parcor_rshift,
              pitch, ltm_coef, init_rice, res_ptrs, res_strides, raw_bits,
              bufs[t].data(), local_cap, sizes_out);
          if (pos < 0) { err.store(pos); return; }
          used[t] = pos;
        } catch (...) {
          err.store(-1);  // allocation failure -> caller grows and retries
        }
      });
    }
    for (auto& th : workers) th.join();
    int64_t e = err.load();
    int64_t pos = 0;
    if (!e) {
      for (int t = 0; t < T; ++t) {
        if (pos + used[t] > cap) { e = -1; break; }
        std::memcpy(out + pos, bufs[t].data(), (size_t)used[t]);
        pos += used[t];
      }
    }
    {
      std::lock_guard<std::mutex> g(pool_mu);
      for (int t = 0; t < T && pool.size() < 16; ++t)
        pool.push_back(std::move(bufs[t]));
    }
    return e ? e : pos;
  }
  return encode_block_run(0, W, C, parcor_order, num_taps, bits_per_sample,
                          pitch_threshold, nsamp, btype, parcor_code,
                          parcor_rshift, pitch, ltm_coef, init_rice, res_ptrs,
                          res_strides, raw_bits, out, cap, sizes_out);
}

// Partition decisions for many windows at once: adjacency assembly from
// the fast span costs, Dijkstra with the reference's exact iteration order
// and tie-breaking (SLAPredictor.c:1521-1581), and the off-path slack
// guard (DAG DP) that flags windows whose decision rests on a near-tie.
// costs: concatenated edge costs; spans: S_total x 2 node pairs;
// span_counts / num_nodes: per window (V <= 32). hops_out: W x 32
// node-deltas, -1 terminated. needs_exact[w] = 1 when the smallest
// alternative-path slack is below tie_eps. Returns 0, or -1 on a
// capacity violation.
int32_t sla_partition_solve(const double* costs, const int64_t* spans,
                            const int32_t* span_counts, const int32_t* num_nodes,
                            int32_t num_windows, double tie_eps,
                            int32_t* hops_out, int32_t* needs_exact) {
  const double kBig = (double)(1 << 24);
  enum { VMAX = 32 };
  int64_t consumed = 0;
  for (int32_t w = 0; w < num_windows; ++w) {
    const int32_t V = num_nodes[w];
    const int32_t S = span_counts[w];
    if (V < 2 || V > VMAX) return -1;
    double adj[VMAX][VMAX];
    for (int32_t i = 0; i < V; ++i)
      for (int32_t j = 0; j < V; ++j) adj[i][j] = kBig;
    for (int32_t s = 0; s < S; ++s) {
      int64_t i = spans[2 * (consumed + s)], j = spans[2 * (consumed + s) + 1];
      if (i < 0 || j < 0 || i >= V || j >= V) return -1;
      adj[i][j] = costs[consumed + s];
    }
    consumed += S;

    // Dijkstra with the reference's iteration order: lowest-index minimum
    // wins ties, relaxation uses strict > (matches dijkstra_partition)
    bool used[VMAX] = {false};
    double cost[VMAX];
    int32_t path[VMAX];
    for (int32_t i = 0; i < V; ++i) { cost[i] = kBig; path[i] = -1; }
    cost[0] = 0.0;
    const int32_t goal = V - 1;
    for (;;) {
      int32_t target = 0;
      double best = kBig;
      for (int32_t i = 0; i < V; ++i)
        if (!used[i] && cost[i] < best) { best = cost[i]; target = i; }
      if (best >= kBig) return -3;  // unreachable goal: degenerate geometry
      if (target == goal) break;
      for (int32_t j = 0; j < V; ++j) {
        double relax = adj[target][j] + cost[target];
        if (cost[j] > relax) { cost[j] = relax; path[j] = target; }
      }
      used[target] = true;
    }
    int32_t rev[VMAX];
    int32_t nh = 0;
    for (int32_t node = goal; node != 0; node = path[node]) {
      if (path[node] < 0 || nh >= VMAX) return -1;  // broken path
      rev[nh++] = node - path[node];
    }
    int32_t* hops = hops_out + (int64_t)w * VMAX;
    for (int32_t k = 0; k < nh; ++k) hops[k] = rev[nh - 1 - k];
    if (nh < VMAX) hops[nh] = -1;

    // off-path slack via forward/backward DAG DP (edges only go forward)
    double df[VMAX], db[VMAX];
    for (int32_t i = 0; i < V; ++i) { df[i] = kBig; db[i] = kBig; }
    df[0] = 0.0;
    for (int32_t j = 1; j < V; ++j)
      for (int32_t i = 0; i < j; ++i) {
        double c = df[i] + adj[i][j];
        if (c < df[j]) df[j] = c;
      }
    db[goal] = 0.0;
    for (int32_t i = V - 2; i >= 0; --i)
      for (int32_t j = i + 1; j < V; ++j) {
        double c = adj[i][j] + db[j];
        if (c < db[i]) db[i] = c;
      }
    bool onpath[VMAX][VMAX] = {};
    {
      int32_t node = 0;
      for (int32_t k = 0; k < nh; ++k) { onpath[node][node + hops[k]] = true; node += hops[k]; }
    }
    double min_slack = kBig;
    const double bestc = df[goal];
    for (int32_t i = 0; i < V; ++i)
      for (int32_t j = i + 1; j < V; ++j) {
        if (adj[i][j] >= kBig || onpath[i][j]) continue;
        double slack = df[i] + adj[i][j] + db[j] - bestc;
        if (slack < min_slack) min_slack = slack;
      }
    needs_exact[w] = (min_slack < tie_eps) ? 1 : 0;
  }
  return 0;
}

}  // extern "C"

// int32 vector-of-rows types for the interleaved kernels (R lanes = R rows)
template <int R> struct VI;
template <> struct VI<8> {
  typedef int32_t v __attribute__((vector_size(32), aligned(4), may_alias));
};
template <> struct VI<16> {
  typedef int32_t v __attribute__((vector_size(64), aligned(4), may_alias));
};

// 32 - clz(|res|) per lane (0 for res == 0): the LMS step magnitude
// (SLALMS_SIGNED_LOG2CEIL, reference src/SLAPredictor.c:27,123-145).
template <int R>
static inline typename VI<R>::v lms_bitlen(typename VI<R>::v res) {
  typedef typename VI<R>::v vsi;
  const vsi vzero = {};
  vsi smask = res >> 31;
  vsi mag = (res ^ smask) - smask;  // |res| (INT_MIN wraps like scalar)
#if defined(__AVX512CD__) && defined(__AVX512VL__)
  // unaligned load/store intrinsics: the vsi vectors are only 4-aligned
  // (aligned(4) attribute), so a direct __m512i* deref is UB (UBSan-found);
  // codegen is identical (vmovdqu folds away on register values)
  if constexpr (R == 16) {
    __m512i lz = _mm512_lzcnt_epi32(_mm512_loadu_si512((const void*)&mag));
    vsi out;
    _mm512_storeu_si512((void*)&out, lz);
    return (vzero + 32) - out;
  } else {
    __m256i lz8 = _mm256_lzcnt_epi32(_mm256_loadu_si256((const __m256i*)&mag));
    vsi out;
    _mm256_storeu_si256((__m256i*)&out, lz8);
    return (vzero + 32) - out;
  }
#else
  vsi bl = vzero;
  for (int r = 0; r < R; ++r)
    bl[r] = mag[r] ? 32 - __builtin_clz((uint32_t)mag[r]) : 0;
  return bl;
#endif
}

// ---- in-register tile transpose I/O --------------------------------------
// The interleaved kernels walk R rows in lockstep; building each sample's
// R-lane vector with scalar inserts costs a store-forwarding stall per
// vector (a 64-byte load cannot forward from 16 separate 4-byte stores),
// ~4 ns per row-sample of pure data movement. Loading an R x R tile with
// R vector loads and transposing in registers amortizes that to ~3
// shuffles per sample-step (~10x less, measured). Arithmetic order is
// untouched — samples still step strictly in sequence — so streams stay
// byte-identical.
template <int R>
static inline void tile_load_scalar(const int32_t* base, int64_t stride,
                                    int32_t s0, typename VI<R>::v t[R]) {
  for (int k = 0; k < R; ++k)
    for (int r = 0; r < R; ++r) t[k][r] = base[r * stride + s0 + k];
}
template <int R>
static inline void tile_store_scalar(int32_t* base, int64_t stride, int32_t s0,
                                     const typename VI<R>::v t[R]) {
  for (int k = 0; k < R; ++k)
    for (int r = 0; r < R; ++r) base[r * stride + s0 + k] = t[k][r];
}

#if defined(__AVX512F__)
static inline void tile_transpose16(__m512i m[16]) {
  __m512i t[16], u[16], c[16];
  for (int i = 0; i < 8; ++i) {
    t[2 * i] = _mm512_unpacklo_epi32(m[2 * i], m[2 * i + 1]);
    t[2 * i + 1] = _mm512_unpackhi_epi32(m[2 * i], m[2 * i + 1]);
  }
  for (int i = 0; i < 4; ++i) {
    u[4 * i] = _mm512_unpacklo_epi64(t[4 * i], t[4 * i + 2]);
    u[4 * i + 1] = _mm512_unpackhi_epi64(t[4 * i], t[4 * i + 2]);
    u[4 * i + 2] = _mm512_unpacklo_epi64(t[4 * i + 1], t[4 * i + 3]);
    u[4 * i + 3] = _mm512_unpackhi_epi64(t[4 * i + 1], t[4 * i + 3]);
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) {
      c[8 * i + j] = _mm512_shuffle_i32x4(u[8 * i + j], u[8 * i + 4 + j], 0x88);
      c[8 * i + j + 4] =
          _mm512_shuffle_i32x4(u[8 * i + j], u[8 * i + 4 + j], 0xdd);
    }
  for (int j = 0; j < 8; ++j) {
    m[j] = _mm512_shuffle_i32x4(c[j], c[8 + j], 0x88);
    m[j + 8] = _mm512_shuffle_i32x4(c[j], c[8 + j], 0xdd);
  }
}
#endif
#if defined(__AVX2__)
static inline void tile_transpose8(__m256i m[8]) {
  __m256i t[8], u[8];
  for (int i = 0; i < 4; ++i) {
    t[2 * i] = _mm256_unpacklo_epi32(m[2 * i], m[2 * i + 1]);
    t[2 * i + 1] = _mm256_unpackhi_epi32(m[2 * i], m[2 * i + 1]);
  }
  for (int i = 0; i < 2; ++i) {
    u[4 * i] = _mm256_unpacklo_epi64(t[4 * i], t[4 * i + 2]);
    u[4 * i + 1] = _mm256_unpackhi_epi64(t[4 * i], t[4 * i + 2]);
    u[4 * i + 2] = _mm256_unpacklo_epi64(t[4 * i + 1], t[4 * i + 3]);
    u[4 * i + 3] = _mm256_unpackhi_epi64(t[4 * i + 1], t[4 * i + 3]);
  }
  for (int j = 0; j < 4; ++j) {
    m[j] = _mm256_permute2x128_si256(u[j], u[4 + j], 0x20);
    m[j + 4] = _mm256_permute2x128_si256(u[j], u[4 + j], 0x31);
  }
}
#endif

// Per-row-pointer tile load: rows live anywhere (e.g. (channel, offset)
// slices of the whole-file int32 signal) instead of a packed (R, n)
// batch — the host stage-1 entry reads its input IN PLACE this way,
// skipping the ~4 bytes/row-sample batch assembly copy.
template <int R>
static inline void tile_load_ptrs(const int32_t* const* rows, int32_t s0,
                                  typename VI<R>::v t[R]) {
#if defined(__AVX512F__)
  if constexpr (R == 16) {
    __m512i m[16];
    for (int r = 0; r < 16; ++r)
      m[r] = _mm512_loadu_si512((const void*)(rows[r] + s0));
    tile_transpose16(m);
    for (int k = 0; k < 16; ++k) _mm512_storeu_si512((void*)&t[k], m[k]);
    return;
  }
#endif
#if defined(__AVX2__)
  if constexpr (R == 8) {
    __m256i m[8];
    for (int r = 0; r < 8; ++r)
      m[r] = _mm256_loadu_si256((const __m256i*)(rows[r] + s0));
    tile_transpose8(m);
    for (int k = 0; k < 8; ++k) _mm256_storeu_si256((__m256i*)&t[k], m[k]);
    return;
  }
#endif
  for (int k = 0; k < R; ++k)
    for (int r = 0; r < R; ++r) t[k][r] = rows[r][s0 + k];
}

template <int R>
static inline void tile_load(const int32_t* base, int64_t stride, int32_t s0,
                             typename VI<R>::v t[R]) {
#if defined(__AVX512F__)
  if constexpr (R == 16) {
    __m512i m[16];
    for (int r = 0; r < 16; ++r)
      m[r] = _mm512_loadu_si512((const void*)(base + r * stride + s0));
    tile_transpose16(m);
    for (int k = 0; k < 16; ++k) _mm512_storeu_si512((void*)&t[k], m[k]);
    return;
  }
#endif
#if defined(__AVX2__)
  if constexpr (R == 8) {
    __m256i m[8];
    for (int r = 0; r < 8; ++r)
      m[r] = _mm256_loadu_si256((const __m256i*)(base + r * stride + s0));
    tile_transpose8(m);
    for (int k = 0; k < 8; ++k) _mm256_storeu_si256((__m256i*)&t[k], m[k]);
    return;
  }
#endif
  tile_load_scalar<R>(base, stride, s0, t);
}

// Per-row-pointer tile store (mirror of tile_load_ptrs): the in-place
// synthesis kernels read AND write rows that live anywhere (e.g. stride-L
// rows of the decoder's entropy batch), so non-consecutive lane groups
// need no pack/scatter copies.
template <int R>
static inline void tile_store_ptrs(int32_t* const* rows, int32_t s0,
                                   const typename VI<R>::v t[R]) {
#if defined(__AVX512F__)
  if constexpr (R == 16) {
    __m512i m[16];
    for (int k = 0; k < 16; ++k) m[k] = _mm512_loadu_si512((const void*)&t[k]);
    tile_transpose16(m);
    for (int r = 0; r < 16; ++r)
      _mm512_storeu_si512((void*)(rows[r] + s0), m[r]);
    return;
  }
#endif
#if defined(__AVX2__)
  if constexpr (R == 8) {
    __m256i m[8];
    for (int k = 0; k < 8; ++k) m[k] = _mm256_loadu_si256((const __m256i*)&t[k]);
    tile_transpose8(m);
    for (int r = 0; r < 8; ++r)
      _mm256_storeu_si256((__m256i*)(rows[r] + s0), m[r]);
    return;
  }
#endif
  for (int k = 0; k < R; ++k)
    for (int r = 0; r < R; ++r) rows[r][s0 + k] = t[k][r];
}

template <int R>
static inline void tile_store(int32_t* base, int64_t stride, int32_t s0,
                              typename VI<R>::v t[R]) {
#if defined(__AVX512F__)
  if constexpr (R == 16) {
    __m512i m[16];
    for (int k = 0; k < 16; ++k) m[k] = _mm512_loadu_si512((const void*)&t[k]);
    tile_transpose16(m);
    for (int r = 0; r < 16; ++r)
      _mm512_storeu_si512((void*)(base + r * stride + s0), m[r]);
    return;
  }
#endif
#if defined(__AVX2__)
  if constexpr (R == 8) {
    __m256i m[8];
    for (int k = 0; k < 8; ++k) m[k] = _mm256_loadu_si256((const __m256i*)&t[k]);
    tile_transpose8(m);
    for (int r = 0; r < 8; ++r)
      _mm256_storeu_si256((__m256i*)(base + r * stride + s0), m[r]);
    return;
  }
#endif
  tile_store_scalar<R>(base, stride, s0, t);
}

#if defined(__AVX512F__) && defined(__AVX512VL__)
// k-mask helpers for the register-window LMS form: the sign-sign update
// fc += step * sign(hist) collapses to a masked add (hist > 0) plus a
// masked sub (hist < 0) — exactly mult-by-{-1,0,+1} under wrapping int32,
// with the sign captured once at window insert as two k-masks instead of
// a sign-value vector. The loadu/storeu round trips fold away on register
// values (see lms_bitlen); vsi is only 4-aligned so direct casts are UB.
template <int R>
struct LmsMask;
template <>
struct LmsMask<16> {
  typedef __mmask16 t;
  static inline t pos(VI<16>::v x) {
    return _mm512_cmpgt_epi32_mask(_mm512_loadu_si512((const void*)&x),
                                   _mm512_setzero_si512());
  }
  static inline t neg(VI<16>::v x) {
    return _mm512_cmplt_epi32_mask(_mm512_loadu_si512((const void*)&x),
                                   _mm512_setzero_si512());
  }
  static inline VI<16>::v update(VI<16>::v c, t mp, t mn, VI<16>::v step) {
    __m512i cc = _mm512_loadu_si512((const void*)&c);
    const __m512i st = _mm512_loadu_si512((const void*)&step);
    cc = _mm512_mask_add_epi32(cc, mp, cc, st);
    cc = _mm512_mask_sub_epi32(cc, mn, cc, st);
    VI<16>::v out;
    _mm512_storeu_si512((void*)&out, cc);
    return out;
  }
};
template <>
struct LmsMask<8> {
  typedef __mmask8 t;
  static inline t pos(VI<8>::v x) {
    return _mm256_cmpgt_epi32_mask(_mm256_loadu_si256((const __m256i*)&x),
                                   _mm256_setzero_si256());
  }
  static inline t neg(VI<8>::v x) {
    return _mm256_cmplt_epi32_mask(_mm256_loadu_si256((const __m256i*)&x),
                                   _mm256_setzero_si256());
  }
  static inline VI<8>::v update(VI<8>::v c, t mp, t mn, VI<8>::v step) {
    __m256i cc = _mm256_loadu_si256((const __m256i*)&c);
    const __m256i st = _mm256_loadu_si256((const __m256i*)&step);
    cc = _mm256_mask_add_epi32(cc, mp, cc, st);
    cc = _mm256_mask_sub_epi32(cc, mn, cc, st);
    VI<8>::v out;
    _mm256_storeu_si256((__m256i*)&out, cc);
    return out;
  }
};

// Register-window LMS core (MF pinned at compile time): the M-deep x/p
// history windows and the filter coefficients all live in registers and
// shift explicitly per sample; signs ride k-mask registers captured at
// insert. Value-for-value the same arithmetic as the doubled-ring form
// below (the window IS the ring's newest M entries; masked add/sub IS the
// sign multiply; wrapping int32 everywhere), so outputs are byte-identical
// — only where the state lives changes. Removes the ring's per-sample
// memory traffic (2M history loads + 4 stores) and its refill-headroom
// copies, which dominated the pass at M = 8.
template <int R, bool SYNTH, int MF, class LoadT, class StoreT, class LoadC,
          class StoreC>
static void lms_rows_regwinT(int32_t n, LoadT load_tile, StoreT store_tile,
                             LoadC load_col, StoreC store_col) {
  typedef typename VI<R>::v vsi;
  typedef typename LmsMask<R>::t kmask;
  const vsi vzero = {};
  vsi fc[MF], ic[MF], xw[MF], pw[MF];
  kmask xp[MF], xn[MF], pp[MF], pn[MF];
  for (int32_t i = 0; i < MF; ++i) {
    fc[i] = vzero;
    ic[i] = vzero;
    xw[i] = vzero;
    pw[i] = vzero;
    xp[i] = 0;
    xn[i] = 0;
    pp[i] = 0;
    pn[i] = 0;
  }
  auto sample_step = [&](int32_t s, vsi in_v) -> vsi {
#ifdef SLA_TPU_DEBUG
    for (int32_t i = 0; i < MF; ++i)
      for (int32_t r = 0; r < R; ++r) {
        const int64_t fir = ((int64_t)fc[i][r] * xw[i][r]) >> 10;
        const int64_t iir = ((int64_t)ic[i][r] * pw[i][r]) >> 10;
        SLA_DBG_ASSERT(fir <= INT32_MAX && fir >= INT32_MIN,
                       "LMS fir tap product overflows int32");
        SLA_DBG_ASSERT(iir <= INT32_MAX && iir >= INT32_MIN,
                       "LMS iir tap product overflows int32");
      }
#endif
    vsi acc = vzero + 512;
    for (int32_t i = 0; i < MF; ++i) acc += fc[i] * xw[i] + ic[i] * pw[i];
    const vsi pred = acc >> 10;
    const bool warm = s < MF;
    vsi x, res;
    if (SYNTH) {
      res = in_v;
      x = in_v + pred;
    } else {
      x = in_v;
      res = in_v - pred;
    }
    if (!warm) {
      const vsi step =
          ((res < vzero) - (res > vzero)) * (lms_bitlen<R>(res) >> 1);
      for (int32_t i = 0; i < MF; ++i) {
        fc[i] = LmsMask<R>::update(fc[i], xp[i], xn[i], step);
        ic[i] = LmsMask<R>::update(ic[i], pp[i], pn[i], step);
      }
    }
    const vsi pnew = warm ? x : pred;
    for (int32_t i = MF - 1; i > 0; --i) {
      xw[i] = xw[i - 1];
      pw[i] = pw[i - 1];
      xp[i] = xp[i - 1];
      xn[i] = xn[i - 1];
      pp[i] = pp[i - 1];
      pn[i] = pn[i - 1];
    }
    xw[0] = x;
    pw[0] = pnew;
    xp[0] = LmsMask<R>::pos(x);
    xn[0] = LmsMask<R>::neg(x);
    pp[0] = LmsMask<R>::pos(pnew);
    pn[0] = LmsMask<R>::neg(pnew);
    return warm ? in_v : (SYNTH ? x : res);
  };
  int32_t s = 0;
  for (; s + R <= n; s += R) {
    vsi t[R];
    load_tile(s, t);
    for (int32_t k = 0; k < R; ++k) t[k] = sample_step(s + k, t[k]);
    store_tile(s, t);
  }
  for (; s < n; ++s) {
    const vsi emit = sample_step(s, load_col(s));
    store_col(s, emit);
  }
}
#endif  // __AVX512F__ && __AVX512VL__

// Perf note: two structural decode experiments were measured and
// rejected in round 5 — folding the long-term FIR into the lattice
// sample loop as masked gathers, and interleaving two independent
// 8-block entropy groups; see BASELINE.md "Round 5 host-path".
//
// Hand-vectorized sign-sign LMS core over R interleaved rows: one code
// path for both directions (SYNTH reconstructs x = res + pred, predict
// derives res = x - pred; reference src/SLAPredictor.c:1202-1463).
// Identical per-row arithmetic to the scalar kernel (vector lanes are
// rows). in_rows/out_rows are R x n row-major and may be the same buffer.
// Generic LMS core: ONE implementation of the per-sample arithmetic with
// the tile/column I/O passed as inlined lambdas, so the packed and
// row-pointer (_at) kernels share it without changing the state layout
// (the state arrays must stay function locals — routing them through a
// struct measurably pessimizes GCC's codegen for the hot loop).
template <int R, bool SYNTH, int MF, class LoadT, class StoreT, class LoadC,
          class StoreC>
static void lms_rows_genT(int32_t n, int32_t M_rt, LoadT load_tile,
                          StoreT store_tile, LoadC load_col,
                          StoreC store_col) {
#if defined(__AVX512F__) && defined(__AVX512VL__) && defined(__AVX512CD__)
  // compile-pinned orders (the preset paths) take the register-window
  // form: byte-identical outputs, state in registers instead of the ring
  if constexpr (MF > 0 && (R == 16 || R == 8)) {
    lms_rows_regwinT<R, SYNTH, MF>(n, load_tile, store_tile, load_col,
                                   store_col);
    return;
  }
#endif
  // MF > 0 pins the LMS order at compile time (presets use 4/8): unrolled
  // tap loops keep fc/ic and the ring windows in registers
  const int32_t M = MF > 0 ? MF : M_rt;
  typedef typename VI<R>::v vsi;
  const vsi vzero = {};
  vsi fc[64], ic[64];
  for (int32_t i = 0; i < M; ++i) { fc[i] = vzero; ic[i] = vzero; }
  // doubled ring history, newest tile at xd[xpos]; signs precomputed at
  // insertion (the update loop would otherwise recompute each value's
  // sign M times over its life in the window)
  vsi xd[128], pd[128], xs[128], ps[128];
  for (int32_t i = 0; i < 128; ++i) {
    xd[i] = vzero; pd[i] = vzero; xs[i] = vzero; ps[i] = vzero;
  }
  int32_t xpos = 64;
  auto sample_step = [&](int32_t s, vsi in_v) -> vsi {
    const vsi* xb = xd + xpos;
    const vsi* pb = pd + xpos;
#ifdef SLA_TPU_DEBUG
    for (int32_t i = 0; i < M; ++i)
      for (int32_t r = 0; r < R; ++r) {
        const int64_t fir = ((int64_t)fc[i][r] * xb[i][r]) >> 10;
        const int64_t iir = ((int64_t)ic[i][r] * pb[i][r]) >> 10;
        SLA_DBG_ASSERT(fir <= INT32_MAX && fir >= INT32_MIN,
                       "LMS fir tap product overflows int32");
        SLA_DBG_ASSERT(iir <= INT32_MAX && iir >= INT32_MIN,
                       "LMS iir tap product overflows int32");
      }
#endif
    vsi acc = vzero + 512;
    for (int32_t i = 0; i < M; ++i) acc += fc[i] * xb[i] + ic[i] * pb[i];
    const vsi pred = acc >> 10;
    const bool warm = s < M;
    vsi x, res;
    if (SYNTH) { res = in_v; x = in_v + pred; }
    else       { x = in_v; res = in_v - pred; }
    if (!warm) {
      // step = sign(res) * (bitlen(|res|) >> 1). Vector compares return
      // -1 for true, so (a < 0) - (a > 0) == scalar (a > 0) - (a < 0).
      const vsi step = ((res < vzero) - (res > vzero)) * (lms_bitlen<R>(res) >> 1);
      const vsi* xsb = xs + xpos;
      const vsi* psb = ps + xpos;
      for (int32_t i = 0; i < M; ++i) {
        fc[i] += step * xsb[i];
        ic[i] += step * psb[i];
      }
    }
    if (xpos == 0) {  // refill headroom
      for (int32_t i = M - 1; i >= 0; --i) {
        xd[64 + i] = xd[i]; pd[64 + i] = pd[i];
        xs[64 + i] = xs[i]; ps[64 + i] = ps[i];
      }
      xpos = 64;
    }
    --xpos;
    const vsi pnew = warm ? x : pred;
    xd[xpos] = x;
    pd[xpos] = pnew;
    xs[xpos] = (x < vzero) - (x > vzero);
    ps[xpos] = (pnew < vzero) - (pnew > vzero);
    return warm ? in_v : (SYNTH ? x : res);
  };
  // R-sample tiles transposed in registers (each tile is fully read
  // before its region is written, so in-place operation stays safe)
  int32_t s = 0;
  for (; s + R <= n; s += R) {
    vsi t[R];
    load_tile(s, t);
    for (int32_t k = 0; k < R; ++k) t[k] = sample_step(s + k, t[k]);
    store_tile(s, t);
  }
  for (; s < n; ++s) {  // tail columns
    const vsi emit = sample_step(s, load_col(s));
    store_col(s, emit);
  }
}

template <int R, bool SYNTH, int MF>
static void lms_rowsT(const int32_t* in_rows, int32_t* out_rows, int32_t n,
                      int32_t M_rt) {
  typedef typename VI<R>::v vsi;
  lms_rows_genT<R, SYNTH, MF>(
      n, M_rt,
      [&](int32_t s, vsi t[R]) { tile_load<R>(in_rows, n, s, t); },
      [&](int32_t s, vsi t[R]) { tile_store<R>(out_rows, n, s, t); },
      [&](int32_t s) -> vsi {
        vsi v;
        for (int32_t r = 0; r < R; ++r) v[r] = in_rows[(int64_t)r * n + s];
        return v;
      },
      [&](int32_t s, vsi v) {
        for (int32_t r = 0; r < R; ++r) out_rows[(int64_t)r * n + s] = v[r];
      });
}

// Row-pointer LMS (in-place or separate rows anywhere): bit-identical per
// row to lms_rowsT, without requiring a packed (R, n) batch.
template <int R, bool SYNTH, int MF>
static void lms_rowsT_at(const int32_t* const* in_rows,
                         int32_t* const* out_rows, int32_t n, int32_t M_rt) {
  typedef typename VI<R>::v vsi;
  lms_rows_genT<R, SYNTH, MF>(
      n, M_rt,
      [&](int32_t s, vsi t[R]) { tile_load_ptrs<R>(in_rows, s, t); },
      [&](int32_t s, vsi t[R]) { tile_store_ptrs<R>(out_rows, s, t); },
      [&](int32_t s) -> vsi {
        vsi v;
        for (int32_t r = 0; r < R; ++r) v[r] = in_rows[r][s];
        return v;
      },
      [&](int32_t s, vsi v) {
        for (int32_t r = 0; r < R; ++r) out_rows[r][s] = v[r];
      });
}

// Row-interleaved encode stage 1: pre-emphasis + lattice predict, R rows
// interleaved for SIMD (R=8 fills a 256-bit int32 vector, R=16 a 512-bit
// one; per-row arithmetic is identical for any R). in/out: R rows x n.
// Lattice predict core. P > 0 pins the order at compile time (presets use
// 8/16/32): the fully-unrolled stage loops keep the m/fpart suffix-sum
// chains in zmm registers instead of round-tripping the stack per stage —
// the store->load latency through those arrays dominated the pass.
template <int R, int P>
static int32_t predict_stage1_coreT(const int32_t* const* in_rows,
                                    int32_t* out, int32_t n,
                                    const int32_t* parcor_coef /* R x p */,
                                    int32_t p_rt) {
  const int32_t p = P > 0 ? P : p_rt;
  typedef typename VI<R>::v vsi;
  const vsi vzero = {};
  const vsi half = vzero + (1 << 14);
  vsi c[64];
  for (int32_t k = 0; k < p; ++k)
    for (int32_t r = 0; r < R; ++r) c[k][r] = parcor_coef[r * p + k];
  vsi b[65];
  for (int32_t k = 0; k <= p; ++k) b[k] = vzero;
  vsi x_prev = vzero;
  vsi fp[64];
  auto sample_step = [&](vsi raw) -> vsi {
    vsi x = raw - ((x_prev * 31) >> 5);
    x_prev = raw;
#ifdef SLA_TPU_DEBUG
    for (int32_t k = 0; k < p; ++k)
      for (int32_t r = 0; r < R; ++r) {
        const int64_t q = (((int64_t)c[k][r] * b[k][r]) + (1 << 14)) >> 15;
        SLA_DBG_ASSERT(q <= INT32_MAX && q >= INT32_MIN,
                       "lattice predict stage product overflows int32");
      }
#endif
    // every stage term uses PREVIOUS state only (the JAX kernel's
    // formulation): m[k] = q(c[k+1], b_prev[k]) — fully parallel over k, r.
    // The m[] array is folded into the fp prefix loop (the value is used
    // exactly once there); same operations in the same order, ~2p fewer
    // stack round trips per sample.
    // fp[k] = f before stage k+1 = x - prefix_sum(m)[k-1]
    fp[0] = x;
    for (int32_t k = 1; k < p; ++k)
      fp[k] = fp[k - 1] - ((c[k - 1] * b[k - 1] + half) >> 15);
    const vsi out = fp[p - 1] - ((c[p - 1] * b[p - 1] + half) >> 15);
    // b update: b_new[k+1] = b_prev[k] - q(c[k+1], fp[k]), top-down so
    // b_prev reads stay untouched
    for (int32_t k = p - 1; k >= 0; --k)
      b[k + 1] = b[k] - ((c[k] * fp[k] + half) >> 15);
    b[0] = x;
    return out;
  };
  int32_t s = 0;
  for (; s + R <= n; s += R) {  // transposed register tiles (see tile_load)
    vsi t[R];
    tile_load_ptrs<R>(in_rows, s, t);
    for (int32_t k = 0; k < R; ++k) t[k] = sample_step(t[k]);
    tile_store<R>(out, n, s, t);
  }
  for (; s < n; ++s) {
    vsi raw;
    for (int32_t r = 0; r < R; ++r) raw[r] = in_rows[r][s];
    const vsi o = sample_step(raw);
    for (int32_t r = 0; r < R; ++r) out[(int64_t)r * n + s] = o[r];
  }
  return 0;
}

template <int R>
static int32_t predict_stage1_rowsT_at(const int32_t* const* rows,
                                       int32_t* out, int32_t n,
                                       const int32_t* parcor_coef /* R x p */,
                                       int32_t p) {
  typedef typename VI<R>::v vsi;
  const vsi vzero = {};
  if (p == 0) {  // degenerate order: pre-emphasis only (lattice = identity)
    vsi x_prev0 = vzero;
    for (int32_t s = 0; s < n; ++s) {
      vsi raw;
      for (int32_t r = 0; r < R; ++r) raw[r] = rows[r][s];
      const vsi o = raw - ((x_prev0 * 31) >> 5);
      x_prev0 = raw;
      for (int32_t r = 0; r < R; ++r) out[(int64_t)r * n + s] = o[r];
    }
    return 0;
  }
  switch (p) {  // compile-time orders for the preset values
    case 8:  return predict_stage1_coreT<R, 8>(rows, out, n, parcor_coef, p);
    case 16: return predict_stage1_coreT<R, 16>(rows, out, n, parcor_coef, p);
    case 32: return predict_stage1_coreT<R, 32>(rows, out, n, parcor_coef, p);
    default: return predict_stage1_coreT<R, 0>(rows, out, n, parcor_coef, p);
  }
}

template <int R>
static int32_t predict_stage1_rowsT(const int32_t* in, int32_t* out,
                                    int32_t n,
                                    const int32_t* parcor_coef /* R x p */,
                                    int32_t p) {
  const int32_t* rows[R];
  for (int32_t r = 0; r < R; ++r) rows[r] = in + (int64_t)r * n;
  return predict_stage1_rowsT_at<R>(rows, out, n, parcor_coef, p);
}

// Row-interleaved encode stage 2: long-term FIR (history = input, no
// recursion) + LMS predict.
template <int R>
static int32_t predict_stage2_rowsT(const int32_t* in, int32_t* out,
                                    int32_t n, const int32_t* pitch8,
                                    const int32_t* ltm /* R x T */,
                                    int32_t num_taps, int32_t lms_order) {
  const int32_t M = lms_order;
  // long-term: plain vectorizable FIR per row (bounded lookback into `in`)
  for (int32_t r = 0; r < R; ++r) {
    const int32_t* row = in + (int64_t)r * n;
    int32_t* orow = out + (int64_t)r * n;
    if (pitch8[r] > 0) {
      const int32_t max_delay = pitch8[r] + num_taps / 2;
      int32_t q15c[8];
    if (num_taps > 8) return -1;
      for (int32_t j = 0; j < num_taps; ++j) q15c[j] = ltm[r * num_taps + j] >> 16;
      const int32_t warm = max_delay < n ? max_delay : n;
      for (int32_t s = 0; s < warm; ++s) orow[s] = row[s];
      // pure FIR on the input (no feedback): branch-free main loop
      // vectorizes over samples
      for (int32_t s = warm; s < n; ++s) {
        int64_t acc = 0;
        for (int32_t j = 0; j < num_taps; ++j)
          acc += (int64_t)q15c[j] * row[s - (max_delay - j)];
        orow[s] = row[s] - (int32_t)((acc + (1 << 14)) >> 15);
      }
    } else {
      std::memcpy(orow, row, sizeof(int32_t) * n);
    }
  }
  // LMS predict in place over `out` via the hand-vectorized core
  switch (M) {
    case 4: lms_rowsT<R, false, 4>(out, out, n, M); break;
    case 8: lms_rowsT<R, false, 8>(out, out, n, M); break;
    default: lms_rowsT<R, false, 0>(out, out, n, M); break;
  }
  return 0;
}

// Generic lattice synthesis + de-emphasis core (pass C of synth_rowsT):
// ONE implementation of the per-sample arithmetic with tile/column I/O
// passed as inlined lambdas (see lms_rows_genT for why the state must
// stay function-local). P > 0 pins the order at compile time (see predict
// core). The four concrete kernels (packed / row-pointer x in-place /
// fused-output store) are thin wrappers.
template <int R, int P, class LoadT, class StoreT, class LoadC, class StoreC>
static void lattice_synth_genT(int32_t n,
                               const int32_t* parcor_coef /* R x p */,
                               int32_t p_rt, LoadT load_tile,
                               StoreT store_tile, LoadC load_col,
                               StoreC store_col) {
  const int32_t p = P > 0 ? P : p_rt;
  typedef typename VI<R>::v vsi;
  const vsi vzero = {};
  const vsi half = vzero + (1 << 14);
  vsi c[64];
  for (int32_t k = 0; k < p; ++k)
    for (int32_t r = 0; r < R; ++r) c[k][r] = parcor_coef[r * p + k];
  vsi lat[65];
  for (int32_t k = 0; k <= p; ++k) lat[k] = vzero;
  vsi deemph = vzero;
  auto sample_step = [&](vsi y) -> vsi {
#ifdef SLA_TPU_DEBUG
    for (int32_t k = 0; k < p; ++k)
      for (int32_t r = 0; r < R; ++r) {
        const int64_t q = (((int64_t)c[k][r] * lat[k][r]) + (1 << 14)) >> 15;
        SLA_DBG_ASSERT(q <= INT32_MAX && q >= INT32_MIN,
                       "lattice synth stage product overflows int32");
      }
#endif
    // fused downward pass: the running suffix sum (fpart) rides ONE
    // register and each stage touches memory exactly thrice (load c[k],
    // load lat[k], store lat[k+1]) — the split m[]/fpart[] array form
    // round-tripped the stack ~6x per stage at p = 32, where the arrays
    // cannot live in registers. Value-for-value the same arithmetic in
    // the same order (m[k] from OLD lat[k]: writes this sample are to
    // lat[k+2..p], so the k-th read is untouched; fpart adds descend;
    // lat updates use the same operands), so streams are byte-identical.
    vsi f = y + ((c[p - 1] * lat[p - 1] + half) >> 15);
    lat[p] = lat[p - 1] - ((c[p - 1] * f + half) >> 15);
    for (int32_t k = p - 2; k >= 0; --k) {
      f += (c[k] * lat[k] + half) >> 15;
      lat[k + 1] = lat[k] - ((c[k] * f + half) >> 15);
    }
    vsi v = f;
    lat[0] = v;
    v += (deemph * 31) >> 5;
    deemph = v;
    return v;
  };
  int32_t s = 0;
  for (; s + R <= n; s += R) {  // transposed register tiles
    vsi t[R];
    load_tile(s, t);
    for (int32_t k = 0; k < R; ++k) t[k] = sample_step(t[k]);
    store_tile(s, t);
  }
  for (; s < n; ++s) store_col(s, sample_step(load_col(s)));
}

template <int R, int P>
static void lattice_synth_coreT(int32_t* out, int32_t n,
                                const int32_t* parcor_coef /* R x p */,
                                int32_t p_rt) {
  typedef typename VI<R>::v vsi;
  lattice_synth_genT<R, P>(
      n, parcor_coef, p_rt,
      [&](int32_t s, vsi t[R]) { tile_load<R>(out, n, s, t); },
      [&](int32_t s, vsi t[R]) { tile_store<R>(out, n, s, t); },
      [&](int32_t s) -> vsi {
        vsi y;
        for (int32_t r = 0; r < R; ++r) y[r] = out[(int64_t)r * n + s];
        return y;
      },
      [&](int32_t s, vsi v) {
        for (int32_t r = 0; r < R; ++r) out[(int64_t)r * n + s] = v[r];
      });
}

// Row-pointer in-place lattice synthesis (see lattice_synth_coreT).
template <int R, int P>
static void lattice_synth_coreT_at(int32_t* const* rows, int32_t n,
                                   const int32_t* parcor_coef /* R x p */,
                                   int32_t p_rt) {
  typedef typename VI<R>::v vsi;
  lattice_synth_genT<R, P>(
      n, parcor_coef, p_rt,
      [&](int32_t s, vsi t[R]) {
        tile_load_ptrs<R>(const_cast<const int32_t* const*>(rows), s, t);
      },
      [&](int32_t s, vsi t[R]) { tile_store_ptrs<R>(rows, s, t); },
      [&](int32_t s) -> vsi {
        vsi y;
        for (int32_t r = 0; r < R; ++r) y[r] = rows[r][s];
        return y;
      },
      [&](int32_t s, vsi v) {
        for (int32_t r = 0; r < R; ++r) rows[r][s] = v[r];
      });
}

// Fused-output lattice pass: like lattice_synth_coreT, but instead of
// writing the work buffer back it stores each finished R-sample tile
// STRAIGHT into the caller's (C, N) PCM buffer at per-row destinations,
// applying the mid/side inverse (rows pair as even=mid, odd=side) and the
// final left shift in registers. Removes the decoder's whole-batch
// ms_shift pass: one store instead of batch write-back + re-read + final
// write. Arithmetic per row is identical to lattice_synth_coreT followed
// by the reference's MStoLR + shift (SLADecoder.c:540-556, wrapping
// int32); only WHERE values land changes.
// Row-major tile store with fused MS inverse + left shift: transposes an
// R-sample tile back to row-major and lands it at dest[r] + s0 with the
// reference's MStoLR + shift applied in registers (SLADecoder.c:540-556
// semantics; wrapping int32).
template <int R>
static inline void synth_store_tile(typename VI<R>::v t[R], int32_t s0,
                                    int32_t* const* dest /* R row ptrs */,
                                    int32_t ms, int32_t shift) {
  {
#if defined(__AVX512F__)
    if constexpr (R == 16) {
      __m512i mm[16];
      for (int k = 0; k < 16; ++k)
        mm[k] = _mm512_loadu_si512((const void*)&t[k]);
      tile_transpose16(mm);
      const __m128i sh = _mm_cvtsi32_si128(shift);
      if (ms) {
        const __m512i one = _mm512_set1_epi32(1);
        for (int r = 0; r < 16; r += 2) {
          const __m512i mid = mm[r], sd = mm[r + 1];
          const __m512i full = _mm512_or_si512(_mm512_slli_epi32(mid, 1),
                                               _mm512_and_si512(sd, one));
          __m512i l = _mm512_srai_epi32(_mm512_add_epi32(full, sd), 1);
          __m512i rr = _mm512_srai_epi32(_mm512_sub_epi32(full, sd), 1);
          l = _mm512_sll_epi32(l, sh);
          rr = _mm512_sll_epi32(rr, sh);
          _mm512_storeu_si512((void*)(dest[r] + s0), l);
          _mm512_storeu_si512((void*)(dest[r + 1] + s0), rr);
        }
      } else {
        for (int r = 0; r < 16; ++r)
          _mm512_storeu_si512((void*)(dest[r] + s0),
                              _mm512_sll_epi32(mm[r], sh));
      }
      return;
    }
#endif
#if defined(__AVX2__)
    if constexpr (R == 8) {
      __m256i mm[8];
      for (int k = 0; k < 8; ++k)
        mm[k] = _mm256_loadu_si256((const __m256i*)&t[k]);
      tile_transpose8(mm);
      const __m128i sh = _mm_cvtsi32_si128(shift);
      if (ms) {
        const __m256i one = _mm256_set1_epi32(1);
        for (int r = 0; r < 8; r += 2) {
          const __m256i mid = mm[r], sd = mm[r + 1];
          const __m256i full = _mm256_or_si256(_mm256_slli_epi32(mid, 1),
                                               _mm256_and_si256(sd, one));
          __m256i l = _mm256_srai_epi32(_mm256_add_epi32(full, sd), 1);
          __m256i rr = _mm256_srai_epi32(_mm256_sub_epi32(full, sd), 1);
          l = _mm256_sll_epi32(l, sh);
          rr = _mm256_sll_epi32(rr, sh);
          _mm256_storeu_si256((__m256i*)(dest[r] + s0), l);
          _mm256_storeu_si256((__m256i*)(dest[r + 1] + s0), rr);
        }
      } else {
        for (int r = 0; r < 8; ++r)
          _mm256_storeu_si256((__m256i*)(dest[r] + s0),
                              _mm256_sll_epi32(mm[r], sh));
      }
      return;
    }
#endif
    // scalar fallback (non-AVX builds / other widths)
    for (int k = 0; k < R; ++k) {
      if (ms) {
        for (int r = 0; r < R; r += 2) {
          const int32_t mid = t[k][r], sd = t[k][r + 1];
          const int32_t full = (mid << 1) | (sd & 1);
          dest[r][s0 + k] = ((full + sd) >> 1) << shift;
          dest[r + 1][s0 + k] = ((full - sd) >> 1) << shift;
        }
      } else {
        for (int r = 0; r < R; ++r) dest[r][s0 + k] = t[k][r] << shift;
      }
    }
  }
}

// Single-column fused store for the tail samples.
template <int R>
static inline void synth_store_col(typename VI<R>::v v, int32_t s,
                                   int32_t* const* dest, int32_t ms,
                                   int32_t shift) {
  if (ms) {
    for (int32_t r = 0; r < R; r += 2) {
      const int32_t mid = v[r], sd = v[r + 1];
      const int32_t full = (mid << 1) | (sd & 1);
      dest[r][s] = ((full + sd) >> 1) << shift;
      dest[r + 1][s] = ((full - sd) >> 1) << shift;
    }
  } else {
    for (int32_t r = 0; r < R; ++r) dest[r][s] = v[r] << shift;
  }
}

template <int R, int P>
static void lattice_synth_out_coreT(const int32_t* work, int32_t n,
                                    const int32_t* parcor_coef /* R x p */,
                                    int32_t p_rt,
                                    int32_t* const* dest /* R row ptrs */,
                                    int32_t ms, int32_t shift) {
  typedef typename VI<R>::v vsi;
  lattice_synth_genT<R, P>(
      n, parcor_coef, p_rt,
      [&](int32_t s, vsi t[R]) { tile_load<R>(work, n, s, t); },
      [&](int32_t s, vsi t[R]) { synth_store_tile<R>(t, s, dest, ms, shift); },
      [&](int32_t s) -> vsi {
        vsi y;
        for (int32_t r = 0; r < R; ++r) y[r] = work[(int64_t)r * n + s];
        return y;
      },
      [&](int32_t s, vsi v) { synth_store_col<R>(v, s, dest, ms, shift); });
}

// Row-pointer fused-output lattice pass (see lattice_synth_out_coreT).
template <int R, int P>
static void lattice_synth_out_coreT_at(const int32_t* const* work_rows,
                                       int32_t n,
                                       const int32_t* parcor_coef /* R x p */,
                                       int32_t p_rt,
                                       int32_t* const* dest /* R row ptrs */,
                                       int32_t ms, int32_t shift) {
  typedef typename VI<R>::v vsi;
  lattice_synth_genT<R, P>(
      n, parcor_coef, p_rt,
      [&](int32_t s, vsi t[R]) { tile_load_ptrs<R>(work_rows, s, t); },
      [&](int32_t s, vsi t[R]) { synth_store_tile<R>(t, s, dest, ms, shift); },
      [&](int32_t s) -> vsi {
        vsi y;
        for (int32_t r = 0; r < R; ++r) y[r] = work_rows[r][s];
        return y;
      },
      [&](int32_t s, vsi v) { synth_store_col<R>(v, s, dest, ms, shift); });
}

static inline void longterm_synth_row(int32_t* x, int32_t n, int32_t pitch,
                                      const int32_t* ltm_row,
                                      int32_t num_taps);

// Fused-output synthesis: passes A/B run IN PLACE over `work` (clobbered),
// pass C stores straight into the PCM destinations with MS inverse + left
// shift fused (see lattice_synth_out_coreT). Requires p > 0 (the preset
// decode paths); p == 0 falls back upstream.
template <int R>
static int32_t synth_rowsT_out(int32_t* work, int32_t n,
                               const int32_t* parcor_coef /* R x p */,
                               int32_t p, const int32_t* pitch8 /* R */,
                               const int32_t* ltm /* R x T */,
                               int32_t num_taps, int32_t lms_order,
                               int32_t* dest_base,
                               const int64_t* dest_offs /* R */, int32_t ms,
                               int32_t shift) {
  if (p <= 0 || (ms && (R & 1))) return -1;
  const int32_t M = lms_order;
  switch (M) {
    case 4: lms_rowsT<R, true, 4>(work, work, n, M); break;
    case 8: lms_rowsT<R, true, 8>(work, work, n, M); break;
    default: lms_rowsT<R, true, 0>(work, work, n, M); break;
  }
  if (num_taps > 8) return -1;
  for (int32_t r = 0; r < R; ++r) {
    if (pitch8[r] <= 0) continue;
    longterm_synth_row(work + (int64_t)r * n, n, pitch8[r],
                       ltm + r * num_taps, num_taps);
  }
  int32_t* dest[R];
  for (int32_t r = 0; r < R; ++r) dest[r] = dest_base + dest_offs[r];
  switch (p) {
    case 8:  lattice_synth_out_coreT<R, 8>(work, n, parcor_coef, p, dest, ms, shift); break;
    case 16: lattice_synth_out_coreT<R, 16>(work, n, parcor_coef, p, dest, ms, shift); break;
    case 32: lattice_synth_out_coreT<R, 32>(work, n, parcor_coef, p, dest, ms, shift); break;
    default: lattice_synth_out_coreT<R, 0>(work, n, parcor_coef, p, dest, ms, shift); break;
  }
  return 0;
}

// One row of long-term synthesis, in place, chunked over samples: the
// feedback lag is >= min_lag = max_delay - (num_taps - 1), so every read
// inside a min_lag-sized chunk is before the chunk start and the chunk
// body is dependency-free despite writing x in place. The AVX-512 body
// processes 8 samples per step with the exact scalar semantics: int64
// products accumulated in ascending-j order (vpmuldq sign-extends the low
// 32 bits of both operands), + (1<<14), arithmetic >> 15, truncating
// int32 cast, wrapping int32 add — byte-identical to the scalar loop.
static inline void longterm_synth_row(int32_t* x, int32_t n, int32_t pitch,
                                      const int32_t* ltm_row,
                                      int32_t num_taps) {
  const int32_t max_delay = pitch + num_taps / 2;
  int32_t q15c[8];
  for (int32_t j = 0; j < num_taps; ++j) q15c[j] = ltm_row[j] >> 16;
  const int32_t min_lag = max_delay - (num_taps - 1);
  for (int32_t s0 = max_delay; s0 < n; s0 += min_lag) {
    const int32_t e = s0 + min_lag < n ? s0 + min_lag : n;
    int32_t s = s0;
#if defined(__AVX512F__) && !defined(SLA_TPU_DEBUG)
    const __m512i vhalf = _mm512_set1_epi64(1 << 14);
    for (; s + 8 <= e; s += 8) {
      __m512i acc = _mm512_setzero_si512();
      for (int32_t j = 0; j < num_taps; ++j) {
        const __m256i xi =
            _mm256_loadu_si256((const __m256i*)(x + s - (max_delay - j)));
        acc = _mm512_add_epi64(
            acc, _mm512_mul_epi32(_mm512_cvtepi32_epi64(xi),
                                  _mm512_set1_epi64((int64_t)q15c[j])));
      }
      acc = _mm512_srai_epi64(_mm512_add_epi64(acc, vhalf), 15);
      const __m256i xv = _mm256_loadu_si256((const __m256i*)(x + s));
      _mm256_storeu_si256(
          (__m256i*)(x + s),
          _mm256_add_epi32(xv, _mm512_cvtepi64_epi32(acc)));
    }
#endif
#pragma GCC ivdep
    for (; s < e; ++s) {
      int64_t acc = 0;
      for (int32_t j = 0; j < num_taps; ++j)
        acc += (int64_t)q15c[j] * x[s - (max_delay - j)];
      SLA_DBG_ASSERT(((acc + (1 << 14)) >> 15) <= INT32_MAX &&
                         ((acc + (1 << 14)) >> 15) >= INT32_MIN,
                     "long-term prediction overflows int32");
      x[s] += (int32_t)((acc + (1 << 14)) >> 15);
    }
  }
}

// Shared long-term pass over row pointers (pass B of the _at forms): per
// row, chunked over samples (see longterm_synth_row); in place.
template <int R>
static int32_t synth_longterm_rows_at(int32_t* const* rows, int32_t n,
                                      const int32_t* pitchR /* R */,
                                      const int32_t* ltm /* R x T */,
                                      int32_t num_taps) {
  if (num_taps > 8) return -1;
  for (int32_t r = 0; r < R; ++r) {
    if (pitchR[r] <= 0) continue;
    longterm_synth_row(rows[r], n, pitchR[r], ltm + r * num_taps, num_taps);
  }
  return 0;
}

// Row-pointer synthesis: input rows at in_base + in_offs[r], output rows
// at out_base + out_offs[r] (either may alias for in-place operation; the
// LMS tile loop reads each tile fully before writing it, rows may live at
// stride L of the decoder's entropy batch in any order), so
// non-consecutive and mixed-length lane groups need no pack/scatter
// copies. Requires p > 0 (no degenerate-order lattice form); bit-identical
// per row to synth_rowsT.
template <int R>
static int32_t synth_rowsT_at(const int32_t* in_base,
                              const int64_t* in_offs, int32_t* out_base,
                              const int64_t* out_offs, int32_t n,
                              const int32_t* parcor_coef /* R x p */,
                              int32_t p, const int32_t* pitchR /* R */,
                              const int32_t* ltm /* R x T */,
                              int32_t num_taps, int32_t lms_order) {
  if (p <= 0) return -1;
  const int32_t* irows[R];
  int32_t* rows[R];
  for (int32_t r = 0; r < R; ++r) {
    irows[r] = in_base + in_offs[r];
    rows[r] = out_base + out_offs[r];
  }
  const int32_t M = lms_order;
  switch (M) {
    case 4: lms_rowsT_at<R, true, 4>(irows, rows, n, M); break;
    case 8: lms_rowsT_at<R, true, 8>(irows, rows, n, M); break;
    default: lms_rowsT_at<R, true, 0>(irows, rows, n, M); break;
  }
  if (synth_longterm_rows_at<R>(rows, n, pitchR, ltm, num_taps) != 0)
    return -1;
  switch (p) {
    case 8:  lattice_synth_coreT_at<R, 8>(rows, n, parcor_coef, p); break;
    case 16: lattice_synth_coreT_at<R, 16>(rows, n, parcor_coef, p); break;
    case 32: lattice_synth_coreT_at<R, 32>(rows, n, parcor_coef, p); break;
    default: lattice_synth_coreT_at<R, 0>(rows, n, parcor_coef, p); break;
  }
  return 0;
}

// Row-pointer fused-output synthesis: passes A/B in place over the rows at
// base + row_offs (clobbered), pass C stores straight into the PCM buffer
// with MS inverse + left shift fused. Bit-identical to synth_rowsT_out.
template <int R>
static int32_t synth_rowsT_out_at(int32_t* base, const int64_t* row_offs,
                                  int32_t n,
                                  const int32_t* parcor_coef /* R x p */,
                                  int32_t p, const int32_t* pitchR /* R */,
                                  const int32_t* ltm /* R x T */,
                                  int32_t num_taps, int32_t lms_order,
                                  int32_t* dest_base,
                                  const int64_t* dest_offs /* R */,
                                  int32_t ms, int32_t shift) {
  if (p <= 0 || (ms && (R & 1))) return -1;
  int32_t* rows[R];
  const int32_t* crows[R];
  for (int32_t r = 0; r < R; ++r) {
    rows[r] = base + row_offs[r];
    crows[r] = rows[r];
  }
  const int32_t M = lms_order;
  switch (M) {
    case 4: lms_rowsT_at<R, true, 4>(crows, rows, n, M); break;
    case 8: lms_rowsT_at<R, true, 8>(crows, rows, n, M); break;
    default: lms_rowsT_at<R, true, 0>(crows, rows, n, M); break;
  }
  if (synth_longterm_rows_at<R>(rows, n, pitchR, ltm, num_taps) != 0)
    return -1;
  int32_t* dest[R];
  for (int32_t r = 0; r < R; ++r) dest[r] = dest_base + dest_offs[r];
  switch (p) {
    case 8:  lattice_synth_out_coreT_at<R, 8>(crows, n, parcor_coef, p, dest, ms, shift); break;
    case 16: lattice_synth_out_coreT_at<R, 16>(crows, n, parcor_coef, p, dest, ms, shift); break;
    case 32: lattice_synth_out_coreT_at<R, 32>(crows, n, parcor_coef, p, dest, ms, shift); break;
    default: lattice_synth_out_coreT_at<R, 0>(crows, n, parcor_coef, p, dest, ms, shift); break;
  }
  return 0;
}

// Eight-row synthesis: same cascade as sla_synth_chunk, restructured as
// three passes — the stages have no cross-feedback (LMS sees only the
// residual and its own state; long-term only LMS output and its own
// output; lattice only long-term output and its own state), so running
// each stage over the whole block produces identical values to the fused
// per-sample loop while letting the long-term stage vectorize over
// samples (its feedback lag is >= max_delay - num_taps + 1, so chunks of
// that length are dependency-free). residual/out: R rows x n, row-major.
template <int R>
static int32_t synth_rowsT(const int32_t* residual, int32_t* out, int32_t n,
                           const int32_t* parcor_coef /* R x p */, int32_t p,
                           const int32_t* pitch8 /* R */,
                           const int32_t* ltm /* R x T */, int32_t num_taps,
                           int32_t lms_order) {
  const int32_t M = lms_order;

  // ---- pass A: LMS synthesis, rows interleaved, into `out`
  // (hand-vectorized core; identical arithmetic to the scalar loop)
  switch (M) {
    case 4: lms_rowsT<R, true, 4>(residual, out, n, M); break;
    case 8: lms_rowsT<R, true, 8>(residual, out, n, M); break;
    default: lms_rowsT<R, true, 0>(residual, out, n, M); break;
  }

  // ---- pass B: long-term synthesis, per row, chunked over samples
  if (num_taps > 8) return -1;
  for (int32_t r = 0; r < R; ++r) {
    if (pitch8[r] <= 0) continue;
    longterm_synth_row(out + (int64_t)r * n, n, pitch8[r],
                       ltm + r * num_taps, num_taps);
  }

  // ---- pass C: PARCOR lattice synthesis + de-emphasis, rows interleaved
  // (hand-vectorized: lanes = rows, same suffix-sum formulation; order
  // pinned at compile time for the preset values — see predict core)
  if (p == 0) {  // degenerate order: de-emphasis only (lattice = identity)
    typedef typename VI<R>::v vsi;
    const vsi vzero = {};
    vsi deemph0 = vzero;
    for (int32_t s = 0; s < n; ++s) {
      vsi v;
      for (int32_t r = 0; r < R; ++r) v[r] = out[(int64_t)r * n + s];
      v += (deemph0 * 31) >> 5;
      deemph0 = v;
      for (int32_t r = 0; r < R; ++r) out[(int64_t)r * n + s] = v[r];
    }
    return 0;
  }
  switch (p) {
    case 8:  lattice_synth_coreT<R, 8>(out, n, parcor_coef, p); break;
    case 16: lattice_synth_coreT<R, 16>(out, n, parcor_coef, p); break;
    case 32: lattice_synth_coreT<R, 32>(out, n, parcor_coef, p); break;
    default: lattice_synth_coreT<R, 0>(out, n, parcor_coef, p); break;
  }
  return 0;
}

extern "C" {

// 8- and 16-row instantiations of the interleaved filter kernels (AVX2 /
// AVX-512 int32 vector widths; identical per-row arithmetic either way).
int32_t sla_predict_stage1_rows8(const int32_t* in, int32_t* out, int32_t n,
                                 const int32_t* coef, int32_t p) {
  return predict_stage1_rowsT<8>(in, out, n, coef, p);
}
int32_t sla_predict_stage1_rows16(const int32_t* in, int32_t* out, int32_t n,
                                  const int32_t* coef, int32_t p) {
  return predict_stage1_rowsT<16>(in, out, n, coef, p);
}
// In-place input forms: rows read base + offs[r] (element offsets into the
// whole-file (C, N) int32 signal) — no (R, n) batch assembly copy.
int32_t sla_predict_stage1_rows8_at(const int32_t* base, const int64_t* offs,
                                    int32_t* out, int32_t n,
                                    const int32_t* coef, int32_t p) {
  const int32_t* rows[8];
  for (int32_t r = 0; r < 8; ++r) rows[r] = base + offs[r];
  return predict_stage1_rowsT_at<8>(rows, out, n, coef, p);
}
int32_t sla_predict_stage1_rows16_at(const int32_t* base, const int64_t* offs,
                                     int32_t* out, int32_t n,
                                     const int32_t* coef, int32_t p) {
  const int32_t* rows[16];
  for (int32_t r = 0; r < 16; ++r) rows[r] = base + offs[r];
  return predict_stage1_rowsT_at<16>(rows, out, n, coef, p);
}
int32_t sla_predict_stage2_rows8(const int32_t* in, int32_t* out, int32_t n,
                                 const int32_t* pitch8, const int32_t* ltm,
                                 int32_t num_taps, int32_t lms_order) {
  return predict_stage2_rowsT<8>(in, out, n, pitch8, ltm, num_taps, lms_order);
}
int32_t sla_predict_stage2_rows16(const int32_t* in, int32_t* out, int32_t n,
                                  const int32_t* pitch8, const int32_t* ltm,
                                  int32_t num_taps, int32_t lms_order) {
  return predict_stage2_rowsT<16>(in, out, n, pitch8, ltm, num_taps,
                                  lms_order);
}
int32_t sla_synth_rows8(const int32_t* residual, int32_t* out, int32_t n,
                        const int32_t* parcor_coef, int32_t p,
                        const int32_t* pitch8, const int32_t* ltm,
                        int32_t num_taps, int32_t lms_order) {
  return synth_rowsT<8>(residual, out, n, parcor_coef, p, pitch8, ltm,
                        num_taps, lms_order);
}
int32_t sla_synth_rows16(const int32_t* residual, int32_t* out, int32_t n,
                         const int32_t* parcor_coef, int32_t p,
                         const int32_t* pitch8, const int32_t* ltm,
                         int32_t num_taps, int32_t lms_order) {
  return synth_rowsT<16>(residual, out, n, parcor_coef, p, pitch8, ltm,
                         num_taps, lms_order);
}
int32_t sla_synth_rows8_out(int32_t* work, int32_t n,
                            const int32_t* parcor_coef, int32_t p,
                            const int32_t* pitch8, const int32_t* ltm,
                            int32_t num_taps, int32_t lms_order,
                            int32_t* dest_base, const int64_t* dest_offs,
                            int32_t ms, int32_t shift) {
  return synth_rowsT_out<8>(work, n, parcor_coef, p, pitch8, ltm, num_taps,
                            lms_order, dest_base, dest_offs, ms, shift);
}
int32_t sla_synth_rows16_out(int32_t* work, int32_t n,
                             const int32_t* parcor_coef, int32_t p,
                             const int32_t* pitch8, const int32_t* ltm,
                             int32_t num_taps, int32_t lms_order,
                             int32_t* dest_base, const int64_t* dest_offs,
                             int32_t ms, int32_t shift) {
  return synth_rowsT_out<16>(work, n, parcor_coef, p, pitch8, ltm, num_taps,
                             lms_order, dest_base, dest_offs, ms, shift);
}
// Row-pointer (_at) forms: rows live at base + row_offs[r] (stride-L rows
// of the decoder's entropy batch, any order); synthesis runs IN PLACE so
// non-consecutive / mixed-length lane groups need no pack+scatter copies.
int32_t sla_synth_rows8_at(const int32_t* in_base, const int64_t* in_offs,
                           int32_t* out_base, const int64_t* out_offs,
                           int32_t n, const int32_t* parcor_coef, int32_t p,
                           const int32_t* pitch8, const int32_t* ltm,
                           int32_t num_taps, int32_t lms_order) {
  return synth_rowsT_at<8>(in_base, in_offs, out_base, out_offs, n,
                           parcor_coef, p, pitch8, ltm, num_taps, lms_order);
}
int32_t sla_synth_rows16_at(const int32_t* in_base, const int64_t* in_offs,
                            int32_t* out_base, const int64_t* out_offs,
                            int32_t n, const int32_t* parcor_coef, int32_t p,
                            const int32_t* pitch8, const int32_t* ltm,
                            int32_t num_taps, int32_t lms_order) {
  return synth_rowsT_at<16>(in_base, in_offs, out_base, out_offs, n,
                            parcor_coef, p, pitch8, ltm, num_taps, lms_order);
}
int32_t sla_synth_rows8_out_at(int32_t* base, const int64_t* row_offs,
                               int32_t n, const int32_t* parcor_coef,
                               int32_t p, const int32_t* pitch8,
                               const int32_t* ltm, int32_t num_taps,
                               int32_t lms_order, int32_t* dest_base,
                               const int64_t* dest_offs, int32_t ms,
                               int32_t shift) {
  return synth_rowsT_out_at<8>(base, row_offs, n, parcor_coef, p, pitch8,
                               ltm, num_taps, lms_order, dest_base,
                               dest_offs, ms, shift);
}
int32_t sla_synth_rows16_out_at(int32_t* base, const int64_t* row_offs,
                                int32_t n, const int32_t* parcor_coef,
                                int32_t p, const int32_t* pitch8,
                                const int32_t* ltm, int32_t num_taps,
                                int32_t lms_order, int32_t* dest_base,
                                const int64_t* dest_offs, int32_t ms,
                                int32_t shift) {
  return synth_rowsT_out_at<16>(base, row_offs, n, parcor_coef, p, pitch8,
                                ltm, num_taps, lms_order, dest_base,
                                dest_offs, ms, shift);
}

// Bulk block-header parse for the batch decoder (SLADecoder.c:309-420):
// walks the stream once from `offset`, parsing up to `max_blocks` block
// headers (sync, size, CRC over the full block when enable_crc, sample
// count, type, per-channel PARCOR/long-term/Rice fields).
// Outputs (arrays sized max_blocks): block byte offsets, sizes, sample
// counts, types, payload bit offsets; coef (C x (order+1)) int32 rows,
// pitch (C), ltm (C x max(T,1)) and init_rice (C) per block.
// Returns the number of blocks parsed, or the negative of an ApiResult-like
// code: -12 sync, -11 corruption, -9 insufficient data.
int64_t sla_parse_block_headers(
    const uint8_t* data, int64_t size, int64_t offset, int64_t total_samples,
    int32_t C, int32_t order, int32_t num_taps, int32_t bits_per_sample,
    int32_t enable_crc, int32_t max_block_samples, int64_t max_blocks,
    int64_t* block_offsets, int64_t* block_sizes, int32_t* num_samples_out,
    int32_t* block_types, int64_t* payload_bit_offsets,
    int32_t* coef_out /* max_blocks * C * (order+1) */,
    int32_t* pitch_out /* max_blocks * C */,
    int32_t* ltm_out /* max_blocks * C * max(T,1) */,
    uint32_t* init_rice_out /* max_blocks * C */) {
  const int32_t Tdim = num_taps > 0 ? num_taps : 1;
  int64_t done = 0;
  int64_t nb = 0;
  while (done < total_samples && nb < max_blocks) {
    if (offset + 11 > size) return -9;
    BitReader r;
    r.init(data, size, offset * 8);
    if (r.get(16) != 0xFFFF) return -12;
    int64_t block_size = (int64_t)r.get(32) + 6;
    uint32_t stored_crc = (uint32_t)r.get(16);
    if (block_size > size - offset) return -9;
    if (enable_crc) {
      // CRC16 from byte 8 to block end (defined earlier in this TU)
      uint16_t calc = sla_crc16(data + offset + 8, block_size - 8);
      if (calc != stored_crc) return -11;
    }
    int32_t nsamp = (int32_t)r.get(16);
    int32_t btype = (int32_t)r.get(2);
    if (btype > 2) return -11;  // only COMPRESS/SILENT/RAW exist: corruption
    if (nsamp == 0) return -11;  // no real encoder emits empty blocks
    // the caller-side entropy/synthesis batches are sized by the stream's
    // declared max block samples; a crafted larger count (the CRC is
    // re-stampable) would overrun those rows — corruption verdict, exactly
    // like the pure-Python twin (decoder.py parse_block_header)
    if (max_block_samples > 0 && nsamp > max_block_samples) return -11;
    block_offsets[nb] = offset;
    block_sizes[nb] = block_size;
    num_samples_out[nb] = nsamp;
    block_types[nb] = btype;
    int32_t* coef = coef_out + nb * C * (order + 1);
    int32_t* pit = pitch_out + nb * C;
    int32_t* ltm = ltm_out + nb * C * Tdim;
    uint32_t* ir = init_rice_out + nb * C;
    for (int32_t i = 0; i < C * (order + 1); ++i) coef[i] = 0;
    for (int32_t i = 0; i < C; ++i) pit[i] = 0;
    for (int32_t i = 0; i < C * Tdim; ++i) ltm[i] = 0;
    for (int32_t i = 0; i < C; ++i) ir[i] = 0;
    if (btype == 0) {  // COMPRESSDATA
      for (int32_t ch = 0; ch < C; ++ch) {
        int32_t rshift = (int32_t)r.get(4);
        for (int32_t ord = 1; ord <= order; ++ord) {
          int qbits = (ord < 4) ? 16 : 8;  // SLA_GET_PARCOR_QUANTIZE_BIT_WIDTH
          int32_t v = unzigzag((uint32_t)r.get(qbits));
          coef[ch * (order + 1) + ord] = (v << (16 - qbits)) >> rshift;
        }
        if (r.get(1)) {
          pit[ch] = (int32_t)r.get(10);
          // a real encoder only emits pitch in [taps/2+1, 255]
          // (SLAPredictor.c:866-924 walk bounds + the min-lag requirement);
          // anything else is corruption — reject instead of letting the
          // synthesis chunking loop stall on a non-positive feedback lag
          if (pit[ch] < num_taps / 2 + 1 || pit[ch] > 256) return -11;
          for (int32_t t = 0; t < num_taps; ++t) {
            int32_t q15 = unzigzag((uint32_t)r.get(16));
            ltm[ch * Tdim + t] = q15 << 16;
          }
        }
        ir[ch] = (uint32_t)r.get(bits_per_sample);
      }
    }
    payload_bit_offsets[nb] = (r.pos() + 7) & ~(int64_t)7;  // byte-align
    // a block whose declared size cannot even hold its own header would
    // put the payload cursor into the NEXT block's bytes: corruption
    if (payload_bit_offsets[nb] > (offset + block_size) * 8) return -11;
    ++nb;
    offset += block_size;
    done += nsamp;
  }
  if (done >= total_samples) return nb;
  // distinguish "out of output slots" (a valid stream can carry more,
  // smaller blocks than the caller sized for — retry with more room)
  // from genuine truncation
  return (nb >= max_blocks) ? -13 : -9;
}

// One-shot streaming block-header parse (the streaming decoder's per-block
// transition; same wire layout as the bulk walk above, SLADecoder.c:309-420,
// but on a PARTIALLY buffered block): `data` starts at the block's first
// byte and holds `size` buffered bytes — the block may extend past the
// buffer, so the CRC is checked only when the whole block is buffered
// (streaming.py semantics). Checks happen in the Python parse's program
// order so error precedence matches the pure-Python twin exactly: a read
// crossing the buffered end maps to -9 (wait for more data) BEFORE any
// corruption verdict that would have used the zero-filled value.
// Fills out_meta = {block_size, num_samples, block_type, header_bytes} and
// the per-channel field arrays. Returns 0, -12 (sync), -11 (corruption),
// -9 (header extends past the buffered bytes).
int64_t sla_parse_stream_block_header(
    const uint8_t* data, int64_t size, int32_t C, int32_t order,
    int32_t num_taps, int32_t bits_per_sample, int32_t enable_crc,
    int64_t* out_meta, int32_t* coef /* C*(order+1) */,
    int32_t* pitch /* C */, int32_t* ltm /* C*max(T,1) */,
    uint32_t* init_rice /* C */) {
  const int32_t Tdim = num_taps > 0 ? num_taps : 1;
  const int64_t size_bits = size * 8;
  BitReader r;
  r.init(data, size, 0);
  uint32_t sync = r.get(16);
  if (r.pos() > size_bits) return -9;
  if (sync != 0xFFFF) return -12;
  int64_t block_size = (int64_t)r.get(32) + 6;
  uint32_t stored_crc = (uint32_t)r.get(16);
  if (r.pos() > size_bits) return -9;
  if (enable_crc && block_size <= size) {
    if (sla_crc16(data + 8, block_size - 8) != (uint16_t)stored_crc)
      return -11;
  }
  int32_t nsamp = (int32_t)r.get(16);
  int32_t btype = (int32_t)r.get(2);
  if (r.pos() > size_bits) return -9;
  if (btype > 2) return -11;  // only COMPRESS/SILENT/RAW exist
  if (nsamp == 0) return -11;  // no real encoder emits empty blocks
  for (int32_t i = 0; i < C * (order + 1); ++i) coef[i] = 0;
  for (int32_t i = 0; i < C; ++i) pitch[i] = 0;
  for (int32_t i = 0; i < C * Tdim; ++i) ltm[i] = 0;
  for (int32_t i = 0; i < C; ++i) init_rice[i] = 0;
  if (btype == 0) {  // COMPRESSDATA
    for (int32_t ch = 0; ch < C; ++ch) {
      int32_t rshift = (int32_t)r.get(4);
      for (int32_t ord = 1; ord <= order; ++ord) {
        int qbits = (ord < 4) ? 16 : 8;  // SLA_GET_PARCOR_QUANTIZE_BIT_WIDTH
        int32_t v = unzigzag((uint32_t)r.get(qbits));
        coef[ch * (order + 1) + ord] = (v << (16 - qbits)) >> rshift;
      }
      if (r.get(1)) {
        pitch[ch] = (int32_t)r.get(10);
        // wait-for-data takes precedence over the range verdict (the
        // Python twin's BitReader raises at the over-reading get itself)
        if (r.pos() > size_bits) return -9;
        // a real encoder only emits pitch in [taps/2+1, 256]
        // (SLAPredictor.c:866-924 walk bounds + the min-lag requirement)
        if (pitch[ch] < num_taps / 2 + 1 || pitch[ch] > 256) return -11;
        for (int32_t t = 0; t < num_taps; ++t) {
          int32_t q15 = unzigzag((uint32_t)r.get(16));
          ltm[ch * Tdim + t] = q15 << 16;
        }
      }
      init_rice[ch] = (uint32_t)r.get(bits_per_sample);
    }
    if (r.pos() > size_bits) return -9;
  }
  out_meta[0] = block_size;
  out_meta[1] = nsamp;
  out_meta[2] = btype;
  out_meta[3] = (r.pos() + 7) >> 3;  // byte-aligned header size
  // header larger than its own declared block: the payload cursor would
  // start inside the next block (same check as the bulk walk)
  if (out_meta[3] > block_size) return -11;
  return 0;
}

// Zero-crossing-bracketed pitch peak search on an autocorrelation array
// (SLALongTermCalculator_CalculateCoef peak walk, SLAPredictor.c:866-924):
// scan candidate local peaks between negative->positive and
// positive->negative crossings; the first candidate whose value reaches the
// maximum peak wins (ratio threshold 1.0). Returns the pitch lag or 0.
int32_t sla_find_pitch(const double* ac, int32_t max_pitch) {
  int32_t candidates[512];
  int32_t ncand = 0;
  double max_peak = 0.0;
  int32_t i = 1;
  while (i < max_pitch && ncand < max_pitch) {
    int32_t start = i;
    while (start < max_pitch) {
      if (ac[start - 1] < 0.0 && ac[start] > 0.0) break;
      ++start;
    }
    int32_t end = start + 1;
    while (end < max_pitch) {
      if (ac[end] > 0.0 && ac[end + 1] < 0.0) break;
      ++end;
    }
    int32_t local_idx = 0;
    double local_peak = 0.0;
    for (int32_t j = start; j <= end; ++j) {
      if (ac[j] > ac[j - 1] && ac[j] > ac[j + 1] && ac[j] > local_peak) {
        local_idx = j;
        local_peak = ac[j];
      }
    }
    if (local_idx != 0 && ncand < 512) {
      candidates[ncand++] = local_idx;
      if (local_peak > max_peak) max_peak = local_peak;
    }
    i = end + 1;
  }
  if (ncand == 0) return 0;
  for (int32_t c = 0; c < ncand; ++c)
    if (ac[candidates[c]] >= max_peak) return candidates[c];
  return candidates[ncand - 1];
}

// Exact-order LPC analysis: float64 summation ORDER matters for byte
// identity (quantization rounds the last ulp), so the autocorrelation uses
// the reference's term-reuse loop structure (LPC_CalculateAutoCorrelation,
// src/SLAPredictor.c:331-388), the Levinson-Durbin recursion its serial
// dots (:253-328), and the code-length estimate its serial power sum
// (:416-468). data: windowed (+pre-emphasized) float64 samples.
// Returns parcor[0..order] and the estimated code length per sample
// (bytes). Rows with num_samples < order or silent R[0] yield zeros, as in
// SLALPCCalculator_CalculatePARCORCoefDouble (:189-239).
// Levinson-Durbin + code-length tail of the exact analysis, one row.
// Factored out so the 8-row interleaved autocorrelation variant shares the
// exact scalar arithmetic (SLAPredictor.c:253-328, 416-468 op order).
static void lpc_finish_row(const double* auto_corr, int32_t n, int32_t order,
                           int32_t bits_per_sample, double power,
                           double* parcor, double* length_per_sample) {
  constexpr double kFltEps = 1.1920928955078125e-07;   // FLT_EPSILON
  constexpr double kFltMin = 1.1754943508222875e-38;   // FLT_MIN
  constexpr double kBetaLaplace = 1.9426950408889634;  // sqrt(2 e^2)
  if (n >= order && std::fabs(auto_corr[0]) >= kFltEps) {
    double a_vec[64 + 2], e_vec[64 + 2], u_vec[64 + 2], v_vec[64 + 2];
    for (int32_t i = 0; i < order + 2; ++i) a_vec[i] = u_vec[i] = v_vec[i] = 0.0;
    a_vec[0] = 1.0;
    e_vec[0] = auto_corr[0];
    a_vec[1] = -auto_corr[1] / auto_corr[0];
    parcor[0] = 0.0;
    parcor[1] = auto_corr[1] / e_vec[0];
    e_vec[1] = auto_corr[0] + auto_corr[1] * a_vec[1];
    u_vec[0] = 1.0; u_vec[1] = 0.0;
    v_vec[0] = 0.0; v_vec[1] = 1.0;
    for (int32_t delay = 1; delay < order; ++delay) {
      SLA_DBG_ASSERT(e_vec[delay] >= 0.0f,
                     "Levinson prediction error went negative");
      double gamma = 0.0;
      for (int32_t i = 0; i < delay + 1; ++i)
        gamma += a_vec[i] * auto_corr[delay + 1 - i];
      gamma /= (-e_vec[delay]);
      SLA_DBG_ASSERT(std::fabs(gamma) < 1.0f,
                     "Levinson reflection coefficient out of range");
      e_vec[delay + 1] = (1.0 - gamma * gamma) * e_vec[delay];
      for (int32_t i = 0; i < delay; ++i)
        u_vec[i + 1] = v_vec[delay - i] = a_vec[i + 1];
      u_vec[0] = 1.0; u_vec[delay + 1] = 0.0;
      v_vec[0] = 0.0; v_vec[delay + 1] = 1.0;
      for (int32_t i = 0; i < delay + 2; ++i)
        a_vec[i] = u_vec[i] + gamma * v_vec[i];
      parcor[delay + 1] = -gamma;
    }
  }
  power *= std::pow(2.0, (double)(2 * (bits_per_sample - 1)));
  if (std::fabs(power) <= kFltMin) {
    *length_per_sample = 0.0;
    return;
  }
  // SLAUtility_Log2 is log(x) * INV_LOGE2, NOT libm log2 — they differ
  // in the last ulp for ~19% of inputs and this estimate feeds partition
  // and raw-fallback decisions (SLAUtility.c:442-446)
  double log2_mean = sla_ref_log2(power) - sla_ref_log2((double)n);
  double log2_var = 0.0;
  for (int32_t ord = 1; ord <= order; ++ord)
    log2_var += sla_ref_log2(1.0 - parcor[ord] * parcor[ord]);
  double len = kBetaLaplace + 0.5 * (log2_mean + log2_var);
  len /= 8.0;
  if (len <= 0) len = 1.0 / 8;
  *length_per_sample = len;
}

// Eight rows of the exact analysis at once: the O(n*order) autocorrelation
// (the reference's term-reuse loop structure, SLAPredictor.c:331-388) runs
// rows interleaved through 8-wide vectors — per-row operation order is
// untouched, exactly like four1_v8 vs four1 — then the O(order^2) Levinson
// tail runs scalar per row. data: 8 x n row-major.
// window: per-sample window values (n doubles) applied during the
// interleave fill, or NULL for raw rows; emphasis applies the double
// pre-emphasis x[i] -= x[i-1] * 31/32 on the windowed values (the
// SLAEncoder.c:540-543 analysis preprocessing, fused here so the caller
// skips three full passes over the batch). Per-element float64 ops and
// order match the unfused form exactly.
// Core with per-row source offsets into one base buffer, so callers can
// analyze rows that live as slices of a larger (C, N) signal without a
// gather copy (same fill arithmetic as the contiguous entry).
// Optional int32 source for the interleave fill: when ibase is set, row r
// reads the ORIGINAL int32 signal and converts on the fly with exactly
// convert_ms's float64 arithmetic (x*2^-31, (l+r)/2, l-r — every step
// exact, so the fill sees bit-identical doubles without the whole-file
// float64 array). modes[r]: 0 = raw at ibase+offs[r]; 1/2 = MS mid/side
// from the channel rows at ibase+offs[r] and ibase+offs[r]+icstride.
static int32_t lpc_analyze_rows8_core(const double* base, const int64_t* offs,
                                      int32_t n, int32_t order,
                                      int32_t bits_per_sample,
                                      const double* window, int32_t emphasis,
                                      double* parcor,
                                      double* length_per_sample,
                                      const int32_t* ibase = nullptr,
                                      int64_t icstride = 0,
                                      const int32_t* modes = nullptr) {
  if (order < 1 || order > 64) return -1;
  enum { R = 8 };
  constexpr double kEmph = 31.0 / 32.0;  // (2^5 - 1) * 2^-5, exact
  const double kScale = std::ldexp(1.0, -31);  // 2^-31, exact
  static thread_local std::vector<double> wbuf;
  wbuf.resize((size_t)n * R + R);
  double* w = wbuf.data();
  w += ((64 - ((uintptr_t)w & 63)) & 63) / sizeof(double);  // 64B-align
  double prev[R] = {0.0};
  for (int32_t i = 0; i < n; ++i) {
    double cur[R];
    for (int32_t r = 0; r < R; ++r) {
      double v;
      if (!ibase) {
        v = base[offs[r] + i];
      } else if (modes[r] == 0) {
        v = (double)ibase[offs[r] + i] * kScale;
      } else {
        const double dl = (double)ibase[offs[r] + i] * kScale;
        const double dr = (double)ibase[offs[r] + icstride + i] * kScale;
        v = (modes[r] == 1) ? (dl + dr) / 2.0 : dl - dr;
      }
      if (window) v *= window[i];
      cur[r] = v;
    }
    if (emphasis) {
      for (int32_t r = 0; r < R; ++r)
        w[(size_t)i * R + r] = (i > 0) ? cur[r] - prev[r] * kEmph : cur[r];
      for (int32_t r = 0; r < R; ++r) prev[r] = cur[r];
    } else {
      for (int32_t r = 0; r < R; ++r) w[(size_t)i * R + r] = cur[r];
    }
  }
  const v8df* d = (const v8df*)w;

  v8df auto_corr[64 + 1];
  const v8df zero = v8splat(0.0);
  int32_t lags = order + 1;
  if (lags > n) lags = n;
  for (int32_t i = 0; i <= order; ++i) auto_corr[i] = zero;
  if (n >= order) {
    v8df acc0 = zero;
    for (int32_t i = 0; i < n; ++i) acc0 = acc0 + d[i] * d[i];
    auto_corr[0] = acc0;
    for (int32_t lag = 1; lag < lags; ++lag) {
      const int32_t lag2 = lag << 1;
      int32_t L = (3 * lag < n) ? 1 + (n - 3 * lag) / lag2 : 0;
      int32_t Llag2 = L * lag2;
      v8df acc = zero;
      for (int32_t i = 0; i < lag; ++i)
        for (int32_t l = 0; l < Llag2; l += lag2)
          acc = acc + d[l + lag + i] * (d[l + i] + d[l + lag2 + i]);
      for (int32_t i = 0; i < n - Llag2 - lag; ++i)
        acc = acc + d[Llag2 + lag + i] * d[Llag2 + i];
      auto_corr[lag] = acc;
    }
  }
  // power has the same accumulation order as auto_corr[0] (the scalar code
  // computes the identical sum twice); when n < order the autocorrelation
  // is skipped, so compute it directly then
  v8df powerv = auto_corr[0];
  if (n < order) {
    v8df acc = zero;
    for (int32_t i = 0; i < n; ++i) acc = acc + d[i] * d[i];
    powerv = acc;
  }
  double ac_row[64 + 1];
  for (int32_t r = 0; r < R; ++r) {
    for (int32_t i = 0; i <= order; ++i) {
      ac_row[i] = auto_corr[i][r];
      parcor[(size_t)r * (order + 1) + i] = 0.0;
    }
    lpc_finish_row(ac_row, n, order, bits_per_sample, powerv[r],
                   parcor + (size_t)r * (order + 1), length_per_sample + r);
  }
  return 0;
}

int32_t sla_lpc_analyze_rows8(const double* data, int32_t n, int32_t order,
                              int32_t bits_per_sample, const double* window,
                              int32_t emphasis, double* parcor,
                              double* length_per_sample) {
  int64_t offs[8];
  for (int r = 0; r < 8; ++r) offs[r] = (int64_t)r * n;
  return lpc_analyze_rows8_core(data, offs, n, order, bits_per_sample, window,
                                emphasis, parcor, length_per_sample);
}

// Offsets form of the batched analysis: rows live at base + row_offs[b]
// (each n doubles), e.g. window slices of one (C, N) signal — no gather
// copy. Tail groups pad with row 0 (lane results past B are discarded).
static int32_t lpc_analyze_rows_off_mt_impl(
    const double* base, const int32_t* ibase, int64_t icstride,
    const int32_t* row_modes, const int64_t* row_offs,
    int32_t B, int32_t n, int32_t order, int32_t bits_per_sample,
    const double* window, int32_t emphasis,
    double* parcor /* B x (order+1) */,
    double* length_per_sample /* B */) {
  if (order < 1 || order > 64) return -1;
  const int32_t G = (B + 7) / 8;
  const int T0 = entropy_threads();
  const int T = T0 > G ? (G > 0 ? G : 1) : T0;
  std::atomic<int32_t> err{0};
  auto run_range = [&](int32_t g0, int32_t g1) {
    for (int32_t g = g0; g < g1; ++g) {
      const int32_t b = g * 8;
      if (b + 8 <= B) {
        if (lpc_analyze_rows8_core(base, row_offs + b, n, order,
                                   bits_per_sample, window, emphasis,
                                   parcor + (int64_t)b * (order + 1),
                                   length_per_sample + b, ibase, icstride,
                                   row_modes ? row_modes + b : nullptr) != 0)
          err.store(-1);
        continue;
      }
      const int32_t tail = B - b;
      int64_t offs8[8];
      int32_t modes8[8] = {0};
      for (int32_t r = 0; r < 8; ++r) {
        offs8[r] = row_offs[r < tail ? b + r : b];
        if (row_modes) modes8[r] = row_modes[r < tail ? b + r : b];
      }
      double pc8[8 * 65], ln8[8];
      if (lpc_analyze_rows8_core(base, offs8, n, order, bits_per_sample,
                                 window, emphasis, pc8, ln8, ibase, icstride,
                                 row_modes ? modes8 : nullptr) != 0) {
        err.store(-1);
        continue;
      }
      std::memcpy(parcor + (int64_t)b * (order + 1), pc8,
                  sizeof(double) * (size_t)tail * (order + 1));
      std::memcpy(length_per_sample + b, ln8, sizeof(double) * (size_t)tail);
    }
  };
  if (T > 1 && G >= 2 * T) {
    std::vector<std::thread> ws;
    for (int t = 0; t < T; ++t)
      ws.emplace_back(run_range, (int32_t)((int64_t)G * t / T),
                      (int32_t)((int64_t)G * (t + 1) / T));
    for (auto& th : ws) th.join();
  } else {
    run_range(0, G);
  }
  return err.load();
}

int32_t sla_lpc_analyze_rows_off_mt(const double* base, const int64_t* row_offs,
                                    int32_t B, int32_t n, int32_t order,
                                    int32_t bits_per_sample,
                                    const double* window, int32_t emphasis,
                                    double* parcor /* B x (order+1) */,
                                    double* length_per_sample /* B */) {
  return lpc_analyze_rows_off_mt_impl(base, nullptr, 0, nullptr, row_offs, B,
                                      n, order, bits_per_sample, window,
                                      emphasis, parcor, length_per_sample);
}

// int32-source form: rows read the ORIGINAL int32 signal and convert on
// the fly (see lpc_analyze_rows8_core). row_modes[b]: 0 raw, 1 mid, 2 side.
int32_t sla_lpc_analyze_rows_off_i32_mt(
    const int32_t* base, int64_t cstride, const int64_t* row_offs,
    const int32_t* row_modes, int32_t B, int32_t n, int32_t order,
    int32_t bits_per_sample, const double* window, int32_t emphasis,
    double* parcor /* B x (order+1) */, double* length_per_sample /* B */) {
  return lpc_analyze_rows_off_mt_impl(nullptr, base, cstride, row_modes,
                                      row_offs, B, n, order, bits_per_sample,
                                      window, emphasis, parcor,
                                      length_per_sample);
}

// Whole-batch exact LPC analysis: groups of 8 rows through the
// interleaved kernel (zero-padded tail group — zero rows analyze to zero
// coefficients / zero length), sharded across worker threads on
// multi-core hosts (rows are independent). data: B x n contiguous.
int32_t sla_lpc_analyze_rows_mt(const double* data, int32_t B, int32_t n,
                                int32_t order, int32_t bits_per_sample,
                                const double* window, int32_t emphasis,
                                double* parcor /* B x (order+1) */,
                                double* length_per_sample /* B */) {
  if (order < 1 || order > 64) return -1;
  const int32_t G = (B + 7) / 8;  // 8-row groups, last zero-padded
  const int T0 = entropy_threads();
  const int T = T0 > G ? (G > 0 ? G : 1) : T0;
  std::atomic<int32_t> err{0};
  auto run_range = [&](int32_t g0, int32_t g1) {
    std::vector<double> pad;  // per-thread tail scratch
    for (int32_t g = g0; g < g1; ++g) {
      const int32_t b = g * 8;
      if (b + 8 <= B) {
        if (sla_lpc_analyze_rows8(data + (int64_t)b * n, n, order,
                                  bits_per_sample, window, emphasis,
                                  parcor + (int64_t)b * (order + 1),
                                  length_per_sample + b) != 0)
          err.store(-1);
        continue;
      }
      const int32_t tail = B - b;
      pad.assign((size_t)8 * n, 0.0);
      std::memcpy(pad.data(), data + (int64_t)b * n,
                  sizeof(double) * (size_t)tail * n);
      double pc8[8 * 65], ln8[8];
      if (sla_lpc_analyze_rows8(pad.data(), n, order, bits_per_sample,
                                window, emphasis, pc8, ln8) != 0) {
        err.store(-1);
        continue;
      }
      std::memcpy(parcor + (int64_t)b * (order + 1), pc8,
                  sizeof(double) * (size_t)tail * (order + 1));
      std::memcpy(length_per_sample + b, ln8, sizeof(double) * (size_t)tail);
    }
  };
  if (T > 1 && G >= 2 * T) {
    std::vector<std::thread> ws;
    for (int t = 0; t < T; ++t)
      ws.emplace_back(run_range, (int32_t)((int64_t)G * t / T),
                      (int32_t)((int64_t)G * (t + 1) / T));
    for (auto& th : ws) th.join();
  } else {
    run_range(0, G);
  }
  return err.load();
}

// Whole-batch long-term autocorrelation: 8-row interleaved exact FFTs,
// zero-padded tail group, sharded across worker threads (per-thread FFT
// work buffers; the twiddle tables are thread_local).
int32_t sla_longterm_autocorr_rows_mt(const int32_t* data,
                                      const int32_t* lengths, int32_t B,
                                      int32_t row_stride, int32_t fft_size,
                                      double* out, int32_t out_lags) {
  const int32_t G = (B + 7) / 8;
  const int T0 = entropy_threads();
  const int T = T0 > G ? (G > 0 ? G : 1) : T0;
  auto run_range = [&](int32_t g0, int32_t g1) {
    std::vector<double> workv((size_t)fft_size * 8 + 8);
    double* work = workv.data();
    work += ((64 - ((uintptr_t)work & 63)) & 63) / sizeof(double);
    std::vector<int32_t> padd;
    for (int32_t g = g0; g < g1; ++g) {
      const int32_t b = g * 8;
      if (b + 8 <= B) {
        sla_longterm_autocorr_rows8(data + (int64_t)b * row_stride,
                                    lengths + b, row_stride, work, fft_size,
                                    out + (int64_t)b * out_lags, out_lags);
        continue;
      }
      const int32_t tail = B - b;
      padd.assign((size_t)8 * row_stride, 0);
      std::memcpy(padd.data(), data + (int64_t)b * row_stride,
                  sizeof(int32_t) * (size_t)tail * row_stride);
      int32_t lens8[8] = {0};
      std::memcpy(lens8, lengths + b, sizeof(int32_t) * (size_t)tail);
      std::vector<double> out8((size_t)8 * out_lags);
      sla_longterm_autocorr_rows8(padd.data(), lens8, row_stride, work,
                                  fft_size, out8.data(), out_lags);
      std::memcpy(out + (int64_t)b * out_lags, out8.data(),
                  sizeof(double) * (size_t)tail * out_lags);
    }
  };
  if (T > 1 && G >= 2 * T) {
    std::vector<std::thread> ws;
    for (int t = 0; t < T; ++t)
      ws.emplace_back(run_range, (int32_t)((int64_t)G * t / T),
                      (int32_t)((int64_t)G * (t + 1) / T));
    for (auto& th : ws) th.join();
  } else {
    run_range(0, G);
  }
  return 0;
}

int32_t sla_lpc_analyze(const double* data, int32_t n, int32_t order,
                        int32_t bits_per_sample, double* parcor,
                        double* length_per_sample) {
  if (order < 1 || order > 64) return -1;  // scratch capacity bound
  for (int32_t i = 0; i <= order; ++i) parcor[i] = 0.0;

  // term-reuse autocorrelation (the reference's exact loop structure and
  // summation order, SLAPredictor.c:331-388)
  double auto_corr[64 + 1];
  for (int32_t i = 0; i <= order; ++i) auto_corr[i] = 0.0;
  if (n >= order) {
    int32_t lags = order + 1;
    if (lags > n) lags = n;
    for (int32_t i = 0; i < n; ++i) auto_corr[0] += data[i] * data[i];
    for (int32_t lag = 1; lag < lags; ++lag) {
      const int32_t lag2 = lag << 1;
      int32_t L = (3 * lag < n) ? 1 + (n - 3 * lag) / lag2 : 0;
      int32_t Llag2 = L * lag2;
      for (int32_t i = 0; i < lag; ++i)
        for (int32_t l = 0; l < Llag2; l += lag2)
          auto_corr[lag] += data[l + lag + i] * (data[l + i] + data[l + lag2 + i]);
      for (int32_t i = 0; i < n - Llag2 - lag; ++i)
        auto_corr[lag] += data[Llag2 + lag + i] * data[Llag2 + i];
    }
  }
  double power = 0.0;
  for (int32_t i = 0; i < n; ++i) power += data[i] * data[i];
  // Levinson-Durbin + code-length: ONE shared implementation with the
  // 8-row path (byte-identity-critical float64 — never fork this tail)
  lpc_finish_row(auto_corr, n, order, bits_per_sample, power, parcor,
                 length_per_sample);
  return 0;
}

// Window generation with libm trig (SLAUtility_Make*Window,
// src/SLAUtility.c:99-216): NumPy's vectorized sin/cos differs from libm
// in the last ulp, which leaks into quantized coefficients.
// type: 0=rect 1=sin 2=hann 3=blackman 4=vorbis (SLA.h:52-58);
// 5=tukey(alpha 0.5) exists in SLAUtility but is not encoder-selectable.
int32_t sla_make_window(int32_t type, int32_t n, double* w) {
  const double kPi = 3.14159265358979323846;
  if (n == 1) { w[0] = 1.0; return 0; }
  switch (type) {
    case 0:
      for (int32_t i = 0; i < n; ++i) w[i] = 1.0;
      break;
    case 1:
      for (int32_t i = 0; i < n; ++i) {
        double x = (double)i / (n - 1);
        w[i] = std::sin(kPi * x);
      }
      break;
    case 2:
      for (int32_t i = 0; i < n; ++i) {
        double x = (double)i / (n - 1);
        w[i] = 0.5 - 0.5 * std::cos(2.0 * kPi * x);
      }
      break;
    case 3:
      for (int32_t i = 0; i < n; ++i) {
        double x = (double)i / (n - 1);
        // 0.42f / 0.08f: the reference uses FLOAT literals promoted to
        // double (SLAUtility.c:147) — the double-literal values differ at
        // ~1e-8 and every window sample with them
        w[i] = (double)0.42f - 0.5 * std::cos(2.0 * kPi * x) +
               (double)0.08f * std::cos(4.0 * kPi * x);
      }
      break;
    case 4:
      for (int32_t i = 0; i < n; ++i) {
        double x = (double)i / (n - 1);
        // association as in the reference: ((pi/2) * sin) * sin
        w[i] = std::sin((kPi / 2.0) * std::sin(kPi * x) * std::sin(kPi * x));
      }
      break;
    case 5: {  // Tukey, alpha = 0.5 (SLAUtility.c MakeTukeyWindow)
      const double alpha = 0.5;
      for (int32_t i = 0; i < n; ++i) {
        double x = (double)i / (n - 1);
        if (x < alpha / 2.0)
          w[i] = 0.5 * (1.0 + std::cos(kPi * ((2.0 / alpha) * x - 1.0)));
        else if (x > 1.0 - alpha / 2.0)
          w[i] = 0.5 * (1.0 + std::cos(kPi * ((2.0 / alpha) * x - (2.0 / alpha) + 1.0)));
        else
          w[i] = 1.0;
      }
      break;
    }
    default:
      return -1;
  }
  return 0;
}

// Final decode assembly: per block, MS inverse (when ms) + left shift
// from the synthesis rows (base pointer + row stride) straight into the
// caller's (C, total) PCM buffer at dst_offs[w] samples — one pass
// replaces the per-block stack/astype/shift/concatenate chain
// (SLADecoder.c:540-556 semantics; int32 wrap needs -fwrapv).
void sla_ms_shift_blocks(const uint64_t* src_ptrs, const int64_t* src_strides,
                         const int64_t* dst_offs, const int32_t* ns,
                         int32_t W, int32_t C, int64_t dst_stride,
                         int32_t shift, int32_t ms, int32_t* dst) {
  for (int32_t w = 0; w < W; ++w) {
    const int32_t* src = (const int32_t*)(uintptr_t)src_ptrs[w];
    const int64_t st = src_strides[w];
    const int32_t n = ns[w];
    const int64_t off = dst_offs[w];
    if (ms && C == 2) {
      const int32_t* m = src;
      const int32_t* sd = src + st;
      int32_t* dl = dst + off;
      int32_t* dr = dst + dst_stride + off;
      for (int32_t i = 0; i < n; ++i) {
        const int32_t full_mid = (m[i] << 1) | (sd[i] & 1);
        dl[i] = ((full_mid + sd[i]) >> 1) << shift;
        dr[i] = ((full_mid - sd[i]) >> 1) << shift;
      }
    } else {
      for (int32_t ch = 0; ch < C; ++ch) {
        const int32_t* s = src + (int64_t)ch * st;
        int32_t* d = dst + (int64_t)ch * dst_stride + off;
        for (int32_t i = 0; i < n; ++i) d[i] = s[i] << shift;
      }
    }
  }
}

// Per-block, per-channel max/min over views of the whole-file signal:
// one pass feeds both the silence scan (max==min==0) and the data
// bit-width -> PARCOR rshift derivation (SLAEncoder.c:519-528, 567-589).
// base: C x stride row-major; offsets/ns: W blocks. mx/mn: W x C.
void sla_block_stats(const int32_t* base, int64_t stride, int32_t C,
                     const int64_t* offsets, const int32_t* ns, int32_t W,
                     int32_t* mx, int32_t* mn) {
  for (int32_t w = 0; w < W; ++w) {
    for (int32_t ch = 0; ch < C; ++ch) {
      const int32_t* x = base + (int64_t)ch * stride + offsets[w];
      const int32_t n = ns[w];
      int32_t hi = INT32_MIN, lo = INT32_MAX;
      for (int32_t s = 0; s < n; ++s) {
        hi = x[s] > hi ? x[s] : hi;
        lo = x[s] < lo ? x[s] : lo;
      }
      mx[(int64_t)w * C + ch] = n > 0 ? hi : 0;
      mn[(int64_t)w * C + ch] = n > 0 ? lo : 0;
    }
  }
}

// Long-term analysis decision pass over many rows: pitch detection,
// Toeplitz normal equations via the exact LU solver, and the stability
// clamp (SLAPredictor.c:866-980), exactly as the per-row Python loop it
// replaces. ac: B x lags; pitch_out: B; coef_out: B x num_taps. Rows whose
// predictor is disabled (silent / no peak / short lag / singular /
// non-finite) get pitch 0 and zero coefficients.
int32_t sla_longterm_post(const double* ac, int32_t B, int32_t lags,
                          int32_t num_taps, int32_t max_period,
                          int32_t* pitch_out, double* coef_out) {
  if (num_taps < 1 || num_taps > 64) return -1;
  const double kFltMin = 1.1754943508222875e-38;  // FLT_MIN
  const int32_t T = num_taps;
  for (int32_t b = 0; b < B; ++b) {
    const double* acr = ac + (int64_t)b * lags;
    double* coef = coef_out + (int64_t)b * T;
    for (int32_t j = 0; j < T; ++j) coef[j] = 0.0;
    pitch_out[b] = 0;
    if (std::fabs(acr[0]) <= kFltMin) continue;
    int32_t pitch = sla_find_pitch(acr, max_period);
    if (pitch == 0 || pitch < T / 2 + 1 || pitch >= max_period) continue;
    double R[64 * 64];
    for (int32_t j = 0; j < T; ++j)
      for (int32_t k = 0; k < T; ++k)
        R[j * T + k] = acr[j > k ? j - k : k - j];
    for (int32_t j = 0; j < T; ++j) coef[j] = acr[pitch - T / 2 + j];
    if (sla_lesolve(R, coef, T, 2) != 0) {
      for (int32_t j = 0; j < T; ++j) coef[j] = 0.0;
      continue;
    }
    bool finite = true;
    double abs_sum = 0.0;
    for (int32_t j = 0; j < T; ++j) {
      if (!std::isfinite(coef[j])) finite = false;
      abs_sum += std::fabs(coef[j]);
    }
    if (!finite) {
      for (int32_t j = 0; j < T; ++j) coef[j] = 0.0;
      continue;
    }
    if (abs_sum >= 1.0) {  // stability clamp: single-tap fallback
      for (int32_t j = 0; j < T; ++j) coef[j] = 0.0;
      coef[T / 2] = acr[pitch] / acr[0];
    }
    pitch_out[b] = pitch;
  }
  return 0;
}

// Long-term analysis autocorrelation via Wiener-Khinchin with the exact
// reference arithmetic (SLALongTermCalculator_CalculateCoef,
// src/SLAPredictor.c:827-853): int32 samples scaled by 2^-31, forward real
// FFT, power spectrum (DC/Nyquist squared in place), inverse real FFT
// (unnormalized). Writes the first `out_lags` lags to out.
void sla_longterm_autocorr(const int32_t* data, int32_t num_samples,
                           double* work, int32_t fft_size, double* out,
                           int32_t out_lags) {
  const double scale = std::ldexp(1.0, -31);  // 2^-31, exact
  for (int i = 0; i < fft_size; ++i)
    work[i] = (i < num_samples) ? (double)data[i] * scale : 0.0;
  sla_fft(work, (uint32_t)fft_size, 1);
  work[0] *= work[0];
  work[1] *= work[1];
  for (int i = 1; i < fft_size / 2; ++i) {
    double re = work[2 * i], im = work[2 * i + 1];
    work[2 * i] = re * re + im * im;
    work[2 * i + 1] = 0.0;
  }
  sla_fft(work, (uint32_t)fft_size, -1);
  for (int i = 0; i < out_lags; ++i) out[i] = work[i];
}

// Fused whole-file sample conversion (SLAEncoder.c:381-390 double scale,
// :505-512 int32 shift): one pass over the canonical left-justified int32
// input producing (a) the int32 view shifted right by shift_a, (b)
// optionally a second int32 view at shift_b, and (c) optionally the float64
// signal scaled by 2^-31 — each mid/side-transformed when ms != 0
// (SLAUtility.c:370-412; int32 wrap needs -fwrapv). Replaces five-plus
// NumPy passes (shift, astype, mid, side, scale) with one read of the
// source per pair of rows.
int32_t sla_convert_ms(const int32_t* data, int32_t C, int64_t N,
                       int32_t shift_a, int32_t* out_a, int32_t shift_b,
                       int32_t* out_b, double* out_d, int32_t ms) {
  const double scale = std::ldexp(1.0, -31);  // 2^-31, exact
  if (ms) {
    if (C != 2) return -1;
    const int32_t* lft = data;
    const int32_t* rgt = data + N;
    for (int64_t i = 0; i < N; ++i) {
      const int32_t l = lft[i], r = rgt[i];
      {
        const int32_t la = l >> shift_a, ra = r >> shift_a;
        // exact int32 mean: (la + ra) >> 1 without the int64 temp
        out_a[i] = (la >> 1) + (ra >> 1) + (la & ra & 1);
        out_a[N + i] = la - ra;  // wraps like the reference's int32 C
      }
      if (out_b) {
        const int32_t lb = l >> shift_b, rb = r >> shift_b;
        out_b[i] = (lb >> 1) + (rb >> 1) + (lb & rb & 1);
        out_b[N + i] = lb - rb;
      }
      if (out_d) {
        const double dl = (double)l * scale, dr = (double)r * scale;
        out_d[i] = (dl + dr) / 2.0;
        out_d[N + i] = dl - dr;
      }
    }
    return 0;
  }
  for (int32_t c = 0; c < C; ++c) {
    const int32_t* x = data + (int64_t)c * N;
    int32_t* oa = out_a + (int64_t)c * N;
    int32_t* ob = out_b ? out_b + (int64_t)c * N : nullptr;
    double* od = out_d ? out_d + (int64_t)c * N : nullptr;
    for (int64_t i = 0; i < N; ++i) {
      const int32_t v = x[i];
      oa[i] = v >> shift_a;
      if (ob) ob[i] = v >> shift_b;
      if (od) od[i] = (double)v * scale;
    }
  }
  return 0;
}

}  // extern "C"
