// XTC/TRR trajectory codec for gorder-tpu.
//
// Implements the GROMACS XDR trajectory formats from the public spec:
//   * XTC: big-endian XDR framing + the classic "3dfc" integer compression
//     (magic-int table, MSB-first bit packing, small-delta runs with the
//     water-pair swap). Behavioral reference: the xdrfile C library that the
//     reference consumes through groan_rs (SURVEY.md §2.6 item 1).
//   * TRR: uncompressed big-endian records (float or double reals).
//
// Design goals (single host core feeding a TPU):
//   - mmap + two-phase access: O(1)-per-frame index scan, then decode of an
//     arbitrary subset of frames/atoms ("first_n" early-stop: gorder only
//     needs the Master-group atoms, which callers arrange to be a prefix
//     whenever possible).
//   - 64-bit bit-buffer reader; the grouped-int codec decodes the whole
//     bit-field as one uint64 and splits it with two div/mods instead of
//     per-byte long division where possible.
//   - optional std::thread fan-out across frames (frames are independent).
//
// C ABI only; wrapped from Python with ctypes (io/native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <limits>
#include <type_traits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

// ----------------------------------------------------------------- constants

constexpr int32_t XTC_MAGIC = 1995;
constexpr int32_t TRR_MAGIC = 1993;
constexpr int FIRSTIDX = 9;

constexpr int MAGICINTS[] = {
    0,       0,       0,       0,       0,        0,        0,        0,
    0,       8,       10,      12,      16,       20,       25,       32,
    40,      50,      64,      80,      101,      128,      161,      203,
    256,     322,     406,     512,     645,      812,      1024,     1290,
    1625,    2048,    2580,    3250,    4096,     5060,     6501,     8192,
    10321,   13003,   16384,   20642,   26007,    32768,    41285,    52015,
    65536,   82570,   104031,  131072,  165140,   208063,   262144,   330280,
    416127,  524287,  660561,  832255,  1048576,  1321122,  1664510,  2097152,
    2642245, 3329021, 4194304, 5284491, 6658042,  8388607,  10568983, 13316085,
    16777216};
constexpr int LASTIDX = (int)(sizeof(MAGICINTS) / sizeof(int)) - 1;

thread_local std::string g_error;

void set_error(const std::string &msg) { g_error = msg; }

// ------------------------------------------------------------------ file map

struct MappedFile {
  const uint8_t *data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char *path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) {
      set_error(std::string("could not open '") + path + "'");
      return false;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
      set_error(std::string("could not stat '") + path + "'");
      ::close(fd);
      fd = -1;
      return false;
    }
    size = (size_t)st.st_size;
    if (size == 0) {
      data = nullptr;
      return true;
    }
    void *p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      set_error(std::string("could not mmap '") + path + "'");
      ::close(fd);
      fd = -1;
      return false;
    }
    madvise(p, size, MADV_SEQUENTIAL);
    data = (const uint8_t *)p;
    return true;
  }

  ~MappedFile() {
    if (data) munmap((void *)data, size);
    if (fd >= 0) ::close(fd);
  }
};

// ------------------------------------------------------------ XDR primitives

inline uint32_t load_be32(const uint8_t *p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

inline uint64_t load_be64(const uint8_t *p) {
  return ((uint64_t)load_be32(p) << 32) | load_be32(p + 4);
}

struct Reader {
  const uint8_t *p;
  const uint8_t *end;

  bool need(size_t n) const { return (size_t)(end - p) >= n; }

  bool read_i32(int32_t *out) {
    if (!need(4)) return false;
    *out = (int32_t)load_be32(p);
    p += 4;
    return true;
  }

  bool read_f32(float *out) {
    if (!need(4)) return false;
    uint32_t bits = load_be32(p);
    p += 4;
    memcpy(out, &bits, 4);
    return true;
  }

  bool read_f64(double *out) {
    if (!need(8)) return false;
    uint64_t bits = load_be64(p);
    p += 8;
    memcpy(out, &bits, 8);
    return true;
  }

  bool skip(size_t n) {
    if (!need(n)) return false;
    p += n;
    return true;
  }
};

// ------------------------------------------------------------- bit streaming

// MSB-first bit reader over a byte buffer (the xdrfile packing order).
struct BitReader {
  const uint8_t *p;
  const uint8_t *end;
  uint64_t acc = 0;  // bits live in the low `nbits` positions
  int nbits = 0;
  bool overrun = false;

  BitReader(const uint8_t *data, size_t len) : p(data), end(data + len) {}

  inline void fill() {
    if (nbits <= 56 && (size_t)(end - p) >= 8) {
      // bulk refill: one unaligned big-endian load replaces the byte loop
      int take = (63 - nbits) >> 3;  // bytes that fit into the accumulator
      uint64_t chunk = load_be64(p) >> (64 - 8 * take);
      acc = (acc << (8 * take)) | chunk;
      nbits += 8 * take;
      p += take;
      return;
    }
    while (nbits <= 56) {
      uint8_t byte = 0;
      if (p < end) {
        byte = *p++;
      } else if (nbits <= 0) {
        overrun = true;
        byte = 0;
      } else {
        break;
      }
      acc = (acc << 8) | byte;
      nbits += 8;
    }
  }

  // n in [0, 32]
  inline uint32_t get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    if (nbits < n) {
      overrun = true;
      return 0;
    }
    nbits -= n;
    return (uint32_t)((acc >> nbits) & ((n >= 64 ? 0 : (uint64_t(1) << n)) - 1));
  }

  // n in [0, 64]
  inline uint64_t get64(int n) {
    if (n <= 32) return get(n);
    uint64_t hi = get(n - 32);
    uint64_t lo = get(32);
    return (hi << 32) | lo;
  }
};

// MSB-first bit writer.
struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;

  inline void put(int n, uint32_t value) {
    if (n == 0) return;
    acc = (acc << n) | (uint64_t)(value & ((n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1))));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      out.push_back((uint8_t)((acc >> nbits) & 0xFF));
    }
  }

  void flush() {
    if (nbits > 0) {
      out.push_back((uint8_t)((acc << (8 - nbits)) & 0xFF));
      nbits = 0;
    }
    acc = 0;
  }
};

// number of bits needed to represent `size` distinct values (>= 1)
inline int sizeofint(uint32_t size) {
  int bits = 0;
  uint32_t num = 1;
  while (size >= num && bits < 32) {
    bits++;
    num <<= 1;
  }
  return bits;
}

// bits needed for `n` grouped ints with the given sizes (xdrfile sizeofints)
inline int sizeofints(int n, const uint32_t *sizes) {
  uint8_t bytes[32];
  int num_of_bytes = 1;
  bytes[0] = 1;
  int num_of_bits = 0;
  for (int i = 0; i < n; i++) {
    uint32_t tmp = 0;
    int bytecnt = 0;
    for (; bytecnt < num_of_bytes; bytecnt++) {
      tmp = bytes[bytecnt] * sizes[i] + tmp;
      bytes[bytecnt] = tmp & 0xFF;
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[bytecnt++] = tmp & 0xFF;
      tmp >>= 8;
    }
    num_of_bytes = bytecnt;
  }
  uint32_t num = 1;
  num_of_bytes--;
  while ((uint32_t)bytes[num_of_bytes] >= num) {
    num_of_bits++;
    num *= 2;
  }
  return num_of_bits + num_of_bytes * 8;
}

// Decode `nbits` as the little-endian byte group used by sendints and return
// it as a single integer value (valid while the product of sizes < 2^64).
__attribute__((always_inline)) inline uint64_t
read_group_value(BitReader &br, int nbits) {
  br.fill();
  if (br.nbits >= nbits && nbits <= 56) {
    // hot path: extract the whole field at once and byte-reverse it (the
    // wire stores the group's bytes little-endian-first, MSB-first bits)
    br.nbits -= nbits;
    uint64_t field = (br.acc >> br.nbits) & ((uint64_t(1) << nbits) - 1);
    int r = nbits & 7;          // trailing partial-byte bits
    int k = nbits >> 3;         // full bytes
    uint64_t value = 0;
    if (k > 0) {
      value = __builtin_bswap64(field >> r) >> (64 - 8 * k);
    }
    if (r > 0) {
      value |= (field & ((uint64_t(1) << r) - 1)) << (8 * k);
    }
    return value;
  }
  uint64_t value = 0;
  int shift = 0;
  while (nbits >= 8) {
    value |= (uint64_t)br.get(8) << shift;
    shift += 8;
    nbits -= 8;
  }
  if (nbits > 0) {
    value |= (uint64_t)br.get(nbits) << shift;
  }
  return value;
}

// Division helper: quotient/remainder by a 32-bit divisor via a double
// reciprocal with one-step correction — exact for v < 2^52 (the decoder
// guards with `fast`), ~5x cheaper than a 64-bit hardware divide.
struct FastDiv3 {
  uint32_t s1 = 1, s2 = 1;
  double inv1 = 1.0, inv2 = 1.0;
  bool fast = false;
  int nbits = 0;

  void set(int num_of_bits, const uint32_t sizes[3]) {
    nbits = num_of_bits;
    s1 = sizes[1];
    s2 = sizes[2];
    inv1 = 1.0 / (double)s1;
    inv2 = 1.0 / (double)s2;
    fast = num_of_bits <= 52 && s1 > 0 && s2 > 0;
  }
};

inline uint64_t _div_correct(uint64_t v, uint32_t d, double inv,
                             int64_t *rem) {
  uint64_t q = (uint64_t)((double)v * inv);
  int64_t r = (int64_t)(v - q * (uint64_t)d);
  if (r < 0) {
    q--;
    r += d;
  } else if (r >= (int64_t)d) {
    q++;
    r -= d;
  }
  *rem = r;
  return q;
}

__attribute__((always_inline)) inline void
ints3_from_value(uint64_t v, const FastDiv3 &fd, const uint32_t sizes[3],
                 int32_t *nums) {
  if (fd.fast) {
    int64_t r;
    uint64_t q = _div_correct(v, fd.s2, fd.inv2, &r);
    nums[2] = (int32_t)r;
    uint64_t q2 = _div_correct(q, fd.s1, fd.inv1, &r);
    nums[1] = (int32_t)r;
    nums[0] = (int32_t)q2;
  } else {
    uint64_t q = v / sizes[2];
    nums[2] = (int32_t)(v - q * sizes[2]);
    uint64_t q2 = q / sizes[1];
    nums[1] = (int32_t)(q - q2 * sizes[1]);
    nums[0] = (int32_t)q2;
  }
}

__attribute__((always_inline)) inline void
read_ints3_fast(BitReader &br, const FastDiv3 &fd,
                const uint32_t sizes[3], int32_t *nums) {
  ints3_from_value(read_group_value(br, fd.nbits), fd, sizes, nums);
}

// Fused read of a large-atom group value plus the FOLLOWING 1-bit runflag
// in a single bit-buffer extraction (saves one fill/extract round per
// atom — the per-atom hot cost when runs are rare). Returns false when
// the single-accumulator fast path cannot serve it (wide groups or
// buffer tail); the caller then uses the two separate reads.
__attribute__((always_inline)) inline bool
read_group_and_flag(BitReader &br, int nbits, uint64_t *group,
                    uint32_t *flag) {
  if (nbits + 1 > 56) return false;
  br.fill();
  if (br.nbits < nbits + 1) return false;
  br.nbits -= nbits + 1;
  uint64_t field =
      (br.acc >> br.nbits) & ((uint64_t(1) << (nbits + 1)) - 1);
  *flag = (uint32_t)(field & 1);
  field >>= 1;
  // same little-endian-bytes-first reassembly as read_group_value
  int r = nbits & 7;
  int k = nbits >> 3;
  uint64_t value = 0;
  if (k > 0) value = __builtin_bswap64(field >> r) >> (64 - 8 * k);
  if (r > 0) value |= (field & ((uint64_t(1) << r) - 1)) << (8 * k);
  *group = value;
  return true;
}

inline void write_group_value(BitWriter &bw, int nbits, uint64_t value) {
  // bytes little-endian-first; the most significant byte carries the
  // remaining width (mirrors sendints' two cases, including zero padding)
  uint8_t bytes[9];
  int num_of_bytes = 0;
  do {
    bytes[num_of_bytes++] = (uint8_t)(value & 0xFF);
    value >>= 8;
  } while (value != 0);

  if (nbits >= num_of_bytes * 8) {
    for (int i = 0; i < num_of_bytes; i++) bw.put(8, bytes[i]);
    bw.put(nbits - num_of_bytes * 8, 0);
  } else {
    for (int i = 0; i < num_of_bytes - 1; i++) bw.put(8, bytes[i]);
    bw.put(nbits - (num_of_bytes - 1) * 8, bytes[num_of_bytes - 1]);
  }
}

// receiveints for the 3-coordinate groups, via single-uint64 fast path.
// sizes must satisfy sizes[0]*sizes[1]*sizes[2] < 2^64 (always true for real
// trajectories: the bitsize==0 escape triggers earlier).
inline void read_ints3(BitReader &br, int nbits, const uint32_t *sizes,
                       int32_t *nums) {
  uint64_t v = read_group_value(br, nbits);
  uint64_t q = v / sizes[2];
  nums[2] = (int32_t)(v - q * sizes[2]);
  uint64_t q2 = q / sizes[1];
  nums[1] = (int32_t)(q - q2 * sizes[1]);
  nums[0] = (int32_t)q2;
}

// Round-up fixed-point reciprocals: q = (v * m) >> 64 with
// m = ceil(2^64 / d) is exact floor(v/d) for v < 2^40 when d < 2^24
// (error term v·(m·d − 2^64)/(d·2^64) < v/2^64) — covers every
// small-run group value (≤ 3·24 bits never occurs; runs use ≤ ~2^33).
struct MagicMul {
  uint64_t m[73];
  MagicMul() {
    for (int i = 0; i < 73; i++) {
      uint64_t d = (uint64_t)MAGICINTS[i];
      m[i] = d > 0 ? (~uint64_t(0)) / d + 1 : 0;  // ceil(2^64/d), d not 2^k
    }
  }
};
static const MagicMul MAGIC_MUL;

inline uint64_t mulhi_div(uint64_t v, uint64_t magic) {
  return (uint64_t)(((unsigned __int128)v * magic) >> 64);
}

inline void write_ints3(BitWriter &bw, int nbits, const uint32_t *sizes,
                        const int32_t *nums) {
  uint64_t v =
      ((uint64_t)nums[0] * sizes[1] + (uint64_t)nums[1]) * sizes[2] +
      (uint64_t)nums[2];
  write_group_value(bw, nbits, v);
}

// --------------------------------------------------------------- XTC framing

struct XtcHeader {
  int32_t natoms = 0;
  int32_t step = 0;
  float time = 0;
  float box[9] = {0};
  // compressed payload
  float precision = 0;
  int32_t minint[3] = {0};
  int32_t maxint[3] = {0};
  int32_t smallidx = 0;
  const uint8_t *payload = nullptr;  // compressed bytes (or plain floats)
  int32_t nbytes = 0;                // compressed byte count
  size_t frame_size = 0;             // total frame size in the file
  bool plain = false;                // natoms <= 9 → uncompressed floats
};

bool parse_xtc_header(const uint8_t *base, size_t size, size_t offset,
                      XtcHeader *h) {
  Reader r{base + offset, base + size};
  int32_t magic;
  if (!r.read_i32(&magic)) return false;
  if (magic != XTC_MAGIC) {
    set_error("invalid XTC magic number");
    return false;
  }
  int32_t natoms_hdr;
  if (!r.read_i32(&natoms_hdr) || !r.read_i32(&h->step) || !r.read_f32(&h->time))
    return false;
  h->natoms = natoms_hdr;
  for (int i = 0; i < 9; i++)
    if (!r.read_f32(&h->box[i])) return false;
  int32_t lsize;
  if (!r.read_i32(&lsize)) return false;
  if (lsize != natoms_hdr) {
    set_error("XTC frame natoms mismatch");
    return false;
  }
  if (natoms_hdr <= 9) {
    h->plain = true;
    h->payload = r.p;
    h->nbytes = natoms_hdr * 3 * 4;
    if (!r.skip((size_t)h->nbytes)) return false;
    h->frame_size = (size_t)(r.p - (base + offset));
    return true;
  }
  if (!r.read_f32(&h->precision)) return false;
  for (int i = 0; i < 3; i++)
    if (!r.read_i32(&h->minint[i])) return false;
  for (int i = 0; i < 3; i++)
    if (!r.read_i32(&h->maxint[i])) return false;
  if (!r.read_i32(&h->smallidx)) return false;
  if (!r.read_i32(&h->nbytes)) return false;
  if (h->nbytes < 0) {
    set_error("negative XTC payload size");
    return false;
  }
  h->payload = r.p;
  size_t padded = ((size_t)h->nbytes + 3) & ~(size_t)3;
  if (!r.skip(padded)) {
    set_error("truncated XTC frame");
    return false;
  }
  h->frame_size = (size_t)(r.p - (base + offset));
  return true;
}

// Output sinks for the frame decoder: f32 positions, or raw fixed-point
// int16 (exactly the XTC integers; the device multiplies by 1/precision,
// reproducing the f32 conversion bit-for-bit while halving the transfer).
struct F32Sink {
  float *out;
  float inv_precision;
  bool ok = true;
  inline void emit(int slot, const int32_t *c) {
    out[slot * 3 + 0] = (float)c[0] * inv_precision;
    out[slot * 3 + 1] = (float)c[1] * inv_precision;
    out[slot * 3 + 2] = (float)c[2] * inv_precision;
  }
  inline void emit_plain(int slot, const float *xyz, const int32_t *) {
    out[slot * 3 + 0] = xyz[0];
    out[slot * 3 + 1] = xyz[1];
    out[slot * 3 + 2] = xyz[2];
  }
};

struct I16Sink {
  int16_t *out;
  float inv_precision;  // unused, kept for interface symmetry
  bool ok = true;
  inline void emit(int slot, const int32_t *c) {
    for (int k = 0; k < 3; k++) {
      int32_t v = c[k];
      if (v < INT16_MIN || v > INT16_MAX) ok = false;
      out[slot * 3 + k] = (int16_t)v;
    }
  }
  inline void emit_plain(int slot, const float *, const int32_t *c) {
    emit(slot, c);
  }
};

// Raw XTC integers, for the temporal-delta wire format (the packer runs on
// the scratch absolutes after the frame decodes).
struct I32Sink {
  int32_t *out;
  float inv_precision;  // unused, kept for interface symmetry
  bool ok = true;
  inline void emit(int slot, const int32_t *c) {
    out[slot * 3 + 0] = c[0];
    out[slot * 3 + 1] = c[1];
    out[slot * 3 + 2] = c[2];
  }
  inline void emit_plain(int slot, const float *, const int32_t *c) {
    emit(slot, c);
  }
};

// Subset gather: routes file atom ordinals through a slot map (compact
// selected-atom output — the TPU ships only the Master-group atoms, like
// the reference's group XTC reads, src/analysis/common.rs:283-304).
template <typename Sink>
struct SlotSink {
  Sink &inner;
  const int32_t *slot_of;  // length >= first_n; -1 = atom not selected
  inline void emit(int atom, const int32_t *c) {
    int32_t s = slot_of[atom];
    if (s >= 0) inner.emit(s, c);
  }
  inline void emit_plain(int atom, const float *xyz, const int32_t *c) {
    int32_t s = slot_of[atom];
    if (s >= 0) inner.emit_plain(s, xyz, c);
  }
};

// 12-bit two's-complement packing: two values per 3 bytes. Values are
// emitted in strictly increasing index order within a frame, so the shared
// middle byte is always written low-nibble first.
struct I12Sink {
  uint8_t *out;
  float inv_precision;  // unused, kept for interface symmetry
  bool ok = true;
  inline void put(size_t i, int32_t v) {
    if (v < -2048 || v > 2047) ok = false;
    uint32_t u = (uint32_t)v & 0xFFFu;
    uint8_t *b = out + (i >> 1) * 3;
    if ((i & 1) == 0) {
      b[0] = (uint8_t)(u & 0xFF);
      b[1] = (uint8_t)((b[1] & 0xF0) | (u >> 8));
    } else {
      b[1] = (uint8_t)((b[1] & 0x0F) | ((u & 0xF) << 4));
      b[2] = (uint8_t)(u >> 4);
    }
  }
  inline void emit(int slot, const int32_t *c) {
    size_t base = (size_t)slot * 3;
    put(base + 0, c[0]);
    put(base + 1, c[1]);
    put(base + 2, c[2]);
  }
  inline void emit_plain(int slot, const float *, const int32_t *c) {
    emit(slot, c);
  }
};

// Resumable per-frame 3dfc decoder: `step()` consumes one large atom plus
// its attached small-delta run. Exists so two frames' independent
// bit-stream dependency chains can be interleaved on one core
// (decode_xtc_coords_pair_t below): the per-value latency chain
// (bit-buffer refill → field extract → reciprocal-multiply divides) stalls
// an out-of-order core at IPC well below its width; two frames in flight
// fill the issue slots. The single-frame path runs the same step() code.
template <typename Sink>
struct CoordStepper {
  const XtcHeader *h = nullptr;
  Sink *sink = nullptr;
  int32_t natoms = 0, first_n = 0;
  uint32_t sizeint[3] = {0, 0, 0};
  uint32_t bitsizeint[3] = {0, 0, 0};
  int bitsize = 0;
  int smallidx = 0;
  int32_t smaller = 0, smallnum = 0;
  uint32_t sizesmall = 0;
  BitReader br{nullptr, 0};
  int32_t prevcoord[3] = {0, 0, 0};
  int i = 0, written = 0;
  int run = 0;  // persists across atoms: flag bit 0 = reuse previous length
  FastDiv3 fd_large;
  bool failed = false;
  const char *fail_msg = nullptr;

  bool init(const XtcHeader &hh, int32_t fn, Sink *s) {
    h = &hh;
    sink = s;
    natoms = hh.natoms;
    first_n = std::min(fn, natoms);
    for (int k = 0; k < 3; k++) {
      int64_t span = (int64_t)hh.maxint[k] - (int64_t)hh.minint[k] + 1;
      if (span <= 0 || span > (int64_t)UINT32_MAX) {
        set_error("invalid XTC integer range");
        return false;
      }
      sizeint[k] = (uint32_t)span;
    }
    if (sizeint[0] > 0xFFFFFF || sizeint[1] > 0xFFFFFF ||
        sizeint[2] > 0xFFFFFF) {
      for (int k = 0; k < 3; k++) bitsizeint[k] = sizeofint(sizeint[k]);
      bitsize = 0;
    } else {
      bitsize = sizeofints(3, sizeint);
    }
    smallidx = hh.smallidx;
    if (smallidx < FIRSTIDX || smallidx > LASTIDX) {
      set_error("invalid XTC smallidx");
      return false;
    }
    int tmpidx = smallidx - 1;
    tmpidx = (FIRSTIDX > tmpidx) ? FIRSTIDX : tmpidx;
    smaller = MAGICINTS[tmpidx] / 2;
    smallnum = MAGICINTS[smallidx] / 2;
    sizesmall = (uint32_t)MAGICINTS[smallidx];
    br = BitReader(hh.payload, (size_t)hh.nbytes);
    if (bitsize != 0) fd_large.set(bitsize, sizeint);
    return true;
  }

  inline bool done() const {
    return failed || i >= natoms || written >= first_n;
  }

  __attribute__((always_inline)) inline void emit(const int32_t *c) {
    if (written < first_n) sink->emit(written, c);
    written++;
  }

  // one large atom + its small-delta run
  inline void step() {
    int32_t thiscoord[3];
    uint32_t flag;
    uint64_t fused_v;
    if (bitsize != 0 && read_group_and_flag(br, bitsize, &fused_v, &flag)) {
      ints3_from_value(fused_v, fd_large, sizeint, thiscoord);
    } else {
      if (bitsize == 0) {
        thiscoord[0] = (int32_t)br.get(bitsizeint[0]);
        thiscoord[1] = (int32_t)br.get(bitsizeint[1]);
        thiscoord[2] = (int32_t)br.get(bitsizeint[2]);
      } else {
        read_ints3_fast(br, fd_large, sizeint, thiscoord);
      }
      flag = br.get(1);
    }
    i++;
    thiscoord[0] += h->minint[0];
    thiscoord[1] += h->minint[1];
    thiscoord[2] += h->minint[2];
    prevcoord[0] = thiscoord[0];
    prevcoord[1] = thiscoord[1];
    prevcoord[2] = thiscoord[2];

    int is_smaller = 0;
    if (flag) {
      run = (int)br.get(5);
      is_smaller = run % 3;
      run -= is_smaller;
      is_smaller--;
    }
    if (run > 0) {
      const uint32_t ss = sizesmall;
      const uint64_t ss_magic = MAGIC_MUL.m[smallidx];
      // exact while the group value < 2^64/ss, i.e. nbits = smallidx ≤ 40
      const bool ss_fast = smallidx <= 40;
      auto small3 = [&](int32_t *c) __attribute__((always_inline)) {
        uint64_t v = read_group_value(br, smallidx);
        if (ss_fast) {
          uint64_t q = mulhi_div(v, ss_magic);
          c[2] = (int32_t)(v - q * ss);
          uint64_t q2 = mulhi_div(q, ss_magic);
          c[1] = (int32_t)(q - q2 * ss);
          c[0] = (int32_t)q2;
        } else {
          uint64_t q = v / ss;
          c[2] = (int32_t)(v - q * ss);
          uint64_t q2 = q / ss;
          c[1] = (int32_t)(q - q2 * ss);
          c[0] = (int32_t)q2;
        }
      };
      // first small atom of a run is emitted BEFORE the large atom it was
      // delta-coded against (the water-pair swap) — peeled so the
      // steady-state loop below carries no per-group branch
      small3(thiscoord);
      i++;
      thiscoord[0] += prevcoord[0] - smallnum;
      thiscoord[1] += prevcoord[1] - smallnum;
      thiscoord[2] += prevcoord[2] - smallnum;
      emit(thiscoord);   // the small atom, first
      emit(prevcoord);   // then the large atom
      // the FIRST SMALL atom (not the large one) is the delta base for
      // the next group — the original swap left it in prevcoord
      prevcoord[0] = thiscoord[0];
      prevcoord[1] = thiscoord[1];
      prevcoord[2] = thiscoord[2];
      for (int k = 3; k < run; k += 3) {
        small3(thiscoord);
        i++;
        thiscoord[0] += prevcoord[0] - smallnum;
        thiscoord[1] += prevcoord[1] - smallnum;
        thiscoord[2] += prevcoord[2] - smallnum;
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];
        emit(thiscoord);
      }
    } else {
      emit(thiscoord);
    }
    smallidx += is_smaller;
    if (is_smaller < 0) {
      smallnum = smaller;
      smaller = (smallidx > FIRSTIDX) ? MAGICINTS[smallidx - 1] / 2 : 0;
    } else if (is_smaller > 0) {
      smaller = smallnum;
      smallnum = MAGICINTS[smallidx] / 2;
    }
    if (smallidx < FIRSTIDX || smallidx > LASTIDX ||
        MAGICINTS[smallidx] == 0) {
      failed = true;
      fail_msg = "corrupted XTC run encoding";
      return;
    }
    sizesmall = (uint32_t)MAGICINTS[smallidx];
  }

  bool finish() {
    if (failed) {
      set_error(fail_msg);
      return false;
    }
    if (br.overrun) {
      set_error("XTC payload overrun");
      return false;
    }
    return true;
  }
};

// Decode the compressed coordinates of one frame through `sink`.
// Returns false on corruption.
template <typename Sink>
bool decode_xtc_coords_t(const XtcHeader &h, int32_t first_n, Sink &sink) {
  const int32_t natoms = h.natoms;
  first_n = std::min(first_n, natoms);

  if (h.plain) {
    Reader r{h.payload, h.payload + h.nbytes};
    for (int i = 0; i < first_n; i++) {
      float xyz[3];
      for (int k = 0; k < 3; k++)
        if (!r.read_f32(&xyz[k])) return false;
      // plain frames carry floats; convert through the integer grid
      int32_t c[3];
      for (int k = 0; k < 3; k++)
        c[k] = (int32_t)(xyz[k] * (h.precision > 0 ? h.precision : 1000.0f));
      sink.emit_plain(i, xyz, c);
    }
    return true;
  }

  CoordStepper<Sink> d;
  if (!d.init(h, first_n, &sink)) return false;
  while (!d.done()) d.step();
  return d.finish();
}

// Decode TWO compressed frames with their bit-stream work interleaved at
// large-atom granularity — one core, two independent dependency chains in
// flight (see CoordStepper). Both sinks receive exactly what the
// sequential path would produce; falls back to sequential decoding for
// plain (uncompressed) frames. Returns false if either frame fails.
// runtime escape hatch (and A/B lever for tools/decode_bench.py):
// GORDER_XDR_PAIR=0 disables interleaved decoding, =2 pairs (default),
// =4 interleaves four frames
inline int interleave_width() {
  // read per call (a few ns per frame group): lets a process toggle it,
  // which the A/B measurement in tools/decode_bench.py relies on
  const char *e = getenv("GORDER_XDR_PAIR");
  if (!e) return 2;
  if (e[0] == '0') return 1;
  if (e[0] == '4') return 4;
  return 2;
}

inline bool pair_decode_enabled() { return interleave_width() >= 2; }

// Interleave up to W frames' decoding round-robin at large-atom
// granularity (see CoordStepper). All-or-nothing: falls back to
// sequential when any frame is plain or fails init.
template <typename Sink, int W>
bool decode_xtc_coords_multi_t(const XtcHeader *const *hs, Sink *const *sinks,
                               int m, int32_t first_n) {
  CoordStepper<Sink> S[W];
  bool plain = false;
  for (int i = 0; i < m; i++) plain = plain || hs[i]->plain;
  if (plain) {
    bool ok = true;
    for (int i = 0; i < m; i++)
      ok = decode_xtc_coords_t(*hs[i], first_n, *sinks[i]) && ok;
    return ok;
  }
  bool init_ok = true;
  for (int i = 0; i < m; i++)
    init_ok = S[i].init(*hs[i], first_n, sinks[i]) && init_ok;
  if (!init_ok) return false;
  for (bool active = true; active;) {
    active = false;
    for (int i = 0; i < m; i++) {
      if (!S[i].done()) {
        S[i].step();
        active = true;
      }
    }
  }
  bool ok = true;
  for (int i = 0; i < m; i++) ok = S[i].finish() && ok;
  return ok;
}

template <typename Sink>
bool decode_xtc_coords_pair_t(const XtcHeader &ha, Sink &sa,
                              const XtcHeader &hb, Sink &sb,
                              int32_t first_n) {
  if (ha.plain || hb.plain || !pair_decode_enabled()) {
    bool oka = decode_xtc_coords_t(ha, first_n, sa);
    bool okb = decode_xtc_coords_t(hb, first_n, sb);
    return oka && okb;
  }
  CoordStepper<Sink> A, B;
  bool oka = A.init(ha, first_n, &sa);
  bool okb = B.init(hb, first_n, &sb);
  if (!oka || !okb) return false;
  while (!A.done() && !B.done()) {
    A.step();
    B.step();
  }
  while (!A.done()) A.step();
  while (!B.done()) B.step();
  oka = A.finish();
  okb = B.finish();
  return oka && okb;
}

bool decode_xtc_coords(const XtcHeader &h, int32_t first_n, float *out) {
  F32Sink sink{out, h.plain ? 1.0f : 1.0f / h.precision};
  return decode_xtc_coords_t(h, first_n, sink);
}

// Shared frame fan-out: parse header, fill metadata, run `make_sink(f, h)`
// through the (optionally slot-mapped) coordinate decoder; frames are
// independent so they split across threads. Returns 0 / 1 (sink range
// overflow: caller falls back to a wider wire format) / -1 (corruption).
template <typename MakeSink>
int32_t decode_frames_common(const char *path, const int64_t *frame_offsets,
                             int64_t n, int32_t first_n,
                             const int32_t *slot_of, float *out_inv_precision,
                             float *out_boxes, float *out_times,
                             int32_t *out_steps, int32_t n_threads,
                             MakeSink make_sink) {
  MappedFile mf;
  if (!mf.open(path)) return -1;

  std::atomic<int32_t> status{0};
  auto work = [&](int64_t lo, int64_t hi) {
    auto prep = [&](int64_t f, XtcHeader *h) -> bool {
      if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[f], h))
        return false;
      if (out_boxes) memcpy(out_boxes + f * 9, h->box, 9 * sizeof(float));
      if (out_times) out_times[f] = h->time;
      if (out_steps) out_steps[f] = h->step;
      if (out_inv_precision)
        out_inv_precision[f] =
            h->plain ? (1.0f / 1000.0f) : 1.0f / h->precision;
      return true;
    };
    auto record = [&](bool decode_ok, bool sink_ok) -> bool {
      if (!decode_ok) {
        status.store(-1);
        return false;
      }
      if (!sink_ok) {
        int32_t expected = 0;
        status.compare_exchange_strong(expected, 1);
      }
      return true;
    };
    // frames decode in interleaved groups of up to 4: independent
    // bit-stream dependency chains keep the out-of-order core's issue
    // slots full (decode_xtc_coords_multi_t) — frame order and results
    // are untouched
    using SinkT = decltype(make_sink((int64_t)0,
                                     *(const XtcHeader *)nullptr));
    for (int64_t f = lo; f < hi;) {
      int m = (int)std::min<int64_t>((int64_t)interleave_width(), hi - f);
      XtcHeader hs[4];
      SinkT sk[4];
      const XtcHeader *hp[4];
      for (int i = 0; i < m; i++) {
        if (!prep(f + i, &hs[i])) {
          status.store(-1);
          return;
        }
        sk[i] = make_sink(f + i, hs[i]);
        hp[i] = &hs[i];
      }
      bool ok;
      if (slot_of) {
        SlotSink<SinkT> ss[4] = {{sk[0], slot_of}, {sk[1], slot_of},
                                 {sk[2], slot_of}, {sk[3], slot_of}};
        if (m == 1) {
          ok = decode_xtc_coords_t(hs[0], first_n, ss[0]);
        } else if (m == 2) {
          ok = decode_xtc_coords_pair_t(hs[0], ss[0], hs[1], ss[1], first_n);
        } else {
          SlotSink<SinkT> *sp[4] = {&ss[0], &ss[1], &ss[2], &ss[3]};
          ok = decode_xtc_coords_multi_t<SlotSink<SinkT>, 4>(hp, sp, m,
                                                             first_n);
        }
      } else {
        if (m == 1) {
          ok = decode_xtc_coords_t(hs[0], first_n, sk[0]);
        } else if (m == 2) {
          ok = decode_xtc_coords_pair_t(hs[0], sk[0], hs[1], sk[1], first_n);
        } else {
          SinkT *sp[4] = {&sk[0], &sk[1], &sk[2], &sk[3]};
          ok = decode_xtc_coords_multi_t<SinkT, 4>(hp, sp, m, first_n);
        }
      }
      bool sink_ok = true;
      for (int i = 0; i < m; i++) sink_ok = sink_ok && sk[i].ok;
      if (!record(ok, sink_ok)) return;
      f += m;
    }
  };

  int nt = std::max(1, (int)std::min<int64_t>(n_threads, n));
  if (nt == 1) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      if (lo < hi) threads.emplace_back(work, lo, hi);
    }
    for (auto &th : threads) th.join();
  }
  return status.load();
}

// ----------------------------------------------------------------- XTC write

void append_be32(std::vector<uint8_t> &v, uint32_t x) {
  v.push_back((uint8_t)(x >> 24));
  v.push_back((uint8_t)(x >> 16));
  v.push_back((uint8_t)(x >> 8));
  v.push_back((uint8_t)x);
}

void append_f32(std::vector<uint8_t> &v, float f) {
  uint32_t bits;
  memcpy(&bits, &f, 4);
  append_be32(v, bits);
}

// Compress one frame of coordinates (xdrfile-compatible encoder with
// small-delta runs and the water-pair swap).
bool encode_xtc_frame(std::vector<uint8_t> &file, int32_t natoms, int32_t step,
                      float time, const float *box9, const float *coords,
                      float precision) {
  append_be32(file, (uint32_t)XTC_MAGIC);
  append_be32(file, (uint32_t)natoms);
  append_be32(file, (uint32_t)step);
  append_f32(file, time);
  for (int i = 0; i < 9; i++) append_f32(file, box9[i]);
  append_be32(file, (uint32_t)natoms);

  if (natoms <= 9) {
    for (int i = 0; i < natoms * 3; i++) append_f32(file, coords[i]);
    return true;
  }

  append_f32(file, precision);

  std::vector<int32_t> ints((size_t)natoms * 3);
  int32_t minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
  int32_t maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
  int64_t mindiff = INT64_MAX;
  int32_t oldlint[3] = {0, 0, 0};
  for (int i = 0; i < natoms; i++) {
    int32_t lint[3];
    for (int d = 0; d < 3; d++) {
      float lf = coords[i * 3 + d] * precision;
      lf += (lf >= 0) ? 0.5f : -0.5f;
      if (lf > 2147483000.0f || lf < -2147483000.0f) {
        set_error("coordinate too large for XTC compression");
        return false;
      }
      lint[d] = (int32_t)lf;
      minint[d] = std::min(minint[d], lint[d]);
      maxint[d] = std::max(maxint[d], lint[d]);
      ints[(size_t)i * 3 + d] = lint[d];
    }
    if (i > 0) {
      int64_t diff = std::abs((int64_t)lint[0] - oldlint[0]) +
                     std::abs((int64_t)lint[1] - oldlint[1]) +
                     std::abs((int64_t)lint[2] - oldlint[2]);
      mindiff = std::min(mindiff, diff);
    }
    oldlint[0] = lint[0];
    oldlint[1] = lint[1];
    oldlint[2] = lint[2];
  }

  for (int d = 0; d < 3; d++) append_be32(file, (uint32_t)minint[d]);
  for (int d = 0; d < 3; d++) append_be32(file, (uint32_t)maxint[d]);

  int smallidx = FIRSTIDX;
  while (smallidx < LASTIDX && MAGICINTS[smallidx] < mindiff) smallidx++;
  append_be32(file, (uint32_t)smallidx);

  int maxidx = std::min(LASTIDX, smallidx + 8);
  int minidx = maxidx - 8;
  int32_t smaller = MAGICINTS[std::max(FIRSTIDX, smallidx - 1)] / 2;
  int32_t smallnum = MAGICINTS[smallidx] / 2;
  uint32_t sizesmall[3] = {(uint32_t)MAGICINTS[smallidx],
                           (uint32_t)MAGICINTS[smallidx],
                           (uint32_t)MAGICINTS[smallidx]};
  int32_t larger = MAGICINTS[maxidx] / 2;

  uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
  for (int d = 0; d < 3; d++)
    sizeint[d] = (uint32_t)((int64_t)maxint[d] - minint[d] + 1);
  int bitsize;
  if (sizeint[0] > 0xFFFFFF || sizeint[1] > 0xFFFFFF || sizeint[2] > 0xFFFFFF) {
    for (int d = 0; d < 3; d++) bitsizeint[d] = sizeofint(sizeint[d]);
    bitsize = 0;
  } else {
    bitsize = sizeofints(3, sizeint);
  }

  BitWriter bw;
  int i = 0;
  int prevrun = -1;
  int32_t *ip = ints.data();
  int32_t prevcoord[3] = {0, 0, 0};
  std::vector<int32_t> tmprun(8 * 3 + 3);

  while (i < natoms) {
    int32_t *thiscoord = ip + (size_t)i * 3;
    bool is_small = false;
    int is_smaller;
    if (smallidx < maxidx && i >= 1 &&
        std::abs(thiscoord[0] - prevcoord[0]) < larger &&
        std::abs(thiscoord[1] - prevcoord[1]) < larger &&
        std::abs(thiscoord[2] - prevcoord[2]) < larger) {
      is_smaller = 1;
    } else if (smallidx > minidx) {
      is_smaller = -1;
    } else {
      is_smaller = 0;
    }
    if (i + 1 < natoms) {
      int32_t *next = thiscoord + 3;
      if (std::abs(thiscoord[0] - next[0]) < smallnum &&
          std::abs(thiscoord[1] - next[1]) < smallnum &&
          std::abs(thiscoord[2] - next[2]) < smallnum) {
        // swap this with next (water-pair optimization)
        std::swap(thiscoord[0], next[0]);
        std::swap(thiscoord[1], next[1]);
        std::swap(thiscoord[2], next[2]);
        is_small = true;
      }
    }
    int32_t tmpcoord[3] = {thiscoord[0] - minint[0], thiscoord[1] - minint[1],
                           thiscoord[2] - minint[2]};
    if (bitsize == 0) {
      bw.put(bitsizeint[0], (uint32_t)tmpcoord[0]);
      bw.put(bitsizeint[1], (uint32_t)tmpcoord[1]);
      bw.put(bitsizeint[2], (uint32_t)tmpcoord[2]);
    } else {
      write_ints3(bw, bitsize, sizeint, tmpcoord);
    }
    prevcoord[0] = thiscoord[0];
    prevcoord[1] = thiscoord[1];
    prevcoord[2] = thiscoord[2];
    i++;

    int run = 0;
    if (!is_small && is_smaller == -1) is_smaller = 0;
    while (is_small && run < 8 * 3) {
      int32_t *cur = ip + (size_t)i * 3;
      if (is_smaller == -1 &&
          ((int64_t)(cur[0] - prevcoord[0]) * (cur[0] - prevcoord[0]) +
           (int64_t)(cur[1] - prevcoord[1]) * (cur[1] - prevcoord[1]) +
           (int64_t)(cur[2] - prevcoord[2]) * (cur[2] - prevcoord[2])) >=
              (int64_t)smaller * smaller) {
        is_smaller = 0;
      }
      tmprun[run + 0] = cur[0] - prevcoord[0] + smallnum;
      tmprun[run + 1] = cur[1] - prevcoord[1] + smallnum;
      tmprun[run + 2] = cur[2] - prevcoord[2] + smallnum;
      run += 3;
      prevcoord[0] = cur[0];
      prevcoord[1] = cur[1];
      prevcoord[2] = cur[2];
      i++;
      is_small = false;
      if (i < natoms) {
        int32_t *next = ip + (size_t)i * 3;
        if (std::abs(next[0] - prevcoord[0]) < smallnum &&
            std::abs(next[1] - prevcoord[1]) < smallnum &&
            std::abs(next[2] - prevcoord[2]) < smallnum) {
          is_small = true;
        }
      }
    }
    if (run != prevrun || is_smaller != 0) {
      prevrun = run;
      bw.put(1, 1);
      bw.put(5, (uint32_t)(run + is_smaller + 1));
    } else {
      bw.put(1, 0);
    }
    for (int k = 0; k < run; k += 3) {
      write_ints3(bw, smallidx, sizesmall, &tmprun[k]);
    }
    if (is_smaller != 0) {
      smallidx += is_smaller;
      if (is_smaller < 0) {
        smallnum = smaller;
        smaller = (smallidx > FIRSTIDX) ? MAGICINTS[smallidx - 1] / 2 : 0;
      } else {
        smaller = smallnum;
        smallnum = MAGICINTS[smallidx] / 2;
      }
      sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)MAGICINTS[smallidx];
    }
  }
  bw.flush();

  append_be32(file, (uint32_t)bw.out.size());
  file.insert(file.end(), bw.out.begin(), bw.out.end());
  size_t pad = (4 - (bw.out.size() & 3)) & 3;
  for (size_t k = 0; k < pad; k++) file.push_back(0);
  return true;
}

// --------------------------------------------------------------- TRR framing

struct TrrHeader {
  int32_t natoms = 0, step = 0;
  float time = 0, lambda_ = 0;
  float box[9] = {0};
  bool is_double = false;
  int32_t x_size = 0, v_size = 0, f_size = 0, box_size = 0;
  const uint8_t *x = nullptr;
  size_t frame_size = 0;
};

bool parse_trr_header(const uint8_t *base, size_t size, size_t offset,
                      TrrHeader *h) {
  Reader r{base + offset, base + size};
  int32_t magic;
  if (!r.read_i32(&magic)) return false;
  if (magic != TRR_MAGIC) {
    set_error("invalid TRR magic number");
    return false;
  }
  // version string: XDR string = max_len, actual_len, padded bytes
  int32_t slen1, slen2;
  if (!r.read_i32(&slen1) || !r.read_i32(&slen2)) return false;
  if (slen2 < 0 || slen2 > 256) {
    set_error("invalid TRR version string");
    return false;
  }
  if (!r.skip(((size_t)slen2 + 3) & ~(size_t)3)) return false;

  int32_t ir_size, e_size, box_size, vir_size, pres_size, top_size, sym_size;
  int32_t x_size, v_size, f_size, natoms, step, nre;
  if (!r.read_i32(&ir_size) || !r.read_i32(&e_size) || !r.read_i32(&box_size) ||
      !r.read_i32(&vir_size) || !r.read_i32(&pres_size) ||
      !r.read_i32(&top_size) || !r.read_i32(&sym_size) || !r.read_i32(&x_size) ||
      !r.read_i32(&v_size) || !r.read_i32(&f_size) || !r.read_i32(&natoms) ||
      !r.read_i32(&step) || !r.read_i32(&nre))
    return false;

  // determine real size from the largest per-frame array
  int real_size = 4;
  if (box_size == 9 * 8) real_size = 8;
  else if (box_size == 9 * 4) real_size = 4;
  else if (natoms > 0 && x_size == natoms * 3 * 8) real_size = 8;
  else if (natoms > 0 && v_size == natoms * 3 * 8) real_size = 8;
  else if (natoms > 0 && f_size == natoms * 3 * 8) real_size = 8;

  h->is_double = (real_size == 8);
  h->natoms = natoms;
  h->step = step;
  h->box_size = box_size;
  h->x_size = x_size;
  h->v_size = v_size;
  h->f_size = f_size;

  if (h->is_double) {
    double t, l;
    if (!r.read_f64(&t) || !r.read_f64(&l)) return false;
    h->time = (float)t;
    h->lambda_ = (float)l;
  } else {
    if (!r.read_f32(&h->time) || !r.read_f32(&h->lambda_)) return false;
  }

  if (box_size > 0) {
    for (int i = 0; i < 9; i++) {
      if (h->is_double) {
        double v;
        if (!r.read_f64(&v)) return false;
        h->box[i] = (float)v;
      } else {
        if (!r.read_f32(&h->box[i])) return false;
      }
    }
  }
  if (!r.skip((size_t)std::max(vir_size, 0))) return false;
  if (!r.skip((size_t)std::max(pres_size, 0))) return false;
  h->x = r.p;
  if (!r.skip((size_t)std::max(x_size, 0))) return false;
  if (!r.skip((size_t)std::max(v_size, 0))) return false;
  if (!r.skip((size_t)std::max(f_size, 0))) return false;
  h->frame_size = (size_t)(r.p - (base + offset));
  return true;
}

bool decode_trr_coords(const TrrHeader &h, int32_t first_n, float *out) {
  if (h.x_size <= 0) {
    // no coordinates in this frame: emit NaNs so callers can skip it
    for (int i = 0; i < first_n * 3; i++)
      out[i] = std::numeric_limits<float>::quiet_NaN();
    return true;
  }
  int n = std::min(first_n, h.natoms);
  Reader r{h.x, h.x + h.x_size};
  if (h.is_double) {
    for (int i = 0; i < n * 3; i++) {
      double v;
      if (!r.read_f64(&v)) return false;
      out[i] = (float)v;
    }
  } else {
    for (int i = 0; i < n * 3; i++) {
      if (!r.read_f32(&out[i])) return false;
    }
  }
  return true;
}

}  // namespace

// =============================================================== public C API

extern "C" {

const char *xdr_last_error() { return g_error.c_str(); }

// Scan an XTC file: fills caller-provided arrays (capacity `cap`) with frame
// metadata; returns the number of frames, or -1 on error. If cap == 0 only
// counts frames.
int64_t xtc_scan(const char *path, int64_t cap, int64_t *offsets,
                 int32_t *natoms, int32_t *steps, float *times) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  size_t offset = 0;
  int64_t count = 0;
  while (offset + 4 <= mf.size) {
    XtcHeader h;
    if (!parse_xtc_header(mf.data, mf.size, offset, &h)) return -1;
    if (count < cap) {
      offsets[count] = (int64_t)offset;
      natoms[count] = h.natoms;
      steps[count] = h.step;
      times[count] = h.time;
    }
    offset += h.frame_size;
    count++;
  }
  return count;
}

// Decode `n` frames (by file offset) into out_coords[n][n_out][3], where
// n_out = first_n for prefix reads or the number of selected slots when
// slot_of (length first_n, -1 = skip) routes a sparse atom subset.
// out_boxes: n*9 floats (row-major 3x3). Returns 0 on success.
int32_t xtc_decode(const char *path, const int64_t *frame_offsets, int64_t n,
                   int32_t first_n, const int32_t *slot_of, int32_t n_out,
                   float *out_coords, float *out_boxes, float *out_times,
                   int32_t *out_steps, int32_t n_threads) {
  return decode_frames_common(
      path, frame_offsets, n, first_n, slot_of, nullptr, out_boxes, out_times,
      out_steps, n_threads, [&](int64_t f, const XtcHeader &h) {
        return F32Sink{out_coords + (size_t)f * n_out * 3,
                       h.plain ? 1.0f : 1.0f / h.precision};
      });
}

// Decode frames as raw fixed-point int16 XTC integers (out_coords:
// n*n_out*3 i16; out_inv_precision: n f32 scales so that
// float(coord_i16) * inv_precision == the f32 coordinate bit-for-bit).
// Returns 0 on success, 1 if any coordinate does not fit int16 (caller
// falls back to the f32 path), -1 on error.
int32_t xtc_decode_i16(const char *path, const int64_t *frame_offsets,
                       int64_t n, int32_t first_n, const int32_t *slot_of,
                       int32_t n_out, int16_t *out_coords,
                       float *out_inv_precision, float *out_boxes,
                       float *out_times, int32_t *out_steps,
                       int32_t n_threads) {
  return decode_frames_common(
      path, frame_offsets, n, first_n, slot_of, out_inv_precision, out_boxes,
      out_times, out_steps, n_threads, [&](int64_t f, const XtcHeader &) {
        return I16Sink{out_coords + (size_t)f * n_out * 3, 0.0f};
      });
}

// Like xtc_decode_i16 but packs each coordinate into 12 bits (two values
// per 3 bytes) — 25% fewer bytes on the wire than int16. Frame stride is
// ((n_out*3 + 1) / 2) * 3 bytes. Returns 1 when any value exceeds the
// 12-bit range (caller falls back to int16), 0 on success, -1 on error.
int32_t xtc_decode_i12(const char *path, const int64_t *frame_offsets,
                       int64_t n, int32_t first_n, const int32_t *slot_of,
                       int32_t n_out, uint8_t *out_coords,
                       float *out_inv_precision, float *out_boxes,
                       float *out_times, int32_t *out_steps,
                       int32_t n_threads) {
  const size_t stride = (((size_t)n_out * 3 + 1) / 2) * 3;
  return decode_frames_common(
      path, frame_offsets, n, first_n, slot_of, out_inv_precision, out_boxes,
      out_times, out_steps, n_threads, [&](int64_t f, const XtcHeader &) {
        return I12Sink{out_coords + (size_t)f * stride, 0.0f};
      });
}

// Decode frames as the int32 XTC integers themselves (out_coords:
// n*n_out*3 i32), whatever their range: the integers every wire carries,
// which the card's decoder (csrc/xtc.cu) is held to. Returns 0 on success,
// -1 on error.
int32_t xtc_decode_i32(const char *path, const int64_t *frame_offsets,
                       int64_t n, int32_t first_n, const int32_t *slot_of,
                       int32_t n_out, int32_t *out_coords,
                       float *out_inv_precision, float *out_boxes,
                       float *out_times, int32_t *out_steps,
                       int32_t n_threads) {
  return decode_frames_common(
      path, frame_offsets, n, first_n, slot_of, out_inv_precision, out_boxes,
      out_times, out_steps, n_threads, [&](int64_t f, const XtcHeader &) {
        return I32Sink{out_coords + (size_t)f * n_out * 3, 0.0f};
      });
}

// The xtc wire: each frame's whole record, header included, copied from
// the file into row f of out_raw (rows of `stride` bytes; the rest of a row
// is left as it was) with its length in out_lengths[f], and its box, time,
// step and 1/precision as the decoders give them. The card decodes the
// rows (csrc/xtc.cu); this pass only copies, so it runs at the host's
// memory rate. Returns 0 ok; 1 when a frame does not fit the wire (the
// caller ships the batch on the int16 wire, whose decoder then reads the
// frame as it always has): a plain frame (natoms <= 9), a frame of another
// atom count than `natoms`, a record longer than `stride`, an integer
// range or smallidx the decoder refuses, or a large-atom group wider than
// the 64 bits the host decoder reads; -1 on error.
int32_t xtc_read_raw(const char *path, const int64_t *frame_offsets,
                     int64_t n, int32_t natoms, int64_t stride,
                     uint8_t *out_raw, int32_t *out_lengths,
                     float *out_inv_precision, float *out_boxes,
                     float *out_times, int32_t *out_steps,
                     int32_t n_threads) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  std::atomic<int32_t> status{0};
  auto fits = [&](const XtcHeader &h) {
    if (h.plain || h.natoms != natoms || (int64_t)h.frame_size > stride ||
        h.smallidx < FIRSTIDX || h.smallidx > LASTIDX)
      return false;
    uint32_t sizes[3];
    bool wide = false;
    for (int k = 0; k < 3; k++) {
      int64_t span = (int64_t)h.maxint[k] - (int64_t)h.minint[k] + 1;
      if (span <= 0 || span > (int64_t)UINT32_MAX) return false;
      sizes[k] = (uint32_t)span;
      wide = wide || sizes[k] > 0xFFFFFF;
    }
    return wide || sizeofints(3, sizes) <= 64;
  };
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t f = lo; f < hi; f++) {
      XtcHeader h;
      if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[f], &h)) {
        status.store(-1);
        return;
      }
      if (!fits(h)) {
        int32_t expected = 0;
        status.compare_exchange_strong(expected, 1);
        return;
      }
      memcpy(out_raw + (size_t)f * (size_t)stride,
             mf.data + (size_t)frame_offsets[f], h.frame_size);
      out_lengths[f] = (int32_t)h.frame_size;
      memcpy(out_boxes + f * 9, h.box, 9 * sizeof(float));
      out_times[f] = h.time;
      out_steps[f] = h.step;
      out_inv_precision[f] = 1.0f / h.precision;
    }
  };
  int nt = std::max(1, (int)std::min<int64_t>(n_threads, n));
  if (nt == 1) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      if (lo < hi) threads.emplace_back(work, lo, hi);
    }
    for (auto &th : threads) th.join();
  }
  return status.load();
}

// Temporal-delta wire format ("d8"): per batch, an int32 absolute base
// frame plus int8 per-value deltas vs the previous frame, with sparse
// (index, high-bits) corrections for the values whose delta does not fit
// int8. The device reconstructs absolutes with a cumulative sum over the
// batch axis — bit-identical to the f32 decode for any XTC integer < 2^24
// — at ~3 bytes/atom on the wire instead of int16's 6.
//
// Layout per frame row r (0-based within this call):
//   out_lo      + r*n_out*3 : int8 low bytes of delta (row 0 of a fresh
//                             batch is all-zero; its absolutes go to
//                             out_abs0)
//   out_corr_idx + r*corr_cap : int32 flat value indices (n_out*3 = pad)
//   out_corr_hi  + r*corr_cap : int16 delta high bits (delta = lo + hi<<8)
//
// `base_io` (int32 n_out*3) chains multi-segment batches: when has_base=1,
// row 0 is a delta vs base_io (a previous call's last frame); on success
// base_io holds this call's last frame. When has_base=0, out_abs0 receives
// the first frame's absolutes. All frames in one chained batch must share
// the compression precision (checked here per call; the caller checks
// continuity across segments via out_inv_precision).
//
// Returns 0 ok; 1 unfit (correction overflow / mixed precision — caller
// falls back to int16/f32); -1 error.
int32_t xtc_decode_d8(const char *path, const int64_t *frame_offsets,
                      int64_t n, int32_t first_n, const int32_t *slot_of,
                      int32_t n_out, int32_t *base_io, int32_t has_base,
                      int32_t *out_abs0, int8_t *out_lo,
                      int32_t *out_corr_idx, int16_t *out_corr_hi,
                      int32_t corr_cap, int32_t *out_max_ncorr,
                      float *out_inv_precision, float *out_boxes,
                      float *out_times, int32_t *out_steps,
                      int32_t n_threads) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  const size_t nv = (size_t)n_out * 3;

  std::atomic<int32_t> status{0};
  std::atomic<int32_t> max_ncorr{0};

  auto decode_ints = [&](int64_t f, int32_t *dst, float *eff_prec) -> bool {
    XtcHeader h;
    if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[f], &h))
      return false;
    if (out_boxes) memcpy(out_boxes + f * 9, h.box, 9 * sizeof(float));
    if (out_times) out_times[f] = h.time;
    if (out_steps) out_steps[f] = h.step;
    *eff_prec = h.plain ? 1000.0f : h.precision;
    if (out_inv_precision) out_inv_precision[f] = 1.0f / *eff_prec;
    I32Sink sink{dst, 0.0f};
    if (slot_of) {
      SlotSink<I32Sink> ss{sink, slot_of};
      return decode_xtc_coords_t(h, first_n, ss);
    }
    return decode_xtc_coords_t(h, first_n, sink);
  };

  auto bump_max = [&](int32_t v) {
    int32_t cur = max_ncorr.load(std::memory_order_relaxed);
    while (v > cur &&
           !max_ncorr.compare_exchange_weak(cur, v,
                                            std::memory_order_relaxed)) {
    }
  };

  // pack `cur - prev` into row r; false when corrections overflow (the
  // demand is still tallied into max_ncorr so callers can size corr_cap)
  auto pack_row = [&](int64_t r, const int32_t *cur, const int32_t *prev) {
    int8_t *lo = out_lo + (size_t)r * nv;
    int32_t *ci = out_corr_idx + (size_t)r * corr_cap;
    int16_t *ch = out_corr_hi + (size_t)r * corr_cap;
    int32_t ncorr = 0;
    bool fits = true;
    for (size_t j = 0; j < nv; j++) {
      int32_t d = cur[j] - prev[j];
      int32_t l = ((d & 0xFF) ^ 0x80) - 0x80;  // sign-extended low byte
      lo[j] = (int8_t)l;
      int32_t hi = d - l;  // exact multiple of 256
      if (hi != 0) {
        hi >>= 8;
        if (hi < INT16_MIN || hi > INT16_MAX) return false;
        if (ncorr < corr_cap) {
          ci[ncorr] = (int32_t)j;
          ch[ncorr] = (int16_t)hi;
        } else {
          fits = false;
        }
        ncorr++;
      }
    }
    bump_max(ncorr);
    for (int32_t k = ncorr < corr_cap ? ncorr : corr_cap; k < corr_cap; k++) {
      ci[k] = (int32_t)nv;  // out-of-range: dropped by the device scatter
      ch[k] = 0;
    }
    return fits;
  };

  auto work = [&](int64_t lo_f, int64_t hi_f) {
    std::vector<int32_t> bufs(2 * nv, 0);
    int32_t *prev = bufs.data();
    int32_t *cur = bufs.data() + nv;
    float chunk_prec = 0.0f;

    if (lo_f == 0) {
      float p0;
      if (!decode_ints(0, cur, &p0)) {
        status.store(-1);
        return;
      }
      chunk_prec = p0;
      if (has_base) {
        if (!pack_row(0, cur, base_io)) {
          // keep decoding to tally the full correction demand (max_ncorr)
          // so the caller can re-size corr_cap
          int32_t e = 0;
          status.compare_exchange_strong(e, 1);
        }
      } else {
        memcpy(out_abs0, cur, nv * sizeof(int32_t));
        memset(out_lo, 0, nv);
        int32_t *ci = out_corr_idx;
        int16_t *ch = out_corr_hi;
        for (int32_t k = 0; k < corr_cap; k++) {
          ci[k] = (int32_t)nv;
          ch[k] = 0;
        }
      }
      std::swap(prev, cur);
    } else {
      // base = the frame before this chunk (redundant decode; cheap
      // relative to the chunk and keeps chunks independent). Boxes etc. of
      // that frame belong to the previous chunk — don't overwrite them.
      XtcHeader h;
      if (!parse_xtc_header(mf.data, mf.size,
                            (size_t)frame_offsets[lo_f - 1], &h)) {
        status.store(-1);
        return;
      }
      chunk_prec = h.plain ? 1000.0f : h.precision;
      I32Sink sink{prev, 0.0f};
      bool ok;
      if (slot_of) {
        SlotSink<I32Sink> ss{sink, slot_of};
        ok = decode_xtc_coords_t(h, first_n, ss);
      } else {
        ok = decode_xtc_coords_t(h, first_n, sink);
      }
      if (!ok) {
        status.store(-1);
        return;
      }
    }

    for (int64_t f = (lo_f == 0 ? 1 : lo_f); f < hi_f; f++) {
      if (status.load() == -1) return;
      float p;
      if (!decode_ints(f, cur, &p)) {
        status.store(-1);
        return;
      }
      if (p != chunk_prec) {  // mixed precision breaks the integer chain
        int32_t e = 0;
        status.compare_exchange_strong(e, 1);
        return;
      }
      if (!pack_row(f, cur, prev)) {
        int32_t e = 0;
        status.compare_exchange_strong(e, 1);
        // fall through: keep tallying demand for corr_cap re-sizing
      }
      std::swap(prev, cur);
    }
    if (hi_f == n) memcpy(base_io, prev, nv * sizeof(int32_t));
  };

  int nt = std::max(1, (int)std::min<int64_t>(n_threads, n));
  if (nt == 1) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      if (lo < hi) threads.emplace_back(work, lo, hi);
    }
    for (auto &th : threads) th.join();
  }
  if (out_max_ncorr) *out_max_ncorr = max_ncorr.load();
  return status.load();
}

// Smoothed-base sub-byte wire format ("s6").
//
// Motivation: the d8 temporal-delta format ships 8 bits/value, but the
// information content of a frame given its neighbours is lower — thermal
// jitter around a slowly-moving per-molecule position. s6 models exactly
// that: per batch a per-value integer base `b` (computed as the per-value
// median over a centered window of frames after removing each frame's
// per-group median), per frame a per-group median M (int16, robust to
// individual atoms wrapping across the box), and per value a residual
//   r = c - b - M[group]
// coded in 6 bits ([-32, 31]; out-of-range values escape to a sparse
// (gap u16, val i16) side channel whose gap-coded positions override the
// in-band slot, so no code point is reserved for the escape marker). Reconstruction is `c = b + M + r` — no cumsum chain, so
// frames (and batches) are independent and bit-exact like every other
// integer wire format. Typical membranes cost ~0.77 B/value vs d8's 1.0.
//
// Returns 0 ok / 1 unfit (escape demand over esc_cap — re-size and retry —
// or group median / escape value outside int16, or mixed compression
// precision) / -1 corruption. out_max_esc always reports the worst
// per-frame escape demand so callers can size esc_cap.
int32_t xtc_decode_s6(const char *path, const int64_t *frame_offsets,
                      int64_t n, int32_t first_n, const int32_t *slot_of,
                      int32_t n_out, const int32_t *group_of,
                      int32_t n_groups, int32_t gmean_stride,
                      int32_t w_base, int32_t *base_io, int32_t has_base,
                      int16_t *gmean_out, uint8_t *pack_out,
                      uint16_t *esc_gap_out, int16_t *esc_val_out,
                      int32_t esc_cap, int32_t *out_max_esc,
                      float *out_inv_precision, float *out_boxes,
                      float *out_times, int32_t *out_steps,
                      int32_t n_threads) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  const size_t nv = (size_t)n_out * 3;
  const size_t nv4 = (nv + 3) & ~(size_t)3;
  const size_t stride = nv4 / 4 * 3;

  std::atomic<int32_t> status{0};
  std::atomic<int32_t> max_esc{0};

  // group member lists (slots sorted by group id; g < 0 slots = padding
  // columns that decode to exact zeros, excluded from all statistics)
  std::vector<int32_t> gcount((size_t)n_groups + 1, 0);
  for (int32_t a = 0; a < n_out; a++) {
    int32_t g = group_of[a];
    if (g >= 0 && g < n_groups) gcount[(size_t)g + 1]++;
  }
  std::vector<int32_t> goff((size_t)n_groups + 1, 0);
  for (int32_t g = 0; g < n_groups; g++) goff[g + 1] = goff[g] + gcount[g + 1];
  std::vector<int32_t> gmembers((size_t)goff[n_groups]);
  {
    std::vector<int32_t> cursor(goff.begin(), goff.end() - 1);
    for (int32_t a = 0; a < n_out; a++) {
      int32_t g = group_of[a];
      if (g >= 0 && g < n_groups) gmembers[(size_t)cursor[g]++] = a;
    }
  }

  float p_expect = -1.0f;
  {
    XtcHeader h;
    if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[0], &h))
      return -1;
    p_expect = h.plain ? 1000.0f : h.precision;
  }

  auto decode_ints = [&](int64_t f, int32_t *dst, bool meta) -> int {
    XtcHeader h;
    if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[f], &h))
      return -1;
    float p = h.plain ? 1000.0f : h.precision;
    if (p != p_expect) return 1;  // mixed precision: integers not comparable
    if (meta) {
      if (out_boxes) memcpy(out_boxes + f * 9, h.box, 9 * sizeof(float));
      if (out_times) out_times[f] = h.time;
      if (out_steps) out_steps[f] = h.step;
      if (out_inv_precision) out_inv_precision[f] = 1.0f / p;
    }
    I32Sink sink{dst, 0.0f};
    bool ok;
    if (slot_of) {
      SlotSink<I32Sink> ss{sink, slot_of};
      ok = decode_xtc_coords_t(h, first_n, ss);
    } else {
      ok = decode_xtc_coords_t(h, first_n, sink);
    }
    return ok ? 0 : -1;
  };

  // Per-frame per-group lower medians of (c - ref) (3 axes), computed on
  // a deterministic strided sample of at most 25 members. With ref = base
  // the member values collapse to comparable residuals, so the sample
  // median both averages the thermal jitter (~1.25*sigma/5) and stays
  // robust to individual atoms wrapping across the box, at O(25) per
  // group instead of O(group size) — this runs once per frame per group
  // per axis and dominates the encoder's hot path. With ref = null
  // (bootstrap) it is a crude location estimate that tracks one middle
  // member's noise — good enough to seed the base refinement below.
  constexpr int32_t kMedSample = 25;
  auto group_medians = [&](const int32_t *c, const int32_t *ref, int32_t *m,
                           std::vector<int32_t> &scratch) {
    (void)scratch;
    int32_t buf[kMedSample];
    for (int32_t g = 0; g < n_groups; g++) {
      int32_t cnt = goff[g + 1] - goff[g];
      if (cnt == 0) {
        m[g * 3 + 0] = m[g * 3 + 1] = m[g * 3 + 2] = 0;
        continue;
      }
      int32_t ns = cnt < kMedSample ? cnt : kMedSample;
      for (int k = 0; k < 3; k++) {
        for (int32_t t = 0; t < ns; t++) {
          int32_t i = goff[g] + (int32_t)((int64_t)t * cnt / ns);
          size_t j = (size_t)gmembers[i] * 3 + k;
          buf[t] = c[j] - (ref ? ref[j] : 0);
        }
        std::nth_element(buf, buf + (ns - 1) / 2, buf + ns);
        m[g * 3 + k] = buf[(ns - 1) / 2];
      }
    }
  };

  // ---- base: two refinement passes over a centered window.
  // Pass 1 bootstraps a base from raw-coordinate group medians (noisy:
  // the median of widely-spread member positions follows ONE middle
  // atom's jitter). Pass 2 recomputes the group location as the median of
  // residuals vs that base (now jitter-averaging) and re-derives the
  // base against it — per-value lower medians keep every step robust to
  // wraps/outliers inside the window.
  if (!has_base) {
    int64_t W = std::min<int64_t>(std::max(1, w_base), n);
    int64_t c0 = (n - W) / 2;
    std::vector<int32_t> tmp(W * nv, 0);
    std::vector<int32_t> med(W * (size_t)n_groups * 3);
    std::vector<int32_t> scratch;
    for (int64_t t = 0; t < W; t++) {
      int rc = decode_ints(c0 + t, tmp.data() + t * nv, false);
      if (rc != 0) {
        if (out_max_esc) *out_max_esc = 0;
        return rc;
      }
      group_medians(tmp.data() + t * nv, nullptr,
                    med.data() + t * (size_t)n_groups * 3, scratch);
    }
    std::vector<int32_t> vals((size_t)W);
    auto rebase = [&]() {
      for (size_t j = 0; j < nv; j++) {
        int32_t a = (int32_t)(j / 3), k = (int32_t)(j % 3);
        int32_t g = group_of[a];
        for (int64_t t = 0; t < W; t++) {
          int32_t m = (g >= 0 && g < n_groups)
                          ? med[t * (size_t)n_groups * 3 + (size_t)g * 3 + k]
                          : 0;
          vals[(size_t)t] = tmp[t * nv + j] - m;
        }
        auto mid = vals.begin() + (W - 1) / 2;
        std::nth_element(vals.begin(), mid, vals.end());
        base_io[j] = *mid;
      }
    };
    rebase();
    // med := residual medians vs the bootstrap base (jitter-averaging)
    std::vector<int32_t> base0(base_io, base_io + nv);
    for (int64_t t = 0; t < W; t++)
      group_medians(tmp.data() + t * nv, base0.data(),
                    med.data() + t * (size_t)n_groups * 3, scratch);
    for (size_t j = 0; j < nv; j++) {
      int32_t a = (int32_t)(j / 3), k = (int32_t)(j % 3);
      int32_t g = group_of[a];
      for (int64_t t = 0; t < W; t++) {
        int32_t m = (g >= 0 && g < n_groups)
                        ? med[t * (size_t)n_groups * 3 + (size_t)g * 3 + k]
                        : 0;
        vals[(size_t)t] = tmp[t * nv + j] - base0[j] - m;
      }
      auto mid = vals.begin() + (W - 1) / 2;
      std::nth_element(vals.begin(), mid, vals.end());
      base_io[j] = base0[j] + *mid;
    }
  }

  auto bump_max = [&](int32_t v) {
    int32_t cur = max_esc.load(std::memory_order_relaxed);
    while (v > cur && !max_esc.compare_exchange_weak(
                          cur, v, std::memory_order_relaxed)) {
    }
  };

  // header parse + per-frame precision check + metadata write; rc mirrors
  // decode_ints: 0 ok, 1 mixed precision (meta NOT written), -1 corrupt
  auto prep_hdr = [&](int64_t f, XtcHeader *h) -> int {
    if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[f], h))
      return -1;
    float p = h->plain ? 1000.0f : h->precision;
    if (p != p_expect) return 1;
    if (out_boxes) memcpy(out_boxes + f * 9, h->box, 9 * sizeof(float));
    if (out_times) out_times[f] = h->time;
    if (out_steps) out_steps[f] = h->step;
    if (out_inv_precision) out_inv_precision[f] = 1.0f / p;
    return 0;
  };

  auto work = [&](int64_t lo_f, int64_t hi_f) {
    std::vector<int32_t> cur(nv, 0);
    std::vector<int32_t> cur2(nv, 0);
    std::vector<int32_t> med((size_t)n_groups * 3);
    std::vector<int32_t> scratch;
    std::vector<int32_t> subv(nv, 0);

    auto post = [&](int64_t f, const int32_t *c) {
      group_medians(c, base_io, med.data(), scratch);
      int16_t *gm = gmean_out + f * (size_t)gmean_stride;
      bool fits = true;
      for (int32_t g = 0; g < n_groups * 3; g++) {
        if (med[g] < INT16_MIN || med[g] > INT16_MAX) fits = false;
        gm[g] = (int16_t)std::max<int32_t>(
            INT16_MIN, std::min<int32_t>(INT16_MAX, med[g]));
      }
      uint8_t *pk = pack_out + f * stride;
      uint16_t *eg = esc_gap_out + (size_t)f * esc_cap;
      int16_t *ev = esc_val_out + (size_t)f * esc_cap;
      int32_t nesc = 0;
      int64_t last_esc = -1;
      int64_t next_force = 65534;  // last_esc + 65535: u16 gap ceiling
      size_t out = 0;
      static const int32_t kZero3[3] = {0, 0, 0};
      // per-frame subtrahend per slot value: base + this frame's group
      // median (XTC ints are < 2^24 and |median| <= 2^15, so int32 is
      // exact). Built once so the 6-bit coder below runs vector-wide
      // with a single subtract.
      for (size_t a = 0; a < (size_t)n_out; a++) {
        int32_t g = group_of[a];
        const int32_t *mg = (g >= 0 && g < n_groups)
                                ? med.data() + (size_t)g * 3
                                : kZero3;
        subv[a * 3 + 0] = base_io[a * 3 + 0] + mg[0];
        subv[a * 3 + 1] = base_io[a * 3 + 1] + mg[1];
        subv[a * 3 + 2] = base_io[a * 3 + 2] + mg[2];
      }
      // One value through the escape-aware path; returns its 6-bit code
      // (escaped slots code 0 — the device scatter overrides them).
      auto code_one = [&](size_t j) -> uint32_t {
        int32_t r = c[j] - subv[j];
        // single unsigned compare: r < -32 || r > 31
        if ((uint32_t)(r + 32) <= 63u && (int64_t)j < next_force)
          return (uint32_t)r & 63u;
        if (r < INT16_MIN || r > INT16_MAX) fits = false;
        if (nesc < esc_cap) {
          eg[nesc] = (uint16_t)((int64_t)j - last_esc);
          ev[nesc] = (int16_t)std::max<int32_t>(
              INT16_MIN, std::min<int32_t>(INT16_MAX, r));
        } else {
          fits = false;
        }
        nesc++;
        last_esc = (int64_t)j;
        next_force = last_esc + 65535;
        return 0;
      };
      size_t j = 0;
#if defined(__AVX512F__) && defined(__AVX512VL__) && defined(__BMI2__)
      // Fast path: 8 residuals (= two wire groups of 4) per iteration;
      // one _pext_u64 against the 0x3f-per-byte mask emits both 3-byte
      // groups at once, identical to the scalar shift-accumulate coder.
      // A group with any escape falls back to the scalar coder for just
      // those 8 values, so the 3-byte output alignment never drifts. The
      // 8-byte store writes 2 zero bytes past the 6-byte group, which
      // the next group's store overwrites — legal except at the row end.
      {
        const __m256i s32 = _mm256_set1_epi32(32);
        const __m256i s63 = _mm256_set1_epi32(63);
        for (; j + 8 <= nv; j += 8) {
          __m256i r = _mm256_sub_epi32(
              _mm256_loadu_si256((const __m256i *)(c + j)),
              _mm256_loadu_si256((const __m256i *)(subv.data() + j)));
          __mmask8 esc =
              _mm256_cmpgt_epu32_mask(_mm256_add_epi32(r, s32), s63);
          uint64_t codes;
          if (__builtin_expect(!esc && (int64_t)(j + 8) <= next_force,
                               1)) {
            codes = (uint64_t)_mm_cvtsi128_si64(_mm256_cvtepi32_epi8(r));
          } else {
            codes = 0;
            for (int k = 0; k < 8; k++)
              codes |= (uint64_t)code_one(j + k) << (8 * k);
          }
          uint64_t packed = _pext_u64(codes, 0x3f3f3f3f3f3f3f3fULL);
          if (out + 8 <= stride) {
            memcpy(pk + out, &packed, 8);
          } else {
            memcpy(pk + out, &packed, 6);
          }
          out += 6;
        }
      }
#endif
      // Scalar tail (and the whole loop without AVX-512): 4 codes per
      // 3 bytes, zero-padded past nv to the nv4 stream end.
      for (; j < nv4; j += 4) {
        uint32_t acc = 0;
        const size_t hi = std::min(nv, j + 4);
        for (size_t jj = j; jj < hi; jj++)
          acc |= code_one(jj) << (6 * (jj - j));
        pk[out + 0] = (uint8_t)(acc & 0xFF);
        pk[out + 1] = (uint8_t)((acc >> 8) & 0xFF);
        pk[out + 2] = (uint8_t)((acc >> 16) & 0xFF);
        out += 3;
      }
      for (int32_t e = std::min(nesc, esc_cap); e < esc_cap; e++) {
        eg[e] = 0;  // gap 0 = padding (real gaps are always >= 1)
        ev[e] = 0;
      }
      bump_max(nesc);
      if (!fits) {
        int32_t expect = 0;
        status.compare_exchange_strong(expect, 1);
      }
    };

    // frames decode in interleaved pairs (see decode_xtc_coords_pair_t)
    int64_t f = lo_f;
    while (f < hi_f) {
      if (status.load() == -1) return;
      XtcHeader ha, hb;
      int rca = prep_hdr(f, &ha);
      if (rca != 0) {
        status.store(rca == -1 ? -1 : 1);
        if (rca == -1) return;
        f++;
        continue;  // unfit frame skipped; keep scanning for escape demand
      }
      int rcb = (f + 1 < hi_f) ? prep_hdr(f + 1, &hb) : 2;
      if (rcb == -1) {
        status.store(-1);
        return;
      }
      bool ok;
      if (rcb == 0) {
        I32Sink sa{cur.data(), 0.0f}, sb{cur2.data(), 0.0f};
        if (slot_of) {
          SlotSink<I32Sink> ssa{sa, slot_of}, ssb{sb, slot_of};
          ok = decode_xtc_coords_pair_t(ha, ssa, hb, ssb, first_n);
        } else {
          ok = decode_xtc_coords_pair_t(ha, sa, hb, sb, first_n);
        }
        if (!ok) {
          status.store(-1);
          return;
        }
        post(f, cur.data());
        post(f + 1, cur2.data());
        f += 2;
      } else {
        I32Sink sa{cur.data(), 0.0f};
        if (slot_of) {
          SlotSink<I32Sink> ss{sa, slot_of};
          ok = decode_xtc_coords_t(ha, first_n, ss);
        } else {
          ok = decode_xtc_coords_t(ha, first_n, sa);
        }
        if (!ok) {
          status.store(-1);
          return;
        }
        post(f, cur.data());
        if (rcb == 1) {
          status.store(1);  // partner frame has mixed precision
          f += 2;
        } else {
          f += 1;
        }
      }
    }
  };

  int nt = std::max(1, (int)std::min<int64_t>(n_threads, n));
  if (nt == 1) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      if (lo < hi) threads.emplace_back(work, lo, hi);
    }
    for (auto &th : threads) th.join();
  }
  if (out_max_esc) *out_max_esc = max_esc.load();
  return status.load();
}

// Bond-difference 7-bit wire format ("b7").
//
// The bond-order hot path (no leaflets / normals / ordermaps / geometry)
// consumes only the bond VECTORS, never absolute positions. Shipping the
// per-bond integer differences d = c[atom_b] - c[atom_a] (exact int32
// arithmetic on the decoded XTC integers) instead of both endpoint
// positions cuts the value count by ~1/3 (each heavy atom anchors several
// bonds) AND removes the whole-molecule drift — the temporal residual of
// a bond vector is just the two endpoints' relative jitter, no per-group
// median channel needed. Model: per batch a per-value integer base
// (median over a centered window), per value a residual
//   r = d - base
// coded in 7 bits ([-64, 63]; escapes to the same sparse (gap u16,
// val i16) side channel as s6 — box-wrap jumps of ±box*precision fit
// int16 for any box below ~32 nm at precision 1000). Reconstruction is
// `d = base + r`; the device then computes the bond vector as
// f32(d) * (1/precision) — one rounding on the EXACT integer difference,
// vs the f32 position path's difference of two rounded products (whose
// cancellation costs up to ~2 ulp of the box span, ~1e-5 relative on a
// 0.1 nm bond). Results therefore differ from the position formulation
// at the last-ulp level; parity vs the reference stays well inside the
// 1e-5 target (tests/test_wire_b7.py) while the integers themselves are
// bit-exact.
//
// Returns 0 ok / 1 unfit (escape demand over esc_cap, escape value
// outside int16, or mixed compression precision) / -1 corruption.
// out_max_esc always reports the worst per-frame escape demand.
// Refined Bai-Breen circular mean of ONE axis of a slot subset, matching
// core/pbc.py circular_mean_cog restricted to that axis (reference:
// groan_rs group centers, SURVEY.md §2.1 "PBC handling"): circular
// estimate from trig sums, then one pass averaging the min-image
// deviations. Trig runs through a branch-free Taylor polynomial
// (|err| < 5e-4 over the full circle) in 16 independent float lanes so
// -O3 -march=native vectorizes both passes; the mean feeds leaflet
// SIDEDNESS tests whose heads sit nm away from the plane, so sub-1e-3-nm
// mean error is inconsequential (and the f64 lane fold keeps the
// accumulation order fixed: results are decode-thread-count invariant).
static float bai_breen_axis(const int32_t *c, const int32_t *slots,
                            int32_t n, int32_t axis, float invp, float L) {
  static thread_local std::vector<float> xs;
  xs.resize((size_t)n);
  const float k = invp / L;  // quantized ints -> box cycles
  for (int32_t i = 0; i < n; i++)
    xs[(size_t)i] = (float)c[(size_t)slots[i] * 3 + axis] * k;
  constexpr int LANES = 16;
  constexpr float TWO_PI = 6.28318530717958647692f;
  float acc_c[LANES] = {0}, acc_s[LANES] = {0};
  int32_t i = 0;
  for (; i + LANES <= n; i += LANES) {
    for (int l = 0; l < LANES; l++) {
      float t = xs[(size_t)(i + l)];
      t -= nearbyintf(t);       // [-0.5, 0.5] -> z in [-pi, pi]
      float z = t * TWO_PI;
      float z2 = z * z;
      float s = z * (1.0f + z2 * (-1.66666667e-1f + z2 * (8.33333333e-3f
              + z2 * (-1.98412698e-4f + z2 * (2.75573192e-6f
              + z2 * -2.50521084e-8f)))));
      float co = 1.0f + z2 * (-0.5f + z2 * (4.16666667e-2f
               + z2 * (-1.38888889e-3f + z2 * (2.48015873e-5f
               + z2 * (-2.75573192e-7f + z2 * 2.08767570e-9f)))));
      acc_s[l] += s;
      acc_c[l] += co;
    }
  }
  double sc = 0.0, ss = 0.0;
  for (int l = 0; l < LANES; l++) {
    sc += acc_c[l];
    ss += acc_s[l];
  }
  for (; i < n; i++) {
    float t = xs[(size_t)i];
    t -= nearbyintf(t);
    double z = (double)t * 6.283185307179586476925286766559;
    sc += std::cos(z);
    ss += std::sin(z);
  }
  double mean_theta = std::atan2(-ss, -sc) + 3.141592653589793238462643;
  float est = (float)(mean_theta / 6.283185307179586476925286766559) * L;
  float dacc[LANES] = {0};
  i = 0;
  for (; i + LANES <= n; i += LANES) {
    for (int l = 0; l < LANES; l++) {
      float x = xs[(size_t)(i + l)] * L;  // back to nm
      float d = x - est;
      d -= L * nearbyintf(d / L);
      dacc[l] += d;
    }
  }
  double dsum = 0.0;
  for (int l = 0; l < LANES; l++) dsum += dacc[l];
  for (; i < n; i++) {
    float x = xs[(size_t)i] * L;
    float d = x - est;
    d -= L * nearbyintf(d / L);
    dsum += d;
  }
  float refined = est + (float)(dsum / (double)(n > 0 ? n : 1));
  refined -= L * std::floor(refined / L);  // wrap into [0, L)
  return refined;
}

// ---------------------------------------------------------------------------
// Decoder-side geometry mask channel.
//
// For geometry-restricted runs the order kernel consumes only bond vectors
// plus a per-bond boolean "midpoint inside the shape" mask
// (src/analysis/geometry.rs: bonds whose midpoint falls outside contribute
// nothing). The decoder walks every frame's integers anyway, so it can
// compute that mask host-side — making geometry runs eligible for the b7
// bond-vector wire (no absolute coordinates shipped). Coordinate wires run
// this same pass so the mask — and therefore the printed output — is
// bitwise identical across wire formats (the xtc_cog_axis pattern).
//
// Arithmetic: positions and midpoints use the kernel's own single-rounding
// f32 formulation (pa = f32(int)·s, d = f32(Δint)·s, min-image with
// round-half-even, mid = pa + d·0.5f); the per-frame selection reference
// COG uses f64 circular-mean + refined min-image deviations — the same
// construction as the reference's groan_rs f64 group centers
// (core/pbc.py circular_mean_cog documents the algorithm). fp-contract is
// disabled for these helpers so the mask is identical across -march=native
// rebuilds on different hosts.
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")

// f64 naive center (NoPBC selection references).
static float geo_cog_axis_naive(const int32_t *c, const int32_t *slots,
                                int32_t n, int32_t axis, float invp) {
  double acc = 0.0;
  for (int32_t i = 0; i < n; i++)
    acc += (double)((float)c[(size_t)slots[i] * 3 + axis] * invp);
  return (float)(acc / (double)(n > 0 ? n : 1));
}

struct GeoSpecC {
  int32_t kind;         // 0 cuboid, 1 cylinder, 2 sphere
  int32_t invert;
  int32_t orientation;  // cylinder axis
  int32_t handle_pbc;
  // bounds[9]: xlo xhi ylo yhi zlo zhi radius span_lo span_hi (INFINITY ok)
  const float *b;
};

static inline bool geo_axis_ok(float rel, float lo, float hi, float L,
                               bool pbc) {
  if (std::isinf(lo) && std::isinf(hi)) return true;
  float extent = hi - lo;
  float shifted = rel - lo;
  if (pbc) shifted -= L * std::floor(shifted / L);
  return shifted >= 0.0f && shifted <= extent;
}

static inline bool geo_inside(const float mid[3], const float ref[3],
                              const float box[3], const GeoSpecC &g) {
  float rel[3] = {mid[0] - ref[0], mid[1] - ref[1], mid[2] - ref[2]};
  bool pbc = g.handle_pbc != 0;
  bool ok;
  if (g.kind == 0) {
    ok = geo_axis_ok(rel[0], g.b[0], g.b[1], box[0], pbc)
         && geo_axis_ok(rel[1], g.b[2], g.b[3], box[1], pbc)
         && geo_axis_ok(rel[2], g.b[4], g.b[5], box[2], pbc);
  } else if (g.kind == 1) {
    int a = g.orientation;
    int p0 = (a == 0) ? 1 : 0;
    int p1 = (a == 2) ? 1 : 2;
    float d0 = rel[p0], d1 = rel[p1];
    if (pbc) {
      d0 -= box[p0] * std::nearbyint(d0 / box[p0]);
      d1 -= box[p1] * std::nearbyint(d1 / box[p1]);
    }
    bool radial = std::isinf(g.b[6])
                  || (d0 * d0 + d1 * d1 <= g.b[6] * g.b[6]);
    ok = radial && geo_axis_ok(rel[a], g.b[7], g.b[8], box[a], pbc);
  } else {
    float d0 = rel[0], d1 = rel[1], d2 = rel[2];
    if (pbc) {
      d0 -= box[0] * std::nearbyint(d0 / box[0]);
      d1 -= box[1] * std::nearbyint(d1 / box[1]);
      d2 -= box[2] * std::nearbyint(d2 / box[2]);
    }
    ok = std::isinf(g.b[6])
         || (d0 * d0 + d1 * d1 + d2 * d2 <= g.b[6] * g.b[6]);
  }
  if (g.invert) ok = !ok;
  return ok;
}

#pragma GCC pop_options

int32_t xtc_decode_b7(const char *path, const int64_t *frame_offsets,
                      int64_t n, int32_t first_n, const int32_t *slot_of,
                      int32_t n_out, const int32_t *bond_a,
                      const int32_t *bond_b, int32_t n_bonds,
                      int32_t w_base, int32_t *base_io, int32_t has_base,
                      uint8_t *pack_out, uint16_t *esc_gap_out,
                      int16_t *esc_val_out, int32_t esc_cap,
                      int32_t *out_max_esc, float *out_inv_precision,
                      float *out_boxes, float *out_times, int32_t *out_steps,
                      int32_t n_threads,
                      const int32_t *aux_slots, int32_t n_aux,
                      int32_t *aux_out, const int32_t *cog_slots,
                      int32_t n_cog, int32_t cog_axis, float *cog_out,
                      int32_t geo_kind, int32_t geo_invert,
                      int32_t geo_orientation, int32_t geo_handle_pbc,
                      const float *geo_bounds, int32_t geo_ref_mode,
                      const float *geo_ref_point, const int32_t *geo_slots,
                      int32_t n_geo, uint8_t *geo_out) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  const size_t nv = (size_t)n_out * 3;        // decoded slot values
  const size_t nb = (size_t)n_bonds * 3;      // bond-difference values
  const size_t nb8 = (nb + 7) & ~(size_t)7;
  const size_t stride = nb8 / 8 * 7;

  std::atomic<int32_t> status{0};
  std::atomic<int32_t> max_esc{0};

  float p_expect = -1.0f;
  {
    XtcHeader h;
    if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[0], &h))
      return -1;
    p_expect = h.plain ? 1000.0f : h.precision;
  }

  auto decode_ints = [&](int64_t f, int32_t *dst, bool meta) -> int {
    XtcHeader h;
    if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[f], &h))
      return -1;
    float p = h.plain ? 1000.0f : h.precision;
    if (p != p_expect) return 1;  // mixed precision: integers not comparable
    if (meta) {
      if (out_boxes) memcpy(out_boxes + f * 9, h.box, 9 * sizeof(float));
      if (out_times) out_times[f] = h.time;
      if (out_steps) out_steps[f] = h.step;
      if (out_inv_precision) out_inv_precision[f] = 1.0f / p;
    }
    I32Sink sink{dst, 0.0f};
    bool ok;
    if (slot_of) {
      SlotSink<I32Sink> ss{sink, slot_of};
      ok = decode_xtc_coords_t(h, first_n, ss);
    } else {
      ok = decode_xtc_coords_t(h, first_n, sink);
    }
    return ok ? 0 : -1;
  };

  auto bond_diffs = [&](const int32_t *c, int32_t *d) {
    for (int32_t j = 0; j < n_bonds; j++) {
      const int32_t *pa = c + (size_t)bond_a[j] * 3;
      const int32_t *pb = c + (size_t)bond_b[j] * 3;
      d[j * 3 + 0] = pb[0] - pa[0];
      d[j * 3 + 1] = pb[1] - pa[1];
      d[j * 3 + 2] = pb[2] - pa[2];
    }
  };

  // Optional side channels for leaflet-classifying runs: absolute int32
  // positions of a small slot subset (e.g. lipid heads) and the refined
  // Bai-Breen center of the membrane subset along one axis — so the
  // classifier rides the b7 bond wire without shipping coordinates.
  auto emit_channels = [&](int64_t f, const int32_t *c, const XtcHeader *h) {
    if (aux_out && n_aux > 0) {
      int32_t *dst = aux_out + (size_t)f * n_aux * 3;
      for (int32_t q = 0; q < n_aux; q++) {
        const int32_t *p = c + (size_t)aux_slots[q] * 3;
        dst[q * 3 + 0] = p[0];
        dst[q * 3 + 1] = p[1];
        dst[q * 3 + 2] = p[2];
      }
    }
    if (cog_out && n_cog > 0) {
      float p = h->plain ? 1000.0f : h->precision;
      float L = h->box[cog_axis * 3 + cog_axis];
      cog_out[f] = bai_breen_axis(c, cog_slots, n_cog, cog_axis,
                                  1.0f / p, L);
    }
    if (geo_out && geo_kind >= 0) {
      // inline geometry mask channel: identical computation to the
      // standalone xtc_geo_mask pass, but reusing THIS decode's
      // integers — the b7geo wire pays one decode per frame, not two
      float p = h->plain ? 1000.0f : h->precision;
      float s = 1.0f / p;
      float box3[3] = {h->box[0], h->box[4], h->box[8]};
      GeoSpecC g{geo_kind, geo_invert, geo_orientation, geo_handle_pbc,
                 geo_bounds};
      float ref[3];
      if (geo_ref_mode == 0) {
        ref[0] = geo_ref_point[0];
        ref[1] = geo_ref_point[1];
        ref[2] = geo_ref_point[2];
      } else {
        for (int a = 0; a < 3; a++)
          ref[a] = geo_ref_mode == 1
                       ? box3[a] * 0.5f
                       : (geo_handle_pbc
                              ? bai_breen_axis(c, geo_slots, n_geo, a, s,
                                               box3[a])
                              : geo_cog_axis_naive(c, geo_slots, n_geo,
                                                   a, s));
      }
      const size_t gstride = ((size_t)n_bonds + 7) / 8;
      uint8_t *dst = geo_out + (size_t)f * gstride;
      std::memset(dst, 0, gstride);
      for (int32_t j = 0; j < n_bonds; j++) {
        const int32_t *ia = c + (size_t)bond_a[j] * 3;
        const int32_t *ib = c + (size_t)bond_b[j] * 3;
        float mid[3];
        for (int a = 0; a < 3; a++) {
          float pa = (float)ia[a] * s;
          float d = (float)(ib[a] - ia[a]) * s;
          if (geo_handle_pbc) d -= box3[a] * std::nearbyintf(d / box3[a]);
          mid[a] = pa + d * 0.5f;
        }
        if (geo_inside(mid, ref, box3, g))
          dst[(size_t)j >> 3] |= (uint8_t)(1u << (j & 7));
      }
    }
  };

  // base: per-value median of the bond differences over a centered window
  // (wrap jumps are rare per bond, so the median ignores them)
  if (!has_base) {
    int64_t W = std::min<int64_t>(std::max(1, w_base), n);
    int64_t c0 = (n - W) / 2;
    std::vector<int32_t> cur(nv, 0);
    std::vector<int32_t> dw(W * nb);
    for (int64_t t = 0; t < W; t++) {
      int rc = decode_ints(c0 + t, cur.data(), false);
      if (rc != 0) {
        if (out_max_esc) *out_max_esc = 0;
        return rc;
      }
      bond_diffs(cur.data(), dw.data() + t * nb);
    }
    std::vector<int32_t> vals((size_t)W);
    for (size_t j = 0; j < nb; j++) {
      for (int64_t t = 0; t < W; t++) vals[(size_t)t] = dw[t * nb + j];
      auto mid = vals.begin() + (W - 1) / 2;
      std::nth_element(vals.begin(), mid, vals.end());
      base_io[j] = *mid;
    }
  }

  auto bump_max = [&](int32_t v) {
    int32_t cur = max_esc.load(std::memory_order_relaxed);
    while (v > cur && !max_esc.compare_exchange_weak(
                          cur, v, std::memory_order_relaxed)) {
    }
  };

  // header parse + per-frame precision check + metadata write; rc mirrors
  // decode_ints: 0 ok, 1 mixed precision (meta NOT written), -1 corrupt
  auto prep_hdr = [&](int64_t f, XtcHeader *h) -> int {
    if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[f], h))
      return -1;
    float p = h->plain ? 1000.0f : h->precision;
    if (p != p_expect) return 1;
    if (out_boxes) memcpy(out_boxes + f * 9, h->box, 9 * sizeof(float));
    if (out_times) out_times[f] = h->time;
    if (out_steps) out_steps[f] = h->step;
    if (out_inv_precision) out_inv_precision[f] = 1.0f / p;
    return 0;
  };

  auto pack_frame = [&](int64_t f, const int32_t *dv) {
    uint8_t *pk = pack_out + f * stride;
    uint16_t *eg = esc_gap_out + (size_t)f * esc_cap;
    int16_t *ev = esc_val_out + (size_t)f * esc_cap;
    bool fits = true;
    int32_t nesc = 0;
    int64_t last_esc = -1;
    int64_t next_force = 65534;  // last_esc + 65535: u16 gap ceiling
    size_t out = 0;
    // One value through the escape-aware path; returns its 7-bit code
    // (escaped slots code 0 — the device scatter overrides them).
    auto code_one = [&](size_t j) -> uint32_t {
      int32_t r = dv[j] - base_io[j];
      // single unsigned compare: r < -64 || r > 63
      if ((uint32_t)(r + 64) <= 127u && (int64_t)j < next_force)
        return (uint32_t)r & 127u;
      if (r < INT16_MIN || r > INT16_MAX) fits = false;
      if (nesc < esc_cap) {
        eg[nesc] = (uint16_t)((int64_t)j - last_esc);
        ev[nesc] = (int16_t)std::max<int32_t>(
            INT16_MIN, std::min<int32_t>(INT16_MAX, r));
      } else {
        fits = false;
      }
      nesc++;
      last_esc = (int64_t)j;
      next_force = last_esc + 65535;
      return 0;
    };
    // Store one packed 8-code group (56 bits) as 7 little-endian bytes.
    // An 8-byte store writes one zero byte past the group, which the next
    // group's store overwrites — legal everywhere except the row end.
    auto store7 = [&](uint64_t packed) {
      if (out + 8 <= stride) {
        memcpy(pk + out, &packed, 8);
      } else {
        memcpy(pk + out, &packed, 7);
      }
      out += 7;
    };
    // `codes` holds 8 codes as 8 little-endian BYTES; pext with the
    // 0x7f-per-byte mask compacts them to the wire's 7-bit layout (bit
    // k*7.. of the group = bits 0-6 of byte k), identical to the previous
    // shift-accumulate coder.
    constexpr uint64_t PEXT_MASK = 0x7f7f7f7f7f7f7f7fULL;
    size_t j = 0;
#if defined(__AVX512F__) && defined(__AVX512VL__) && defined(__BMI2__)
    // Fast path: 8 residuals per iteration. The subtract/range-check/
    // narrow runs vector-wide; a group containing any escape (or one that
    // crosses the forced-escape horizon) falls back to the scalar coder
    // for just those 8 values, so the 7-byte output alignment never
    // drifts.
    const __m256i c64 = _mm256_set1_epi32(64);
    const __m256i c127 = _mm256_set1_epi32(127);
    for (; j + 8 <= nb; j += 8) {
      __m256i r = _mm256_sub_epi32(
          _mm256_loadu_si256((const __m256i *)(dv + j)),
          _mm256_loadu_si256((const __m256i *)(base_io + j)));
      __mmask8 esc =
          _mm256_cmpgt_epu32_mask(_mm256_add_epi32(r, c64), c127);
      uint64_t codes;
      if (__builtin_expect(!esc && (int64_t)(j + 8) <= next_force, 1)) {
        codes = (uint64_t)_mm_cvtsi128_si64(_mm256_cvtepi32_epi8(r));
      } else {
        codes = 0;
        for (int k = 0; k < 8; k++)
          codes |= (uint64_t)code_one(j + k) << (8 * k);
      }
      store7(_pext_u64(codes, PEXT_MASK));
    }
#endif
    // Scalar tail (and the whole loop without AVX-512): same 8-value
    // groups, zero-padded past nb to the nb8 stream end.
    for (; j < nb8; j += 8) {
      uint64_t codes = 0;
      const size_t hi = std::min(nb, j + 8);
      for (size_t jj = j; jj < hi; jj++)
        codes |= (uint64_t)code_one(jj) << (8 * (jj - j));
#if defined(__BMI2__)
      store7(_pext_u64(codes, PEXT_MASK));
#else
      uint64_t packed = 0;
      for (int k = 0; k < 8; k++)
        packed |= ((codes >> (8 * k)) & 127u) << (7 * k);
      store7(packed);
#endif
    }
    for (int32_t e = std::min(nesc, esc_cap); e < esc_cap; e++) {
      eg[e] = 0;  // gap 0 = padding (real gaps are always >= 1)
      ev[e] = 0;
    }
    bump_max(nesc);
    if (!fits) {
      int32_t expect = 0;
      status.compare_exchange_strong(expect, 1);
    }
  };

  auto work = [&](int64_t lo_f, int64_t hi_f) {
    std::vector<int32_t> cur(nv, 0);
    std::vector<int32_t> cur2(nv, 0);
    std::vector<int32_t> dv(nb, 0);
    int64_t f = lo_f;
    while (f < hi_f) {
      if (status.load() == -1) return;
      XtcHeader ha, hb;
      int rca = prep_hdr(f, &ha);
      if (rca != 0) {
        status.store(rca == -1 ? -1 : 1);
        if (rca == -1) return;
        f++;
        continue;  // unfit frame skipped; keep scanning for escape demand
      }
      // pair f with f+1 when possible: interleaved decode keeps two
      // independent bit-stream chains in flight (decode_xtc_coords_pair_t)
      int rcb = (f + 1 < hi_f) ? prep_hdr(f + 1, &hb) : 2;
      if (rcb == -1) {
        status.store(-1);
        return;
      }
      bool ok;
      if (rcb == 0) {
        I32Sink sa{cur.data(), 0.0f}, sb{cur2.data(), 0.0f};
        if (slot_of) {
          SlotSink<I32Sink> ssa{sa, slot_of}, ssb{sb, slot_of};
          ok = decode_xtc_coords_pair_t(ha, ssa, hb, ssb, first_n);
        } else {
          ok = decode_xtc_coords_pair_t(ha, sa, hb, sb, first_n);
        }
        if (!ok) {
          status.store(-1);
          return;
        }
        bond_diffs(cur.data(), dv.data());
        pack_frame(f, dv.data());
        emit_channels(f, cur.data(), &ha);
        bond_diffs(cur2.data(), dv.data());
        pack_frame(f + 1, dv.data());
        emit_channels(f + 1, cur2.data(), &hb);
        f += 2;
      } else {
        I32Sink sa{cur.data(), 0.0f};
        if (slot_of) {
          SlotSink<I32Sink> ss{sa, slot_of};
          ok = decode_xtc_coords_t(ha, first_n, ss);
        } else {
          ok = decode_xtc_coords_t(ha, first_n, sa);
        }
        if (!ok) {
          status.store(-1);
          return;
        }
        bond_diffs(cur.data(), dv.data());
        pack_frame(f, dv.data());
        emit_channels(f, cur.data(), &ha);
        if (rcb == 1) {
          status.store(1);  // partner frame has mixed precision
          f += 2;
        } else {
          f += 1;
        }
      }
    }
  };

  int nt = std::max(1, (int)std::min<int64_t>(n_threads, n));
  if (nt == 1) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      if (lo < hi) threads.emplace_back(work, lo, hi);
    }
    for (auto &th : threads) th.join();
  }
  if (out_max_esc) *out_max_esc = max_esc.load();
  return status.load();
}

// Standalone per-frame Bai-Breen COG pass over one axis of a slot
// subset, for global-leaflet runs riding a COORDINATE wire: leaflet
// classification must consume the decoder's COG on every wire so the
// printed output is bitwise identical across wire formats (the b7g
// side channel computes this inline; this pass supplies the same value
// to s6/d8/i12/i16/f32 batches and to host-side classification paths).
// Decodes each frame's XTC integers into thread-local scratch (slot
// space, early-stop after first_n) and runs the exact bai_breen_axis
// the b7g channel uses. Returns 0 ok / -1 corruption.
int32_t xtc_cog_axis(const char *path, const int64_t *frame_offsets,
                     int64_t n, int32_t first_n, const int32_t *slot_of,
                     int32_t n_out, const int32_t *cog_slots, int32_t n_cog,
                     int32_t cog_axis, float *cog_out, int32_t n_threads) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  std::atomic<int32_t> status{0};
  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<int32_t> scratch((size_t)n_out * 3, 0);
    for (int64_t f = lo; f < hi; f++) {
      XtcHeader h;
      if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[f],
                            &h)) {
        status.store(-1);
        return;
      }
      I32Sink sink{scratch.data(), 0.0f};
      bool ok;
      if (slot_of) {
        SlotSink<I32Sink> ss{sink, slot_of};
        ok = decode_xtc_coords_t(h, first_n, ss);
      } else {
        ok = decode_xtc_coords_t(h, first_n, sink);
      }
      if (!ok) {
        status.store(-1);
        return;
      }
      float p = h.plain ? 1000.0f : h.precision;
      float L = h.box[cog_axis * 3 + cog_axis];
      cog_out[f] = bai_breen_axis(scratch.data(), cog_slots, n_cog,
                                  cog_axis, 1.0f / p, L);
    }
  };
  int nt = std::max(1, (int)std::min<int64_t>(n_threads, n));
  if (nt == 1) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      if (lo < hi) threads.emplace_back(work, lo, hi);
    }
    for (auto &th : threads) th.join();
  }
  return status.load();
}

// Append frames to an XTC file (creates it when absent).
int32_t xtc_write(const char *path, int32_t natoms, int64_t n_frames,
                  const float *coords, const float *boxes, const float *times,
                  const int32_t *steps, float precision, int32_t append) {
  std::vector<uint8_t> buf;
  buf.reserve((size_t)n_frames * ((size_t)natoms + 64));
  for (int64_t f = 0; f < n_frames; f++) {
    if (!encode_xtc_frame(buf, natoms, steps[f], times[f], boxes + f * 9,
                          coords + (size_t)f * natoms * 3, precision))
      return -1;
  }
  FILE *fh = fopen(path, append ? "ab" : "wb");
  if (!fh) {
    set_error(std::string("could not open '") + path + "' for writing");
    return -1;
  }
  size_t written = fwrite(buf.data(), 1, buf.size(), fh);
  fclose(fh);
  if (written != buf.size()) {
    set_error("short write");
    return -1;
  }
  return 0;
}

// Decode statistics for one frame: how many atoms arrive via small-delta
// runs vs the large-int path (diagnostics for encoder quality/benchmarks).
int32_t xtc_frame_stats(const char *path, int64_t frame_offset,
                        int64_t *out_large, int64_t *out_run,
                        int32_t *out_smallidx) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  XtcHeader h;
  if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offset, &h)) return -1;
  if (h.plain) {
    *out_large = h.natoms;
    *out_run = 0;
    *out_smallidx = 0;
    return 0;
  }
  *out_smallidx = h.smallidx;
  uint32_t sizeint[3];
  for (int i = 0; i < 3; i++)
    sizeint[i] = (uint32_t)((int64_t)h.maxint[i] - h.minint[i] + 1);
  int bitsize = (sizeint[0] > 0xFFFFFF || sizeint[1] > 0xFFFFFF ||
                 sizeint[2] > 0xFFFFFF)
                    ? 0
                    : sizeofints(3, sizeint);
  uint32_t bitsizeint[3] = {0, 0, 0};
  if (bitsize == 0)
    for (int i = 0; i < 3; i++) bitsizeint[i] = sizeofint(sizeint[i]);

  int smallidx = h.smallidx;
  uint32_t sizesmall[3] = {(uint32_t)MAGICINTS[smallidx],
                           (uint32_t)MAGICINTS[smallidx],
                           (uint32_t)MAGICINTS[smallidx]};
  BitReader br(h.payload, (size_t)h.nbytes);
  int32_t dummy[3];
  int i = 0, run = 0;
  int64_t n_large = 0, n_run = 0;
  while (i < h.natoms) {
    if (bitsize == 0) {
      br.get(bitsizeint[0]);
      br.get(bitsizeint[1]);
      br.get(bitsizeint[2]);
    } else {
      read_ints3(br, bitsize, sizeint, dummy);
    }
    i++;
    n_large++;
    uint32_t flag = br.get(1);
    int is_smaller = 0;
    if (flag) {
      run = (int)br.get(5);
      is_smaller = run % 3;
      run -= is_smaller;
      is_smaller--;
    }
    for (int k = 0; k < run; k += 3) {
      read_ints3(br, smallidx, sizesmall, dummy);
      i++;
      n_run++;
    }
    smallidx += is_smaller;
    if (smallidx < FIRSTIDX || smallidx > LASTIDX) return -1;
    sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)MAGICINTS[smallidx];
  }
  *out_large = n_large;
  *out_run = n_run;
  return 0;
}

// Scan a TRR file (same contract as xtc_scan; has_coords flags frames with x).
int64_t trr_scan(const char *path, int64_t cap, int64_t *offsets,
                 int32_t *natoms, int32_t *steps, float *times,
                 int32_t *has_coords) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  size_t offset = 0;
  int64_t count = 0;
  while (offset + 4 <= mf.size) {
    TrrHeader h;
    if (!parse_trr_header(mf.data, mf.size, offset, &h)) return -1;
    if (count < cap) {
      offsets[count] = (int64_t)offset;
      natoms[count] = h.natoms;
      steps[count] = h.step;
      times[count] = h.time;
      has_coords[count] = h.x_size > 0 ? 1 : 0;
    }
    offset += h.frame_size;
    count++;
  }
  return count;
}


// Per-frame per-bond inside-geometry bitplane (bit j of byte j/8 = bond j's
// midpoint inside the shape). ref_mode: 0 = fixed point (ref_point, 3
// floats), 1 = per-frame box center, 2 = per-frame selection COG over
// geo_slots (f64 circular refined under PBC, f64 naive otherwise).
// Returns 0 ok / -1 corruption / 1 unsupported (mixed precision is fine
// here — each frame dequantizes with its own precision like the kernel).
int32_t xtc_geo_mask(const char *path, const int64_t *frame_offsets,
                     int64_t n, int32_t first_n, const int32_t *slot_of,
                     int32_t n_out, const int32_t *bond_a,
                     const int32_t *bond_b, int32_t n_bonds,
                     int32_t kind, int32_t invert, int32_t orientation,
                     int32_t handle_pbc, const float *bounds,
                     int32_t ref_mode, const float *ref_point,
                     const int32_t *geo_slots, int32_t n_geo,
                     uint8_t *mask_out, int32_t n_threads) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  const size_t stride = ((size_t)n_bonds + 7) / 8;
  GeoSpecC g{kind, invert, orientation, handle_pbc, bounds};
  std::atomic<int32_t> status{0};
  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<int32_t> scratch((size_t)n_out * 3, 0);
    for (int64_t f = lo; f < hi; f++) {
      XtcHeader h;
      if (!parse_xtc_header(mf.data, mf.size, (size_t)frame_offsets[f],
                            &h)) {
        status.store(-1);
        return;
      }
      I32Sink sink{scratch.data(), 0.0f};
      bool ok;
      if (slot_of) {
        SlotSink<I32Sink> ss{sink, slot_of};
        ok = decode_xtc_coords_t(h, first_n, ss);
      } else {
        ok = decode_xtc_coords_t(h, first_n, sink);
      }
      if (!ok) {
        status.store(-1);
        return;
      }
      float p = h.plain ? 1000.0f : h.precision;
      float s = 1.0f / p;
      float box[3] = {h.box[0], h.box[4], h.box[8]};
      float ref[3];
      if (ref_mode == 0) {
        ref[0] = ref_point[0];
        ref[1] = ref_point[1];
        ref[2] = ref_point[2];
      } else {
        // per-frame reference: box center, or the selection's refined
        // circular COG via the vectorized poly-trig estimator
        // (bai_breen_axis, the b7g leaflet channel's production path —
        // the refinement pass cancels the estimate analytically, so the
        // poly approximation only matters through rare wrap-boundary
        // atoms; measured: libm f64 trig over a membrane-sized
        // selection bound the whole decode at ~4 ms/frame)
        for (int a = 0; a < 3; a++)
          ref[a] = ref_mode == 1
                       ? box[a] * 0.5f
                       : (handle_pbc
                              ? bai_breen_axis(scratch.data(), geo_slots,
                                               n_geo, a, s, box[a])
                              : geo_cog_axis_naive(scratch.data(),
                                                   geo_slots, n_geo, a,
                                                   s));
      }
      uint8_t *dst = mask_out + (size_t)f * stride;
      std::memset(dst, 0, stride);
      for (int32_t j = 0; j < n_bonds; j++) {
        const int32_t *ia = scratch.data() + (size_t)bond_a[j] * 3;
        const int32_t *ib = scratch.data() + (size_t)bond_b[j] * 3;
        float mid[3];
        for (int a = 0; a < 3; a++) {
          // kernel formulation (core/order.py quantized path): single
          // rounding of the exact integer difference, then min-image
          float pa = (float)ia[a] * s;
          float d = (float)(ib[a] - ia[a]) * s;
          if (handle_pbc) d -= box[a] * std::nearbyintf(d / box[a]);
          mid[a] = pa + d * 0.5f;
        }
        if (geo_inside(mid, ref, box, g))
          dst[(size_t)j >> 3] |= (uint8_t)(1u << (j & 7));
      }
    }
  };
  int nt = std::max(1, (int)std::min<int64_t>(n_threads, n));
  if (nt == 1) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      if (lo < hi) threads.emplace_back(work, lo, hi);
    }
    for (auto &th : threads) th.join();
  }
  return status.load();
}

int32_t trr_decode(const char *path, const int64_t *frame_offsets, int64_t n,
                   int32_t first_n, float *out_coords, float *out_boxes,
                   float *out_times, int32_t *out_steps) {
  MappedFile mf;
  if (!mf.open(path)) return -1;
  for (int64_t f = 0; f < n; f++) {
    TrrHeader h;
    if (!parse_trr_header(mf.data, mf.size, (size_t)frame_offsets[f], &h))
      return -1;
    if (out_boxes) memcpy(out_boxes + f * 9, h.box, 9 * sizeof(float));
    if (out_times) out_times[f] = h.time;
    if (out_steps) out_steps[f] = h.step;
    if (!decode_trr_coords(h, first_n, out_coords + (size_t)f * first_n * 3))
      return -1;
  }
  return 0;
}

}  // extern "C"
