// XTC decoder for Hopper (sm_90a): the xtc wire's rows, each frame's whole
// record as native/xdr.cpp xtc_read_raw copies it from the file, into the
// (B, n_out, 3) int32 XTC integers, integer for integer the host codec's
// (native/xdr.cpp CoordStepper, the 3dfc stream of xdrfile).
//
// It replaces no TPU kernel: the JAX package decodes XTC on the host
// (gorder_tpu/native/xdr.cpp), and so does every other wire of this port.
// It was added because the host decode paced the port: the batch loop
// waited on the decode thread for most of each analysis, with the card
// idle. The xtc wire ships the compressed records instead, and this
// kernel decodes them where the step reads them.
//
// What bounds it: one frame's serial chain. A frame's stream is one bit
// stream read front to back. Where an atom's bits start depends on every
// atom before it (the field widths follow smallidx, which every run may
// move), and each small atom is the previous atom plus a delta. So a
// frame is one thread, and nothing inside a frame runs side by side. The
// design answers that with frames side by side: one thread a frame, in a
// warp of its own, so a batch of 512 frames is one wave of warps over the
// 132 SMs and takes about one frame's chain (2, 4 and 8 frames a warp,
// which serialise their divergent runs, measured 1.7-3.1x slower: PERF.md
// §6). The chain is kept short: the stream is read 8 bytes at a time
// through the read-only path, each word loaded a word before it is needed
// and the L1 line three lines ahead prefetched; a grouped value splits
// into its three integers by
// multiply-high with a reciprocal and one correction, not by 64-bit
// division; `slot_of` is read through the read-only path; every output
// integer is written once.
//
// The rules are the host's, step for step: the magic-int table with
// smallidx moving up and down, the run flag that keeps the previous run
// length, the water-pair swap (the first small atom of a run is emitted
// before the large atom it was coded against, and is the next delta's
// base), the bitsize == 0 path for integer spans above 2^24, the stop at
// first_n, and the `slot_of` gather. A read past the payload, a header
// the host decoder refuses, a smallidx that leaves the table and a group
// wider than the 64 bits the host reads set the frame's status; the
// caller raises when the batch drains. Rows of length 0 are padding: all
// zeros, status 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFirstIdx = 9;
constexpr int kLastIdx = 72;
// The header of a compressed frame: magic, natoms, step, time, box (9),
// natoms, precision, minint (3), maxint (3), smallidx, byte count.
constexpr int kHeaderBytes = 92;
constexpr int kMagic = 1995;

// The frame's status (the wrapper's messages, ops/xtc.py STATUS).
constexpr int kOk = 0;
constexpr int kBadHeader = 1;
constexpr int kBadRun = 2;
constexpr int kOverrun = 3;

__constant__ int kMagicInts[kLastIdx + 1] = {
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

// floor((2^64 - 1) / MAGICINTS[i]), 0 where the entry is 0: the
// reciprocal `Divisor` takes for a small atom's group.
#define R(d) (~0ull / ((d) ? (d##ull) : 1ull) * ((d) != 0))
__constant__ unsigned long long kSmallRecip[kLastIdx + 1] = {
    R(0), R(0), R(0), R(0), R(0), R(0), R(0), R(0), R(0), R(8), R(10), R(12),
    R(16), R(20), R(25), R(32), R(40), R(50), R(64), R(80), R(101), R(128),
    R(161), R(203), R(256), R(322), R(406), R(512), R(645), R(812), R(1024),
    R(1290), R(1625), R(2048), R(2580), R(3250), R(4096), R(5060), R(6501),
    R(8192), R(10321), R(13003), R(16384), R(20642), R(26007), R(32768),
    R(41285), R(52015), R(65536), R(82570), R(104031), R(131072), R(165140),
    R(208063), R(262144), R(330280), R(416127), R(524287), R(660561),
    R(832255), R(1048576), R(1321122), R(1664510), R(2097152), R(2642245),
    R(3329021), R(4194304), R(5284491), R(6658042), R(8388607), R(10568983),
    R(13316085), R(16777216)};
#undef R

struct Args {
  const uint8_t* raw;    // (B, stride) rows
  const int* lengths;    // (B,) record bytes, 0 = padding
  const int* slot_of;    // (first_n,) slot of each atom, -1 = skip; or
                         // null: atom i in slot i
  int* out;              // (B, n_out, 3)
  int* status;           // (B,)
  int n_frames;
  long long stride;      // bytes a row, a multiple of 8
  int first_n;
  int n_out;
};

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// The 8 bytes at p as one big-endian integer.
__device__ __forceinline__ unsigned long long be64(unsigned long long x) {
  return (static_cast<unsigned long long>(bswap32(static_cast<uint32_t>(x)))
          << 32) |
         bswap32(static_cast<uint32_t>(x >> 32));
}

// Exact q = v / d and r = v % d for d >= 1 and any 64-bit v, from
// m = floor((2^64 - 1) / d): umulhi(v, m) falls short of q by at most 1,
// since 2^64 - m*d <= d puts v*m/2^64 within v/2^64 < 1 of v/d.
struct Divisor {
  unsigned long long d, m;
  __device__ __forceinline__ unsigned long long div(unsigned long long v,
                                                    unsigned long long& r)
      const {
    unsigned long long q = __umul64hi(v, m);
    r = v - q * d;
    if (r >= d) {
      ++q;
      r -= d;
    }
    return q;
  }
};

// MSB-first bit reader over a row, as native/xdr.cpp BitReader reads a
// payload. `cur` and `nxt` hold the two words the next field may span,
// `ahead` the word after them, loaded one word before it is needed.
struct Bits {
  const unsigned long long* w;
  long long nwords, word;  // the row's words; cur = w[word]
  unsigned long long cur, nxt, ahead;
  int pos;                 // bit offset in cur, 0..63
  long long left;          // payload bits not read yet (< 0: overrun)

  __device__ __forceinline__ unsigned long long load(long long i) const {
    return i < nwords ? be64(__ldg(w + i)) : 0ull;
  }

  __device__ __forceinline__ void init(const uint8_t* row, long long stride,
                                       long long first_bit,
                                       long long n_bits) {
    w = reinterpret_cast<const unsigned long long*>(row);
    nwords = stride / 8;
    word = first_bit >> 6;
    pos = static_cast<int>(first_bit & 63);
    cur = load(word);
    nxt = load(word + 1);
    ahead = load(word + 2);
    left = n_bits;
  }

  // The next n bits, 1 <= n <= 64.
  __device__ __forceinline__ unsigned long long get(int n) {
    const unsigned long long win = (cur << pos) | ((nxt >> 1) >> (63 - pos));
    const unsigned long long v = win >> (64 - n);
    left -= n;
    pos += n;
    if (pos >= 64) {
      pos -= 64;
      ++word;
      cur = nxt;
      nxt = ahead;
      ahead = load(word + 2);
      if ((word & 15) == 0 && word + 48 < nwords)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(w + word + 48));
    }
    return v;
  }

  // A grouped value of n <= 64 bits: its bytes come least significant
  // first, MSB-first bits, the last n % 8 bits the most significant
  // (native/xdr.cpp read_group_value).
  __device__ __forceinline__ unsigned long long group(int n) {
    const unsigned long long field = get(n);
    const int r = n & 7, k = n >> 3;
    unsigned long long v = 0;
    if (k > 0) v = be64(field >> r) >> (64 - 8 * k);
    if (r > 0) v |= (field & ((1ull << r) - 1)) << (8 * k);
    return v;
  }
};

// Bits to hold `size` distinct values (xdrfile sizeofint).
__device__ int size_of_int(uint32_t size) {
  int bits = 0;
  uint32_t num = 1;
  while (size >= num && bits < 32) {
    ++bits;
    num <<= 1;
  }
  return bits;
}

// The big-endian 32-bit word at byte 4 * j of a row.
__device__ __forceinline__ int32_t header_word(const uint8_t* row, int j) {
  return static_cast<int32_t>(
      bswap32(__ldg(reinterpret_cast<const uint32_t*>(row) + j)));
}

// One frame a block of one warp; its first lane decodes it.
__global__ void __launch_bounds__(32) xtc_decode_kernel(Args a) {
  if (threadIdx.x != 0) return;
  const int f = blockIdx.x;
  int* out = a.out + static_cast<long long>(f) * a.n_out * 3;
  const uint8_t* row = a.raw + static_cast<long long>(f) * a.stride;
  const int length = __ldg(a.lengths + f);
  int status = kOk;
  int filled = 0;  // one past the highest slot written

  // the header, checked as native/xdr.cpp parse_xtc_header and
  // CoordStepper::init check it
  const int natoms = length ? header_word(row, 1) : 0;
  long long n_bits = 0;
  uint32_t sizeint[3] = {1, 1, 1};
  int bitsizeint[3] = {0, 0, 0};
  int bitsize = 0;
  int32_t minint[3] = {0, 0, 0};
  int smallidx = 0;
  if (length) {
    const int nbytes = header_word(row, 22);
    smallidx = header_word(row, 21);
    if (length < kHeaderBytes || header_word(row, 0) != kMagic ||
        natoms <= 9 || header_word(row, 13) != natoms || nbytes < 0 ||
        kHeaderBytes + static_cast<long long>(nbytes) > length ||
        smallidx < kFirstIdx || smallidx > kLastIdx)
      status = kBadHeader;
    bool wide = false;
    for (int k = 0; k < 3 && status == kOk; ++k) {
      minint[k] = header_word(row, 15 + k);
      const long long span = static_cast<long long>(header_word(row, 18 + k)) -
                             minint[k] + 1;
      if (span <= 0 || span > 0xFFFFFFFFll) status = kBadHeader;
      sizeint[k] = static_cast<uint32_t>(span);
      wide = wide || sizeint[k] > 0xFFFFFFu;
    }
    if (status == kOk) {
      if (wide) {
        for (int k = 0; k < 3; ++k) bitsizeint[k] = size_of_int(sizeint[k]);
      } else {
        // xdrfile sizeofints: the bit length of the product of the sizes
        const unsigned long long p01 =
            static_cast<unsigned long long>(sizeint[0]) * sizeint[1];
        const unsigned long long lo = p01 * sizeint[2];
        const unsigned long long hi = __umul64hi(p01, sizeint[2]);
        bitsize = hi ? 128 - __clzll(hi) : 64 - __clzll(lo);
        if (bitsize > 64) status = kBadHeader;  // wider than the host reads
      }
    }
    n_bits = 8ll * nbytes;
  }

  if (length && status == kOk) {
    Bits br;
    br.init(row, a.stride, 8ll * kHeaderBytes, n_bits);
    const int first_n = min(a.first_n, natoms);
    const Divisor d2{sizeint[2], ~0ull / sizeint[2]};
    const Divisor d1{sizeint[1], ~0ull / sizeint[1]};
    int smaller =
        kMagicInts[max(kFirstIdx, smallidx - 1)] / 2;
    int smallnum = kMagicInts[smallidx] / 2;
    unsigned long long sizesmall = kMagicInts[smallidx];
    int i = 0, written = 0, run = 0;
    int32_t prev[3];

    auto emit = [&](const int32_t* c) {
      if (written < first_n) {
        const int s = a.slot_of ? __ldg(a.slot_of + written) : written;
        if (s >= 0 && s < a.n_out) {
          int* o = out + 3ll * s;
          o[0] = c[0];
          o[1] = c[1];
          o[2] = c[2];
          filled = max(filled, s + 1);
        }
      }
      ++written;
    };

    while (i < natoms && written < first_n) {
      int32_t c[3];
      if (bitsize != 0) {
        unsigned long long r2, r1;
        const unsigned long long q = d2.div(br.group(bitsize), r2);
        c[0] = static_cast<int32_t>(d1.div(q, r1));
        c[1] = static_cast<int32_t>(r1);
        c[2] = static_cast<int32_t>(r2);
      } else {
        c[0] = static_cast<int32_t>(br.get(bitsizeint[0]));
        c[1] = static_cast<int32_t>(br.get(bitsizeint[1]));
        c[2] = static_cast<int32_t>(br.get(bitsizeint[2]));
      }
      const unsigned flag = static_cast<unsigned>(br.get(1));
      ++i;
      for (int k = 0; k < 3; ++k) {
        c[k] = static_cast<int32_t>(static_cast<uint32_t>(c[k]) +
                                    static_cast<uint32_t>(minint[k]));
        prev[k] = c[k];
      }
      int is_smaller = 0;
      if (flag) {
        run = static_cast<int>(br.get(5));
        is_smaller = run % 3;
        run -= is_smaller;
        --is_smaller;
      }
      if (run > 0) {
        if (smallidx > 64) {  // wider than the host reads
          status = kBadRun;
          break;
        }
        const Divisor ds{sizesmall, kSmallRecip[smallidx]};
        const uint32_t base = static_cast<uint32_t>(smallnum);
        // the water-pair swap: the first small atom goes out before the
        // large atom, and is the base of the next delta
        for (int k = 0; k < run; k += 3) {
          unsigned long long r2, r1;
          const unsigned long long q = ds.div(br.group(smallidx), r2);
          const unsigned long long q2 = ds.div(q, r1);
          c[0] = static_cast<int32_t>(static_cast<uint32_t>(q2) +
                                      static_cast<uint32_t>(prev[0]) - base);
          c[1] = static_cast<int32_t>(static_cast<uint32_t>(r1) +
                                      static_cast<uint32_t>(prev[1]) - base);
          c[2] = static_cast<int32_t>(static_cast<uint32_t>(r2) +
                                      static_cast<uint32_t>(prev[2]) - base);
          ++i;
          if (k == 0) {
            emit(c);
            emit(prev);
          } else {
            emit(c);
          }
          prev[0] = c[0];
          prev[1] = c[1];
          prev[2] = c[2];
        }
      } else {
        emit(c);
      }
      smallidx += is_smaller;
      const int idx = min(max(smallidx, 0), kLastIdx);
      if (is_smaller < 0) {
        smallnum = smaller;
        smaller = smallidx > kFirstIdx ? kMagicInts[idx - 1] / 2 : 0;
      } else if (is_smaller > 0) {
        smaller = smallnum;
        smallnum = kMagicInts[idx] / 2;
      }
      if (smallidx < kFirstIdx || smallidx > kLastIdx ||
          kMagicInts[idx] == 0) {
        status = kBadRun;
        break;
      }
      sizesmall = kMagicInts[idx];
    }
    if (status == kOk && br.left < 0) status = kOverrun;
  }

  for (long long v = 3ll * filled; v < 3ll * a.n_out; ++v) out[v] = 0;
  a.status[f] = status;
}

}  // namespace

extern "C" {

// raw (B, stride) uint8 rows (stride a multiple of 8 and at least 96,
// rows 8-byte aligned), lengths (B,) int32, slot_of (first_n,) int32 or
// null (atom i to slot i) → out (B, n_out, 3) int32 and status (B,)
// int32, both written whole, on `stream`. Returns the first error (0 =
// launched).
int xtc_decode(const void* raw, const void* lengths, const void* slot_of,
               void* out, void* status, int n_frames, long long stride,
               int first_n, int n_out, void* stream) {
  if (n_frames < 0 || stride < kHeaderBytes + 4 || stride % 8 != 0 ||
      first_n < 0 || n_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0) return 0;
  const Args a{static_cast<const uint8_t*>(raw),
               static_cast<const int*>(lengths),
               static_cast<const int*>(slot_of),
               static_cast<int*>(out),
               static_cast<int*>(status),
               n_frames,
               stride,
               first_n,
               n_out};
  xtc_decode_kernel<<<n_frames, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
