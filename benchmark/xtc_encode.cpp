// XTC encoder of the benchmark: writes frames whose coordinates are given
// as the integers of the XTC grid, so that the file holds exactly those
// integers. A frozen copy of the "3dfc" compressor of gorder_tpu_torch's
// codec (native/xdr.cpp `encode_xtc_frame`, the xdrfile algorithm with
// small-delta runs and the water-pair swap), taking int32 coordinates
// instead of rounding floats. It lives here so that a change to the
// program's codec cannot change the benchmark's inputs.
//
// XTC frames are independent records: `xtc_encode_append` encodes
// contiguous blocks of frames on several threads and appends them to the
// file in order.
//
// C ABI only; loaded from Python with ctypes (benchmark/xtc.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int32_t XTC_MAGIC = 1995;
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

// MSB-first bit writer.
struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;

  inline void put(int n, uint32_t value) {
    if (n == 0) return;
    acc = (acc << n) |
          (uint64_t)(value & ((n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1))));
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

inline void write_group_value(BitWriter &bw, int nbits, uint64_t value) {
  // bytes little-endian-first; the most significant byte carries the
  // remaining width (sendints' two cases, including zero padding)
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

inline void write_ints3(BitWriter &bw, int nbits, const uint32_t *sizes,
                        const int32_t *nums) {
  uint64_t v =
      ((uint64_t)nums[0] * sizes[1] + (uint64_t)nums[1]) * sizes[2] +
      (uint64_t)nums[2];
  write_group_value(bw, nbits, v);
}

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

// Compress one frame of integer coordinates (`natoms` > 9) into `file`.
// `ints` is the frame's (natoms, 3) grid integers; it is copied, since
// the water-pair swap reorders the working copy.
void encode_frame(std::vector<uint8_t> &file, int32_t natoms, int32_t step,
                  float time, const float *box9, const int32_t *ints_in,
                  float precision) {
  append_be32(file, (uint32_t)XTC_MAGIC);
  append_be32(file, (uint32_t)natoms);
  append_be32(file, (uint32_t)step);
  append_f32(file, time);
  for (int i = 0; i < 9; i++) append_f32(file, box9[i]);
  append_be32(file, (uint32_t)natoms);
  append_f32(file, precision);

  std::vector<int32_t> ints(ints_in, ints_in + (size_t)natoms * 3);
  int32_t minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
  int32_t maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
  int64_t mindiff = INT64_MAX;
  for (int i = 0; i < natoms; i++) {
    const int32_t *lint = ints.data() + (size_t)i * 3;
    for (int d = 0; d < 3; d++) {
      minint[d] = std::min(minint[d], lint[d]);
      maxint[d] = std::max(maxint[d], lint[d]);
    }
    if (i > 0) {
      const int32_t *old = lint - 3;
      int64_t diff = std::abs((int64_t)lint[0] - old[0]) +
                     std::abs((int64_t)lint[1] - old[1]) +
                     std::abs((int64_t)lint[2] - old[2]);
      mindiff = std::min(mindiff, diff);
    }
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
  if (sizeint[0] > 0xFFFFFF || sizeint[1] > 0xFFFFFF ||
      sizeint[2] > 0xFFFFFF) {
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
      sizesmall[0] = sizesmall[1] = sizesmall[2] =
          (uint32_t)MAGICINTS[smallidx];
    }
  }
  bw.flush();

  append_be32(file, (uint32_t)bw.out.size());
  file.insert(file.end(), bw.out.begin(), bw.out.end());
  size_t pad = (4 - (bw.out.size() & 3)) & 3;
  for (size_t k = 0; k < pad; k++) file.push_back(0);
}

}  // namespace

extern "C" {

const char *xtc_encode_error() { return g_error.c_str(); }

// Append `n_frames` frames of `natoms` (> 9) atoms to the XTC file at
// `path` (created when `append` is 0). `ints` is (n_frames, natoms, 3)
// int32 grid integers, `boxes` (n_frames, 9) f32 nm, `times` (n_frames)
// f32 ps, `steps` (n_frames) int32. Blocks of frames are encoded on
// `n_threads` threads and written in frame order. → bytes written, or -1
// (the message in xtc_encode_error()).
int64_t xtc_encode_append(const char *path, int32_t natoms, int64_t n_frames,
                          const int32_t *ints, const float *boxes,
                          const float *times, const int32_t *steps,
                          float precision, int32_t n_threads,
                          int32_t append) {
  if (natoms <= 9) {
    g_error = "the encoder needs more than 9 atoms a frame";
    return -1;
  }
  int64_t n_blocks = std::max<int64_t>(
      1, std::min<int64_t>(n_frames, std::max(1, n_threads)));
  std::vector<std::vector<uint8_t>> blocks((size_t)n_blocks);
  auto work = [&](int64_t b) {
    int64_t f0 = n_frames * b / n_blocks;
    int64_t f1 = n_frames * (b + 1) / n_blocks;
    std::vector<uint8_t> &buf = blocks[(size_t)b];
    buf.reserve((size_t)(f1 - f0) * ((size_t)natoms * 4 + 128));
    for (int64_t f = f0; f < f1; f++)
      encode_frame(buf, natoms, steps[f], times[f], boxes + f * 9,
                   ints + (size_t)f * natoms * 3, precision);
  };
  std::vector<std::thread> threads;
  for (int64_t b = 1; b < n_blocks; b++) threads.emplace_back(work, b);
  work(0);
  for (auto &t : threads) t.join();

  FILE *fh = fopen(path, append ? "ab" : "wb");
  if (!fh) {
    g_error = std::string("could not open '") + path + "' for writing";
    return -1;
  }
  int64_t total = 0;
  for (auto &buf : blocks) {
    if (fwrite(buf.data(), 1, buf.size(), fh) != buf.size()) {
      fclose(fh);
      g_error = "short write";
      return -1;
    }
    total += (int64_t)buf.size();
  }
  if (fclose(fh) != 0) {
    g_error = "close failed";
    return -1;
  }
  return total;
}

}  // extern "C"
