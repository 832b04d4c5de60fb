"""The XTC decoder's wrapper and its plain version: the xtc wire's rows,
each frame's whole record as `io/traj.py Trajectory.read_frames_xtc`
copies it from the file, → the (B, n_out, 3) int32 XTC integers, integer
for integer the host codec's (native/xdr.cpp CoordStepper).

It replaces no TPU kernel: the JAX package decodes XTC on the host. The
kernel (`csrc/xtc.cu`) decodes one frame a thread, frames side by side,
since a frame's stream is one serial chain; the plain version runs the
same stepper one frame after another in Python. For tensors on the CPU
`xtc_ints` runs the plain version; for CUDA tensors it launches the
kernel on the current stream, or raises. There is no fallback from the
kernel to the plain version.

Both write each frame's status into `status` instead of raising, so that
no batch waits on the host for it: 0 decoded, else a key of `STATUS` (a
header the host decoder refuses, a smallidx that leaves the table or a
group wider than 64 bits, a read past the payload). The caller checks it
when the batch drains. A row of length 0 is padding: zeros, status 0.
The output's columns that no atom maps to are zero.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import call, check_tensor, device_of

#: the messages of a frame's nonzero status, as the host decoder words them
STATUS = {1: "invalid XTC frame header", 2: "corrupted XTC run encoding",
          3: "XTC payload overrun"}
#: bytes of a compressed frame's header (magic ... byte count)
HEADER_BYTES = 92

#: launches of the kernel since the last reset; the plain version counts
#: in none
xtc_decode_launches = 0

_FIRSTIDX, _LASTIDX = 9, 72
_MAGICINTS = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64, 80,
    101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290, 1625, 2048,
    2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384, 20642, 26007,
    32768, 41285, 52015, 65536, 82570, 104031, 131072, 165140, 208063,
    262144, 330280, 416127, 524287, 660561, 832255, 1048576, 1321122,
    1664510, 2097152, 2642245, 3329021, 4194304, 5284491, 6658042, 8388607,
    10568983, 13316085, 16777216)
_U64 = (1 << 64) - 1


def divide(v: int, d: int):
    """(v // d, v % d) for 0 <= v < 2^64 and d >= 1 as the kernel divides
    (`Divisor`): the high 64 bits of v · floor((2^64 - 1) / d), then one
    correction."""
    q = (v * (_U64 // d)) >> 64
    r = v - q * d
    if r >= d:
        q, r = q + 1, r - d
    return q, r


def _int32(x: int) -> int:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class _Bits:
    """MSB-first bits of a row from bit `start`, `left` of them payload."""

    def __init__(self, row: bytes, start: int, n_bits: int):
        self.row = row
        self.pos = start
        self.left = n_bits

    def get(self, n: int) -> int:
        """The next n bits, 1 <= n <= 64."""
        byte, off = self.pos >> 3, self.pos & 7
        chunk = int.from_bytes(self.row[byte:byte + 9].ljust(9, b"\0"),
                               "big")
        self.pos += n
        self.left -= n
        return (chunk >> (72 - off - n)) & ((1 << n) - 1)

    def group(self, n: int) -> int:
        """A grouped value of n <= 64 bits: its bytes least significant
        first, the last n % 8 bits the most significant."""
        field = self.get(n)
        r, k = n & 7, n >> 3
        v = int.from_bytes((field >> r).to_bytes(k, "big"), "little") \
            if k else 0
        return v | ((field & ((1 << r) - 1)) << (8 * k))


def _word(row: bytes, j: int) -> int:
    return int.from_bytes(row[4 * j:4 * j + 4], "big", signed=True)


def _size_of_int(size: int) -> int:
    bits, num = 0, 1
    while size >= num and bits < 32:
        bits, num = bits + 1, num << 1
    return bits


def decode_frame(row: bytes, length: int, slot_of, first_n: int,
                 out: np.ndarray, seen=None) -> int:
    """Decode one row into `out` ((n_out, 3) int32, zero) as the kernel
    does; → its status. `seen`, a set, collects the stream's rules this
    frame took: ("run", small atoms) of every run, ("smallidx", ±1) of
    every move of smallidx, ("wide",) for the bitsize == 0 path."""
    if not length:
        return 0
    natoms, smallidx, nbytes = _word(row, 1), _word(row, 21), _word(row, 22)
    if (length < HEADER_BYTES or _word(row, 0) != 1995 or natoms <= 9
            or _word(row, 13) != natoms or nbytes < 0
            or HEADER_BYTES + nbytes > length
            or not _FIRSTIDX <= smallidx <= _LASTIDX):
        return 1
    minint = [_word(row, 15 + k) for k in range(3)]
    sizeint = [_word(row, 18 + k) - minint[k] + 1 for k in range(3)]
    if any(s <= 0 or s > 0xFFFFFFFF for s in sizeint):
        return 1
    bitsize, bitsizeint = 0, [0, 0, 0]
    if any(s > 0xFFFFFF for s in sizeint):
        bitsizeint = [_size_of_int(s) for s in sizeint]
        if seen is not None:
            seen.add(("wide",))
    else:
        # xdrfile sizeofints: the bit length of the sizes' product
        bitsize = (sizeint[0] * sizeint[1] * sizeint[2]).bit_length()
        if bitsize > 64:
            return 1
    br = _Bits(row, 8 * HEADER_BYTES, 8 * nbytes)
    first_n = min(first_n, natoms)
    n_out = out.shape[0]
    smaller = _MAGICINTS[max(_FIRSTIDX, smallidx - 1)] // 2
    smallnum = _MAGICINTS[smallidx] // 2
    sizesmall = _MAGICINTS[smallidx]
    i = written = run = 0
    status = 0

    def emit(c):
        nonlocal written
        if written < first_n:
            s = slot_of[written] if slot_of is not None else written
            if 0 <= s < n_out:
                out[s] = c
        written += 1

    while i < natoms and written < first_n:
        if bitsize:
            q, c2 = divide(br.group(bitsize), sizeint[2])
            c0, c1 = divide(q, sizeint[1])
            c = [_int32(c0), c1, c2]
        else:
            c = [br.get(bitsizeint[k]) for k in range(3)]
        flag = br.get(1)
        i += 1
        c = [_int32(c[k] + minint[k]) for k in range(3)]
        prev = c
        is_smaller = 0
        if flag:
            run = br.get(5)
            is_smaller = run % 3
            run -= is_smaller
            is_smaller -= 1
        if seen is not None and run > 0:
            seen.add(("run", run // 3))
        if seen is not None and is_smaller:
            seen.add(("smallidx", is_smaller))
        if run > 0:
            if smallidx > 64:
                status = 2
                break
            for k in range(0, run, 3):
                q, r2 = divide(br.group(smallidx), sizesmall)
                q2, r1 = divide(q, sizesmall)
                c = [_int32(q2 + prev[0] - smallnum),
                     _int32(r1 + prev[1] - smallnum),
                     _int32(r2 + prev[2] - smallnum)]
                i += 1
                emit(c)
                if k == 0:
                    # the water-pair swap: the small atom goes out first
                    emit(prev)
                prev = c
        else:
            emit(c)
        smallidx += is_smaller
        idx = min(max(smallidx, 0), _LASTIDX)
        if is_smaller < 0:
            smallnum = smaller
            smaller = _MAGICINTS[idx - 1] // 2 if smallidx > _FIRSTIDX \
                else 0
        elif is_smaller > 0:
            smaller = smallnum
            smallnum = _MAGICINTS[idx] // 2
        if not _FIRSTIDX <= smallidx <= _LASTIDX or not _MAGICINTS[idx]:
            status = 2
            break
        sizesmall = _MAGICINTS[idx]
    if status == 0 and br.left < 0:
        status = 3
    return status


def xtc_ints_plain(raw, lengths, slot_of, first_n: int, n_out: int,
                   status):
    """The plain version of `xtc_ints`: the frames one after another."""
    rows = raw.numpy()
    lens = lengths.numpy()
    slots = slot_of.numpy() if slot_of is not None else None
    out = np.zeros((rows.shape[0], n_out, 3), np.int32)
    codes = [decode_frame(rows[f].tobytes(), int(lens[f]), slots, first_n,
                          out[f]) for f in range(rows.shape[0])]
    status.copy_(torch.as_tensor(codes, dtype=torch.int32))
    return torch.from_numpy(out)


def xtc_ints(raw, lengths, slot_of, first_n: int, n_out: int, status):
    """The xtc wire → (B, n_out, 3) int32 XTC integers. raw (B, stride)
    uint8 rows, each a frame's whole record (stride a multiple of 8, at
    least 96), lengths (B,) int32 record bytes (0: padding), slot_of
    (first_n,) int32 slot of each of the first atoms (-1: not kept; its
    kept atoms one to one onto slots [0, n)), or None (atom i to slot i);
    status (B,) int32, which each frame's status is written into."""
    global xtc_decode_launches
    device = device_of(raw)
    n_frames = raw.shape[0]
    stride = raw.shape[1] if raw.dim() == 2 else -1
    check_tensor("raw", raw, torch.uint8, (n_frames, stride), device)
    if stride % 8 or stride < HEADER_BYTES + 4:
        raise ValueError(f"the rows are {stride} bytes: the decoder takes a "
                         f"multiple of 8, at least {HEADER_BYTES + 4}")
    check_tensor("lengths", lengths, torch.int32, (n_frames,), device)
    if slot_of is not None:
        check_tensor("slot_of", slot_of, torch.int32, (first_n,), device)
    check_tensor("status", status, torch.int32, (n_frames,), device)
    if device.type == "cpu":
        return xtc_ints_plain(raw, lengths, slot_of, first_n, n_out, status)
    if raw.data_ptr() % 8:
        raise ValueError("the rows are not 8-byte aligned")
    out = torch.empty((n_frames, n_out, 3), dtype=torch.int32,
                      device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        call("xtc_decode", raw.data_ptr(), lengths.data_ptr(),
             slot_of.data_ptr() if slot_of is not None else None,
             out.data_ptr(), status.data_ptr(), n_frames, stride, first_n,
             n_out, stream)
    xtc_decode_launches += 1
    return out
