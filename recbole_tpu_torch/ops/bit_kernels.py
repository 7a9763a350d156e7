"""Products with a packed-bit binary matrix at a batch of its rows.

Port of recbole_tpu/ops/bit_kernels.py. ``bits`` is (n_major, nbytes)
uint8 in natural column order: column c of a row is bit (c % 8) of byte
c // 8 (the layout of ops/bitgraph.py's ``_pack_side``); ``rows`` (R,)
int64 picks rows of it, repeats allowed. Two functions:

* ``bit_rows_matmul(bits, rows, v, counts=None)`` replaces
  ``bit_rows_matmul`` (:56): ``B[rows] @ v`` for v (n_v, D) bfloat16, n_v <=
  nbytes * 8, an (R, D) float32 result; ``counts`` (n_major,) int32, the
  image's set bits a row, lets the kernel cut popular rows into pieces (it
  moves the work's balance, never the result);
* ``bit_cols_matmul(bits, rows, g)`` replaces ``bit_cols_matmul`` (:95):
  ``B[rows]^T @ g`` for g (R, D) bfloat16, an (nbytes * 8, D) float32
  result, duplicate rows summed.

The JAX kernels take the rows already gathered and v in shift-plane order;
the port's kernels read the picked rows in place and keep the natural
order, so neither the gathered copy nor a permuted v is made. For each
function this module holds a plain PyTorch version (unpack to {0, 1}, then a
float32 product), the launcher of a hand-written Hopper kernel from
``csrc/bit_kernels.cu`` with a launch counter, and a dispatcher: the plain
version for CPU tensors, the kernel for CUDA tensors, no fallback between
them. The kernels sum in fp32 in an order fixed by the data, deterministic
(no float atomics). ``bit_cols_plan`` chooses the column kernel's grid on
the host; the row kernel plans its work on the card (two launches a call).
The kernels take an even D up to 128; the dispatchers route any D before
launch (``column_slices``): an odd D is zero-padded by one column, dropped
from the output, and a D past 128 runs as slices of at most 128 columns of v
(or g), concatenated, the output columns being independent.
"""

import ctypes

import torch
from torch.nn import functional as F

from . import cuda_build


def unpack_bits(packed):
    """(R, nbytes) uint8 -> (R, nbytes * 8) uint8 of {0, 1}, column 8 b + s
    being bit s of byte b."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], packed.shape[1] * 8)


def pad_k(v, k_pad):
    """Zero-pad (N, D) to (k_pad, D) so it matches the unpacked bit width."""
    if v.shape[0] > k_pad:
        raise ValueError(f"{v.shape[0]} rows do not fit {k_pad} bit columns")
    return torch.cat([v, v.new_zeros((k_pad - v.shape[0], v.shape[1]))], dim=0)


# ------------------------------------------------------------ plain versions

def bit_rows_matmul_torch(bits, rows, v):
    """Plain version: the picked rows unpacked to {0, 1}, then a float32
    product with v padded to the bit width (exact terms, fp32 sums)."""
    unpacked = unpack_bits(bits[rows]).to(torch.float32)
    return unpacked @ pad_k(v, unpacked.shape[1]).to(torch.float32)


def bit_cols_matmul_torch(bits, rows, g):
    """Plain version: the transposed product, contracted over R."""
    unpacked = unpack_bits(bits[rows]).to(torch.float32)
    return unpacked.T @ g.to(torch.float32)


# ------------------------------------------------------ the column kernel's grid

# csrc/bit_kernels.cu's column kernel: a strip is 32 bytes of every row (256
# output rows), a block stages 128 picked rows at a time, a thread-block
# cluster of 1 to 16 blocks owns a strip; checked against the library's own
# limits when it is loaded
STRIP_BYTES = 32
TILE_ROWS = 128
MAX_CLUSTER = 16
MAX_D = 128
# a block's fixed cost (zeroing its sums, filling its pipeline, the cluster's
# sum and the stores) in picked rows of work; with it the plan picks the
# cluster size that timed fastest at the Yelp sides and ml-100k's on an H100
# (scripts/torch_bit_ab.py --clusters)
BLOCK_COST_ROWS = 512


def bit_cols_plan(R, nbytes, D, sms, blocks_per_sm, max_cluster=MAX_CLUSTER):
    """The column kernel's grid for R picked rows of nbytes bytes at D, on a
    card of ``sms`` SMs holding ``blocks_per_sm`` of its blocks at once.

    A cluster of C blocks owns each 32-byte strip; block k sums the k-th of C
    equal slices of the picked rows (the kernel splits them itself). C is the
    power of two up to ``max_cluster``, with at least a tile of rows a block,
    that gives the least
    ``waves * (rows a block + BLOCK_COST_ROWS)``, a wave being the blocks the
    card holds at once; the smallest such C on a tie. Splitting the rows
    shortens the warps that own popular columns and fills the card when there
    are few strips; every extra block pays the fixed cost. Raises on a shape
    the kernel does not take."""
    if not 2 <= D <= MAX_D or D % 2:
        raise ValueError(f"the column kernel takes an even D <= {MAX_D}, got {D}")
    if nbytes < STRIP_BYTES or nbytes % STRIP_BYTES:
        raise ValueError(f"the column kernel takes rows of a multiple of {STRIP_BYTES} bytes, "
                         f"got {nbytes}")
    if R < 0 or sms < 1 or blocks_per_sm < 1 or not 1 <= max_cluster <= MAX_CLUSTER:
        raise ValueError(f"no grid for R={R} on {sms} SMs x {blocks_per_sm} blocks, clusters "
                         f"up to {max_cluster}")
    strips = nbytes // STRIP_BYTES
    slots = sms * blocks_per_sm
    best = None
    C = 1
    while C <= max_cluster and (C == 1 or -(-R // C) >= TILE_ROWS):
        waves = -(-strips * C // slots)
        cost = waves * (-(-R // C) + BLOCK_COST_ROWS)
        if best is None or cost < best[0]:
            best = (cost, C, waves)
        C *= 2
    _, C, waves = best
    return {"strips": strips, "cluster": C, "blocks": strips * C, "slots": slots,
            "waves": waves}


# ----------------------------------------------------------------- launchers

_LIB = None
_OCCUPANCY = {}
_ROWS_OCCUPANCY = {}
# the row kernel's counters a call (csrc/bit_kernels.cu's enum, in order), the
# first words of its scratch (``rows_counters``)
ROWS_COUNTERS = ("slots taken", "walk blocks done", "picks resolved", "unsplit walkers",
                 "split walkers", "copies", "picks outside")

# the row kernel's state between calls, one per (device, stream): owner words
# of the largest image called on and the epoch; a grown state replaces the
# old one, which stays alive (a captured CUDA graph may still use it)
_ROWS_STATE = {}
_ROWS_STATES_KEPT = []
_ROWS_SIZES = {}


def _lib():
    """The built library and its limits, loaded once."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("bit_kernels")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.bit_kernels_limits.argtypes = [ip, ip, ip]
        lib.bit_kernels_limits.restype = None
        lib.bit_cols_smem_bytes.argtypes = [i]
        lib.bit_cols_smem_bytes.restype = ll
        lib.bit_cols_occupancy.argtypes = [i, ip, ip, ip]
        lib.bit_cols_occupancy.restype = i
        llp = ctypes.POINTER(ctypes.c_longlong)
        lib.bit_rows_sizes.argtypes = [i, i, llp, llp, ip]
        lib.bit_rows_sizes.restype = i
        lib.bit_rows_occupancy.argtypes = [i, ip, ip]
        lib.bit_rows_occupancy.restype = i
        lib.bit_rows_launch.argtypes = [p, ll, i, p, i, p, ll, i, p, p, p, p, p, i, p, p, ip]
        lib.bit_rows_launch.restype = i
        lib.bit_cols_launch.argtypes = [p, ll, i, p, i, p, i, i, p, p, ip]
        lib.bit_cols_launch.restype = i
        max_d, d_multiple, multiple = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.bit_kernels_limits(ctypes.byref(max_d), ctypes.byref(d_multiple),
                               ctypes.byref(multiple))
        lib.limits = {"max_d": max_d.value, "d_multiple": d_multiple.value,
                      "nbytes_multiple": multiple.value}
        if (max_d.value, multiple.value) != (MAX_D, STRIP_BYTES):
            raise RuntimeError(f"csrc/bit_kernels.cu's limits {lib.limits} do not match "
                               f"ops/bit_kernels.py's (D <= {MAX_D}, {STRIP_BYTES}-byte strips)")
        words, pairs, ctr = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_int()
        lib.bit_rows_sizes(1, 2, ctypes.byref(words), ctypes.byref(pairs), ctypes.byref(ctr))
        if ctr.value != len(ROWS_COUNTERS):
            raise RuntimeError(f"csrc/bit_kernels.cu keeps {ctr.value} row-kernel counters, "
                               f"ops/bit_kernels.py names {len(ROWS_COUNTERS)}")
        _LIB = lib
    return _LIB


def cols_occupancy(device, D):
    """(SMs, blocks an SM holds at once, the largest cluster) of the column
    kernel at D on the CUDA device ``device``, asked of the runtime once per
    device and D."""
    key = (device.index, D)
    if key not in _OCCUPANCY:
        sms, per_sm, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            err = _lib().bit_cols_occupancy(D, ctypes.byref(sms), ctypes.byref(per_sm),
                                            ctypes.byref(most))
        if err:
            raise RuntimeError(f"bit_cols occupancy query failed: CUDA error {err}")
        _OCCUPANCY[key] = (sms.value, per_sm.value, most.value)
    return _OCCUPANCY[key]


def rows_occupancy(device, D):
    """(SMs, blocks an SM holds at once) of the row kernel's walk at D on the
    CUDA device ``device``, asked of the runtime once per device and D."""
    key = (device.index, D)
    if key not in _ROWS_OCCUPANCY:
        sms, per_sm = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            err = _lib().bit_rows_occupancy(D, ctypes.byref(sms), ctypes.byref(per_sm))
        if err:
            raise RuntimeError(f"bit_rows occupancy query failed: CUDA error {err}")
        _ROWS_OCCUPANCY[key] = (sms.value, per_sm.value)
    return _ROWS_OCCUPANCY[key]


def rows_scratch_sizes(R, D):
    """(int32 words, float pairs) of a row-kernel call's scratch at R and D,
    asked of the library once per (R, D); the words rounded up to even so
    that the pairs that follow them are 8-byte aligned."""
    key = (R, D)
    if key not in _ROWS_SIZES:
        words, pairs, ctr = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_int()
        err = _lib().bit_rows_sizes(R, D, ctypes.byref(words), ctypes.byref(pairs),
                                    ctypes.byref(ctr))
        if err:
            raise RuntimeError(f"bit_rows scratch sizes failed: CUDA error {err}")
        _ROWS_SIZES[key] = (words.value + words.value % 2, pairs.value)
    return _ROWS_SIZES[key]


def rows_state(device, stream, n_major):
    """The row kernel's (owner words, epoch) on ``device`` for calls on
    ``stream``, with at least ``n_major`` owner words: zeros when made, then
    kept by the kernels (each call tags the words it claims with its epoch,
    the next call's epoch is one more)."""
    key = (device.index, stream)
    state = _ROWS_STATE.get(key)
    if state is None or state[0].numel() < n_major:
        state = (torch.zeros(max(n_major, 1), dtype=torch.int64, device=device),
                 torch.zeros(1, dtype=torch.int64, device=device))
        _ROWS_STATE[key] = state
        _ROWS_STATES_KEPT.append(state)
    return state


def _check(name, bits, rows, x):
    """Validate the common arguments; returns (n_major, nbytes, R, D)."""
    if not (bits.is_cuda and rows.is_cuda and x.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors")
    if not (bits.device == rows.device == x.device):
        raise ValueError(f"{name}: bits, rows and its operand must share a device")
    if bits.dtype != torch.uint8 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError(f"{name} takes contiguous (n_major, nbytes) uint8 bits")
    if rows.dtype != torch.int64 or rows.dim() != 1 or not rows.is_contiguous():
        raise TypeError(f"{name} takes contiguous (R,) int64 rows, got {rows.dtype} "
                        f"{tuple(rows.shape)}")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"{name} takes a contiguous 2-d bfloat16 operand, got {x.dtype} "
                        f"{tuple(x.shape)}")
    n_major, nbytes = bits.shape
    multiple = _lib().limits["nbytes_multiple"]
    if nbytes < multiple or nbytes % multiple or bits.data_ptr() % 16:
        raise ValueError(f"{name} takes rows of a multiple of {multiple} bytes, 16-byte "
                         f"aligned; got nbytes {nbytes}")
    D = x.shape[1]
    max_d, d_multiple = _lib().limits["max_d"], _lib().limits["d_multiple"]
    if not 1 <= D <= max_d or D % d_multiple:
        raise ValueError(f"{name} takes D <= {max_d}, a multiple of {d_multiple}, got {D}")
    if rows.numel() >= 1 << 31:
        raise ValueError(f"{name} takes fewer than 2^31 rows")
    return n_major, nbytes, rows.numel(), D


def bit_rows_matmul_cuda(bits, rows, v, counts=None):
    """Launch ``bit_rows_claim_kernel`` and ``bit_rows_kernel``; same
    contract as ``bit_rows_matmul_torch``. ``counts`` (n_major,) int32 on the
    same device, the image's set bits a row (None: every row walked whole),
    only balances the work. Counts its calls in
    ``bit_rows_matmul_cuda.launches`` and the kernels they launch in
    ``.kernel_launches``; keeps the walk's grid as the launcher reports it in
    ``.last_grid`` and the call's scratch in ``.last_scratch`` (its counters:
    ``rows_counters``)."""
    name = "bit_rows_matmul_cuda"
    n_major, nbytes, R, D = _check(name, bits, rows, v)
    if v.shape[0] > nbytes * 8:
        raise ValueError(f"{name}: v has {v.shape[0]} rows, the bits {nbytes * 8} columns")
    if counts is not None and (counts.dtype != torch.int32 or counts.shape != (n_major,)
                               or not counts.is_contiguous() or counts.device != v.device):
        raise TypeError(f"{name} takes contiguous ({n_major},) int32 counts on {v.device}, got "
                        f"{counts.dtype} {tuple(counts.shape)} on {counts.device}")
    out = torch.empty((R, D), dtype=torch.float32, device=v.device)
    if R == 0:
        return out
    words, pairs = rows_scratch_sizes(R, D)
    # the plan's int32 words, then the partial sums' float pairs (8-byte aligned)
    scratch = torch.empty(words + 2 * pairs, dtype=torch.int32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    owner, epoch = rows_state(v.device, stream, n_major)
    sms, per_sm = rows_occupancy(v.device, D)
    report = (ctypes.c_int * 4)()
    err = _lib().bit_rows_launch(bits.data_ptr(), n_major, nbytes, rows.data_ptr(), R,
                                 v.data_ptr(), v.shape[0], D,
                                 None if counts is None else counts.data_ptr(),
                                 owner.data_ptr(), epoch.data_ptr(), scratch.data_ptr(),
                                 scratch.data_ptr() + 4 * words, sms * per_sm, out.data_ptr(),
                                 stream, report)
    if err:
        raise RuntimeError(f"bit_rows kernel launch failed: CUDA error {err}")
    bit_rows_matmul_cuda.launches += 1
    bit_rows_matmul_cuda.kernel_launches += report[0]
    bit_rows_matmul_cuda.last_grid = {"blocks": report[1], "warps": report[2],
                                      "slots": report[3]}
    bit_rows_matmul_cuda.last_scratch = scratch
    return out


def rows_counters():
    """The last row-kernel call's counters by name (``ROWS_COUNTERS``): the
    first words of its scratch, read from the card (a synchronize)."""
    scratch = bit_rows_matmul_cuda.last_scratch
    return dict(zip(ROWS_COUNTERS, scratch[:len(ROWS_COUNTERS)].tolist()))


bit_rows_matmul_cuda.launches = 0
bit_rows_matmul_cuda.kernel_launches = 0
bit_rows_matmul_cuda.last_grid = None
bit_rows_matmul_cuda.last_scratch = None


def bit_cols_matmul_cuda(bits, rows, g):
    """Launch ``bit_cols_kernel`` on the grid of ``bit_cols_plan``; same
    contract as ``bit_cols_matmul_torch``. Counts its launches in
    ``bit_cols_matmul_cuda.launches`` and keeps the grid it launched (blocks,
    cluster size, as the launcher reports them) in
    ``bit_cols_matmul_cuda.last_grid``."""
    name = "bit_cols_matmul_cuda"
    n_major, nbytes, R, D = _check(name, bits, rows, g)
    if g.shape[0] != R:
        raise ValueError(f"{name}: g has {g.shape[0]} rows for {R} picked rows")
    plan = bit_cols_plan(R, nbytes, D, *cols_occupancy(g.device, D))
    out = torch.empty((nbytes * 8, D), dtype=torch.float32, device=g.device)
    grid = (ctypes.c_int * 2)()
    err = _lib().bit_cols_launch(bits.data_ptr(), n_major, nbytes, rows.data_ptr(), R,
                                 g.data_ptr(), D, plan["cluster"], out.data_ptr(),
                                 torch.cuda.current_stream(g.device).cuda_stream, grid)
    if err:
        raise RuntimeError(f"bit_cols kernel launch failed: CUDA error {err} (shared memory "
                           f"{_lib().bit_cols_smem_bytes(D)} bytes at D={D}, clusters of "
                           f"{plan['cluster']})")
    bit_cols_matmul_cuda.launches += 1
    bit_cols_matmul_cuda.last_grid = {"blocks": grid[0], "cluster": grid[1]}
    return out


bit_cols_matmul_cuda.launches = 0
bit_cols_matmul_cuda.last_grid = None


# --------------------------------------------------------------- dispatchers

def column_slices(D, width=MAX_D):
    """(Dp, [(lo, hi)]): D zero-padded to an even width, and the slices of
    at most ``width`` columns the kernels run on."""
    Dp = D + D % 2
    return Dp, [(lo, min(lo + width, Dp)) for lo in range(0, Dp, width)]


def by_column_slices(fn, x, width=MAX_D):
    """``fn(x)`` for an (n, D) operand at any D, where ``fn`` takes an even
    width up to ``width`` and its output's columns are x's: x zero-padded to
    an even width, run a slice at a time, the slices' outputs concatenated
    and the pad column dropped."""
    D = x.shape[1]
    Dp, slices = column_slices(D, width)
    if Dp != D:
        x = F.pad(x, (0, Dp - D))
    if len(slices) == 1:
        out = fn(x.contiguous())
    else:
        out = torch.cat([fn(x[:, lo:hi].contiguous()) for lo, hi in slices], dim=1)
    return out if Dp == D else out[:, :D]


def bit_rows_matmul(bits, rows, v, counts=None):
    """``B[rows] @ v`` -> (R, D) float32. The plain version for CPU tensors
    (``counts`` unused), the kernel otherwise, at any D (``by_column_slices``)."""
    if v.device.type == "cpu":
        return bit_rows_matmul_torch(bits, rows, v)
    return by_column_slices(lambda x: bit_rows_matmul_cuda(bits, rows, x, counts), v)


def bit_cols_matmul(bits, rows, g):
    """``B[rows]^T @ g`` -> (nbytes * 8, D) float32. The plain version for
    CPU tensors, the kernel otherwise, at any D (``by_column_slices``)."""
    if g.device.type == "cpu":
        return bit_cols_matmul_torch(bits, rows, g)
    return by_column_slices(lambda x: bit_cols_matmul_cuda(bits, rows, x), g)
