"""Products with a packed-bit binary matrix at a batch of its rows.

Port of recbole_tpu/ops/bit_kernels.py. ``bits`` is (n_major, nbytes)
uint8 in natural column order: column c of a row is bit (c % 8) of byte
c // 8 (the layout of ops/bitgraph.py's ``_pack_side``); ``rows`` (R,)
int64 picks rows of it, repeats allowed. Two functions:

* ``bit_rows_matmul(bits, rows, v)`` replaces ``bit_rows_matmul`` (:56):
  ``B[rows] @ v`` for v (n_v, D) bfloat16, n_v <= nbytes * 8, an (R, D)
  float32 result;
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
them. The kernels sum in fp32 in an order fixed by the data; the column
kernel is deterministic (no float atomics).
"""

import ctypes

import torch

from . import cuda_build


def unpack_bits(packed):
    """(R, nbytes) uint8 -> (R, nbytes * 8) uint8 of {0, 1}, column 8 b + s
    being bit s of byte b."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)


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


# ----------------------------------------------------------------- launchers

_LIB = None


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
        lib.bit_rows_launch.argtypes = [p, ll, i, p, i, p, ll, i, p, p]
        lib.bit_rows_launch.restype = i
        lib.bit_cols_launch.argtypes = [p, ll, i, p, i, p, i, p, p]
        lib.bit_cols_launch.restype = i
        max_d, d_multiple, multiple = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.bit_kernels_limits(ctypes.byref(max_d), ctypes.byref(d_multiple),
                               ctypes.byref(multiple))
        lib.limits = {"max_d": max_d.value, "d_multiple": d_multiple.value,
                      "nbytes_multiple": multiple.value}
        _LIB = lib
    return _LIB


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


def bit_rows_matmul_cuda(bits, rows, v):
    """Launch ``bit_rows_kernel``; same contract as ``bit_rows_matmul_torch``.
    Counts its launches in ``bit_rows_matmul_cuda.launches``."""
    name = "bit_rows_matmul_cuda"
    n_major, nbytes, R, D = _check(name, bits, rows, v)
    if v.shape[0] > nbytes * 8:
        raise ValueError(f"{name}: v has {v.shape[0]} rows, the bits {nbytes * 8} columns")
    out = torch.empty((R, D), dtype=torch.float32, device=v.device)
    if R == 0:
        return out
    err = _lib().bit_rows_launch(bits.data_ptr(), n_major, nbytes, rows.data_ptr(), R,
                                 v.data_ptr(), v.shape[0], D, out.data_ptr(),
                                 torch.cuda.current_stream(v.device).cuda_stream)
    if err:
        raise RuntimeError(f"bit_rows kernel launch failed: CUDA error {err}")
    bit_rows_matmul_cuda.launches += 1
    return out


bit_rows_matmul_cuda.launches = 0


def bit_cols_matmul_cuda(bits, rows, g):
    """Launch ``bit_cols_kernel``; same contract as ``bit_cols_matmul_torch``.
    Counts its launches in ``bit_cols_matmul_cuda.launches``."""
    name = "bit_cols_matmul_cuda"
    n_major, nbytes, R, D = _check(name, bits, rows, g)
    if g.shape[0] != R:
        raise ValueError(f"{name}: g has {g.shape[0]} rows for {R} picked rows")
    out = torch.empty((nbytes * 8, D), dtype=torch.float32, device=g.device)
    err = _lib().bit_cols_launch(bits.data_ptr(), n_major, nbytes, rows.data_ptr(), R,
                                 g.data_ptr(), D, out.data_ptr(),
                                 torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"bit_cols kernel launch failed: CUDA error {err} (shared memory "
                           f"{_lib().bit_cols_smem_bytes(D)} bytes at D={D})")
    bit_cols_matmul_cuda.launches += 1
    return out


bit_cols_matmul_cuda.launches = 0


# --------------------------------------------------------------- dispatchers

def bit_rows_matmul(bits, rows, v):
    """``B[rows] @ v`` -> (R, D) float32. The plain version for CPU tensors,
    the kernel otherwise."""
    if v.device.type == "cpu":
        return bit_rows_matmul_torch(bits, rows, v)
    return bit_rows_matmul_cuda(bits, rows, v)


def bit_cols_matmul(bits, rows, g):
    """``B[rows]^T @ g`` -> (nbytes * 8, D) float32. The plain version for
    CPU tensors, the kernel otherwise."""
    if g.device.type == "cpu":
        return bit_cols_matmul_torch(bits, rows, g)
    return bit_cols_matmul_cuda(bits, rows, g)
