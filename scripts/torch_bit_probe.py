"""Where the packed-bit kernels' time goes, on one CUDA card: clocks of
every warp of every block, read by ``clock64`` and ``%globaltimer`` in a
probed copy of the source.

    python scripts/torch_bit_probe.py [TREE] [--kernel cols|rows]

TREE (default: the checkout this script lies in) is a checkout whose
``recbole_tpu_torch/csrc/bit_kernels.cu`` holds the kernels the probe sets
below know: the column kernel of a cluster a strip (``--kernel cols``, the
default) and the row kernel's walk of a persistent grid (``--kernel
rows``). The script writes a copy of that source with the probes put in,
builds it with the port's nvcc flags into ``recbole_tpu_torch/_build/``, runs
``bit_cols_matmul_cuda`` or ``bit_rows_matmul_cuda`` through the tree's own
launcher at both Yelp sides as ``chip_smoke.time_bit_kernels`` draws them
(seed 7: 2,048 users into the user image, 4,096 items into the item image,
D 64; the row kernel with the images' counts), and prints, beside ptxas'
registers and the kernel's blocks an SM (the launcher's occupancy query),
for each side:

* the grid: blocks, the SMs they ran on, the most blocks an SM held at
  once, and the waves (an SM's blocks over that);
* each block's time from its first warp's start to its last warp's end
  (least, median, most, in clocks and microseconds), and the kernel's span;
  the median time of the blocks that started before any block ended (the
  first wave) and of those that started later;
* the slowest warp of the slowest block, the warp with the most set bits
  and the 5 slowest warps: set bits, groups (the column kernel: groups of
  32 rows with a set bit; the row kernel: rows and pieces walked), and
  clocks by phase (the column kernel: waiting for a tile, adding, the
  cluster's sum and the stores; the row kernel: waiting for the claims, for
  bits, numbering and queueing, the rounds of v, resolving the picks), and
  the rest;
* the same clocks summed over all warps, so the shares of the whole;
* the kernel's time by CUDA events, probed and as built.

``--cluster C`` runs the column kernel with clusters of C blocks in place
of those ``bit_cols_plan`` picks. ``--variants`` also builds copies of the
kernel with one part taken out or changed and prints their CUDA-graph times
beside the kernel's, in turns: for the column kernel no-adds, no-g, stream,
stream-no-out, warp-cols-32 (what each part costs; wrong results); for the
row kernel split-64, split-256, pieces-64, ring-2, no-hints (other split
sizes, a shorter ring, no L2 priorities; right results), no-rounds and
stream-only (what the rounds of v, and the queueing, cost; wrong results).
``--widths`` also times a kernel that only streams the picked rows' bytes,
a block a strip of 32, 64 or 128 bytes: what reading them costs at all.

A probe reads the clock once the values it waits for are in registers, so
"waiting for g" is from issuing a batch of loads to the last one landing;
clock reads beside a barrier may be moved by the compiler, so time at the
barriers can show as "the rest". Exits non-zero without a card.
"""

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np

# a record a warp: start ns, end ns, clocks, the probe set's five phases,
# set bits, groups, SM, 1
FIELDS = 12
MAX_WARPS = 32

HEADER = (
    "__device__ unsigned long long* g_probe;\n"
    "#define PCLK(v) asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(v) :: \"memory\")\n"
    "#define PGT(v) asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v) :: \"memory\")\n"
    # force the wait for a value, then read the clock
    "#define PSINK(x) do { if ((x) == 1234.5f) g_probe[0] = 7; } while (0)\n")

# written at the end of a kernel by lane 0 of each warp
RECORD = (
    "  {\n"
    "    unsigned long long pt1, pg1;\n"
    "    PCLK(pt1);\n    PGT(pg1);\n"
    "    for (int o = 16; o; o >>= 1) pbits += __shfl_xor_sync(0xffffffffu, pbits, o);\n"
    "    unsigned smid;\n"
    "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
    "    if ((threadIdx.x & 31) == 0) {\n"
    f"      unsigned long long* q = g_probe + ((size_t)blockIdx.x * {MAX_WARPS} + "
    f"(threadIdx.x >> 5)) * {FIELDS};\n"
    "      q[0] = pg0; q[1] = pg1; q[2] = pt1 - pt0;\n"
    "      q[3] = p0; q[4] = p1; q[5] = p2; q[6] = p3; q[7] = p4;\n"
    "      q[8] = pbits; q[9] = pgroups; q[10] = smid; q[11] = 1;\n"
    "    }\n"
    "  }\n")

START = ("  unsigned long long pt0, pg0, p0 = 0, p1 = 0, p2 = 0, p3 = 0, p4 = 0, pc_a, pc_b;\n"
         "  unsigned pbits = 0, pgroups = 0;\n"
         "  PCLK(pt0);\n  PGT(pg0);\n")

# the split kernel: a cluster of C blocks a strip, a block a slice of the
# rows, bits and g staged by cp.async, a warp 16 columns of the strip
SPLIT = [
    ("constexpr unsigned kFull = 0xffffffffu;\n",
     HEADER + "constexpr unsigned kFull = 0xffffffffu;\n", 1),
    ("  const int tiles = (hi - lo + kTileRows - 1) / kTileRows;\n",
     "  const int tiles = (hi - lo + kTileRows - 1) / kTileRows;\n" + START, 1),
    ("      cp_async_wait<1>();  // g of tile i and bits of tile i + 1 have landed\n",
     "      PCLK(pc_a);\n      cp_async_wait<1>();  // g of tile i and bits of tile i + 1 have "
     "landed\n", 1),
    ("      __syncthreads();     // for every thread; and tile i - 1 has been read\n",
     "      __syncthreads();     // for every thread; and tile i - 1 has been read\n"
     "      PCLK(pc_b);\n      p0 += pc_b - pc_a;\n", 1),
    ("    if (i >= 0) {\n", "    PCLK(pc_a);\n    if (i >= 0) {\n", 1),
    ("        unsigned m = __ballot_sync(kFull, cols != 0u);\n",
     "        unsigned m = __ballot_sync(kFull, cols != 0u);\n"
     "        pbits += __popc(cols);\n        pgroups += m != 0u;\n", 1),
    ("          } while (set);\n        }\n      }\n    }\n  }\n  if (bad) any_bad = 1;\n",
     "          } while (set);\n        }\n      }\n    }\n    PCLK(pc_b);\n"
     "    p1 += pc_b - pc_a;\n  }\n  if (bad) any_bad = 1;\n  PCLK(pc_a);\n", 1),
    ("  cluster.sync();  // no block leaves while another reads its sums\n}\n",
     "  cluster.sync();  // no block leaves while another reads its sums\n"
     "  PCLK(pc_b);\n  p2 += pc_b - pc_a;\n" + RECORD + "}\n", 1),
]

# the row kernel's walk (bit_rows_kernel): a persistent grid of independent
# warps, each resolving its picks, walking split pieces and unsplit rows,
# and filling its copies. Phases: p0 waiting for the claims (griddep_wait),
# p1 waiting for a super-chunk's bytes, p2 numbering and queueing (the walks
# less p1 and p3), p3 the rounds of v (loads and adds), p4 resolving the
# picks; the rest (waiting for slots and walkers, the partial sums, the
# ticket, the stores) is "other". Set bits: those queued; groups: walks
_WALK_ARGS = ", p1, pn, p3, pbits);\n"
ROWS_WALK = [
    ("constexpr unsigned kFull = 0xffffffffu;\n",
     HEADER + "constexpr unsigned kFull = 0xffffffffu;\n", 1),
    ("                                         int np, WarpSmem& ws, int lane, "
     "float2 (&acc)[P]) {\n",
     "                                         int np, WarpSmem& ws, int lane, float2 (&acc)[P],\n"
     "                                         unsigned long long& pw, unsigned long long& pn,\n"
     "                                         unsigned long long& pr, unsigned& pbits) {\n"
     "  unsigned long long pc_a, pc_b, pc_w0;\n  PCLK(pc_w0);\n", 1),
    ("    cp_async_wait<kStages - 1>();\n",
     "    PCLK(pc_a);\n    cp_async_wait<kStages - 1>();\n    PCLK(pc_b);\n"
     "    pw += pc_b - pc_a;\n", 1),
    ("      q += take;\n      a += take;\n",
     "      pbits += lane == 0 ? take : 0;\n      q += take;\n      a += take;\n", 1),
    ("      for (int i = 0; i < full; i += 32)\n        add_queued<P, VEC>(",
     "      PCLK(pc_a);\n      for (int i = 0; i < full; i += 32)\n        add_queued<P, VEC>(", 1),
    ("                           piece);\n",
     "                           piece);\n      PCLK(pc_b);\n      pr += pc_b - pc_a;\n", 1),
    ("  cp_async_wait<0>();  // the copies in flight land before the ring is reused\n}\n",
     "  cp_async_wait<0>();  // the copies in flight land before the ring is reused\n"
     "  PCLK(pc_b);\n  pn += pc_b - pc_w0;\n}\n", 1),
    ("  griddep_wait();  // the claims\n  const RowsScratch p = rows_scratch(scratch, R);\n",
     START + "  unsigned long long pn = 0;\n  griddep_wait();  // the claims\n"
     "  const RowsScratch p = rows_scratch(scratch, R);\n  PCLK(pc_b);\n  p0 = pc_b - pt0;\n", 1),
    ("  // 2. this warp's slots,",
     "  PCLK(pc_a);\n  p4 = pc_a - pc_b;\n  // 2. this warp's slots,", 1),
    ("                     n_v, np, ws, lane, acc);\n",
     "                     n_v, np, ws, lane, acc" + _WALK_ARGS + "    ++pgroups;\n", 1),
    ("  // the last block to finish advances the epoch\n",
     "  p2 = pn - p1 - p3;\n" + RECORD + "  // the last block to finish advances the epoch\n", 1),
]

# copies of the kernels with one part taken out or changed, timed beside
# them (the column kernel's copies give wrong results: timings only)
_NO_ADDS = ("    if (i >= 0) {\n", "    if (i >= 0 && i < -9) {\n")
_NO_G = ("      if (any) {  // row gr holds a set bit in the strip\n",
         "      if (any && i < -9) {\n")
_NO_ROUNDS = ("  for (int h = 0; h < n; h += kRows) {\n",
              "  for (int h = 0; h < n && n < 0; h += kRows) {\n")
VARIANTS = {
    "no-adds": [_NO_ADDS],
    "no-g": [_NO_G],
    # the bits staged and the sums written, nothing else: the stream alone
    "stream": [_NO_ADDS, _NO_G],
    "stream-no-out": [_NO_ADDS, _NO_G,
                      ("      dst4[e] = bad_any ? make_float4(fill, fill, fill, fill) : sum;\n",
                       "      if (sum.x == 1234.5f) dst4[e] = sum;\n")],
    # a warp a whole 4-byte word (8 warps) in place of half a word (16 warps)
    "warp-cols-32": [("constexpr int kWarpCols = 16;", "constexpr int kWarpCols = 32;")],
    # the row kernel cut at 64 or 256 set bits a piece in place of 128, or
    # into at most 64 pieces in place of 128 (right results, other balance);
    # with a shorter ring; without its L2 priorities; without the rounds of
    # v; without them or the queueing (the stream and the numbering alone)
    "split-64": [("constexpr int kSplitBits = 128;", "constexpr int kSplitBits = 64;")],
    "split-256": [("constexpr int kSplitBits = 128;", "constexpr int kSplitBits = 256;")],
    "pieces-64": [("constexpr int kMaxPieces = 128;", "constexpr int kMaxPieces = 64;")],
    # no L2 eviction priorities (bits evict first, rows of v evict last)
    "no-hints": [("L2::evict_first.b64", "L2::evict_normal.b64"),
                 ("L2::evict_last.b64", "L2::evict_normal.b64")],
    # a ring of 2 super-chunks a warp in place of 4 (one in flight, not 3)
    "ring-2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "no-rounds": [_NO_ROUNDS],
    "stream-only": [_NO_ROUNDS,
                    ("      if (take && cnt > 0 && g0 < a + take && g0 + cnt > a)\n",
                     "      if (take && cnt > 0 && g0 < a + take && g0 + cnt > a && s < -9)\n")],
}

# name: (anchors, what fields 3, 4 and 5 of a record count)
# name: (the kernel it probes, anchors, what fields 3-7 of a record count)
PROBE_SETS = {
    "the split bit_cols_kernel": (
        "cols", SPLIT, ("wait for the tile", "adds", "cluster sum and stores")),
    "the row kernel's walk": (
        "rows", ROWS_WALK, ("wait for the claims", "wait for bits", "number and queue",
                            "rounds of v", "resolve the picks")),
}

# --widths: a kernel that only streams the picked rows' bytes, a block a strip
# of S (32, 64 or 128) bytes (S / 16 threads a row, 16 bytes each, 4 tiles of 64 rows in
# flight by cp.async) and sums them, one int a block: what the card reads at
# each strip width, whatever is done with the bytes
STREAM_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int S>
__global__ void __launch_bounds__(S / 16 * 64) stream_kernel(const uint8_t* bits, int nbytes,
                                                             const int64_t* rows, int R, int* out) {
  constexpr int kThreads = S / 16 * 64, kStages = 5;
  __shared__ __align__(16) uint4 ring[kStages][kThreads];
  const int r0 = threadIdx.x / (S / 16), part = threadIdx.x % (S / 16);
  const uint8_t* base = bits + (long long)blockIdx.x * S + 16 * part;
  const int tiles = (R + 63) / 64;
  unsigned acc = 0;
  for (int i = -(kStages - 1); i < tiles; ++i) {
    const int t = i + kStages - 1;
    if (t < tiles) {
      const int r = t * 64 + r0;
      const unsigned dst = (unsigned)__cvta_generic_to_shared(&ring[t % kStages][threadIdx.x]);
      const uint8_t* src = r < R ? base + rows[r] * nbytes : base;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                   "r"(r < R ? 16 : 0) : "memory");
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    if (i >= 0) {
      const uint4 v = ring[i % kStages][threadIdx.x];
      acc += v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x12345u) out[blockIdx.x] = acc;
}
extern "C" int stream_launch(int S, const void* bits, int nbytes, const void* rows, int R,
                             int* out, void* stream) {
  const int blocks = nbytes / S;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* b = (const uint8_t*)bits;
  const int64_t* r = (const int64_t*)rows;
  if (S == 32) stream_kernel<32><<<blocks, 128, 0, s>>>(b, nbytes, r, R, out);
  else if (S == 64) stream_kernel<64><<<blocks, 256, 0, s>>>(b, nbytes, r, R, out);
  else if (S == 128) stream_kernel<128><<<blocks, 512, 0, s>>>(b, nbytes, r, R, out);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""


def stream_widths(torch, tools, images, cuda_build):
    """Graph ms of streaming each Yelp side's picked rows at strip widths
    32-128 bytes, beside the bytes over the card's rate."""
    cu = os.path.join(cuda_build.BUILD_DIR, "bit_stream.cu")
    so = os.path.join(cuda_build.BUILD_DIR, "libbit_stream.so")
    with open(cu, "w") as fh:
        fh.write(STREAM_SRC)
    built = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
                           capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"torch_bit_probe: nvcc failed for {cu}:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stream_launch.argtypes = [i, p, i, p, i, p, p]
    for side in ("user", "item"):
        bits, rows = images[side][:2]
        out = torch.zeros(bits.shape[1], dtype=torch.int32, device="cuda")
        ms = {}
        for S in (32, 64, 128):
            def call(S=S):
                err = lib.stream_launch(S, bits.data_ptr(), bits.shape[1], rows.data_ptr(),
                                        rows.numel(), out.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"stream kernel launch failed: CUDA error {err}")
            ms[S] = round(tools.graph_ms(torch, call), 4)
        nb = int(torch.unique(rows).numel()) * bits.shape[1]
        tools.log(f"[bit-probe] {side} side, streaming the picked rows ({nb} bytes; "
                  f"{nb / 3.35e9:.4f} ms at 3.35 TB/s), graph ms by strip bytes: {ms}")


READ = ('\nextern "C" int bit_probe_set(void* p) {\n'
        "  return (int)cudaMemcpyToSymbol(g_probe, &p, sizeof(p));\n}\n")


def probe_set(source, kernel):
    """The name of the first probe set of ``kernel`` whose anchors ``source``
    holds."""
    for name, (of, pairs, _) in PROBE_SETS.items():
        if of == kernel and all(source.count(anchor) == n for anchor, _, n in pairs):
            return name
    raise SystemExit(f"torch_bit_probe: bit_kernels.cu matches no probe set of the {kernel} "
                     "kernel; its anchors have moved")


def stamped(source, pairs, out_dir, tag, cuda_build):
    """Build ``source`` with each (anchor, replacement, count) applied (and,
    with the probes, the function that points them at a buffer); returns the
    .so."""
    for anchor, new, n in pairs:
        if source.count(anchor) != n:
            raise SystemExit(f"torch_bit_probe: anchor not found {n} times:\n{anchor}")
        source = source.replace(anchor, new)
    cu = os.path.join(out_dir, f"bit_kernels_{tag}.cu")
    so = os.path.join(out_dir, f"libbit_kernels_{tag}.so")
    with open(cu, "w") as fh:
        fh.write(source + (READ if "g_probe" in source else ""))
    built = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
                           capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"torch_bit_probe: nvcc failed for {cu}:\n{built.stdout}{built.stderr}")
    return so


def use(bk, cuda_build, so):
    """Point the port's launchers at the library ``so``."""
    load = cuda_build.load
    cuda_build.load = lambda name: ctypes.CDLL(so)
    bk._LIB = None
    lib = bk._lib()
    cuda_build.load = load
    return lib


def summarize(log, side, rec, clock_ghz, names):
    """Print the grid, the blocks' times and the slowest warps of one run."""
    phase = range(3, 3 + len(names))
    warps = rec[:, :, 11] == 1
    blocks = np.flatnonzero(warps.any(axis=1))
    rec = rec[blocks]
    warps = warps[blocks]
    start = np.where(warps, rec[:, :, 0], np.iinfo(np.int64).max).min(axis=1)
    end = np.where(warps, rec[:, :, 1], 0).max(axis=1)
    clocks = np.where(warps, rec[:, :, 2], 0)
    smid = rec[:, 0, 10]
    held, waves = 0, 0
    for sm in np.unique(smid):
        on = np.flatnonzero(smid == sm)
        at_once = max(int(((start[on] <= start[i]) & (end[on] > start[i])).sum()) for i in on)
        held = max(held, at_once)
        waves = max(waves, -(-len(on) // at_once))
    block_us = (end - start) / 1e3
    t0 = start.min()
    log(f"[bit-probe] {side}: grid {len(blocks)} blocks of {int(warps.sum(axis=1).max())} warps "
        f"on {len(np.unique(smid))} SMs, at most {held} an SM at once: {waves} wave(s); kernel "
        f"span {(end.max() - t0) / 1e3:.2f} us, the last block started at "
        f"{(start.max() - t0) / 1e3:.2f} us")
    bc = clocks.max(axis=1)
    q = np.percentile(bc, [0, 50, 100])
    log(f"[bit-probe] {side}: block clocks least {q[0]:.0f}, median {q[1]:.0f}, most {q[2]:.0f} "
        f"({q[2] / clock_ghz / 1e3:.2f} us at {clock_ghz:.2f} GHz); block us by the timer least "
        f"{block_us.min():.2f}, median {np.median(block_us):.2f}, most {block_us.max():.2f}")
    first = start < end.min()
    later = f"{np.median(block_us[~first]):.2f}" if (~first).any() else "none"
    log(f"[bit-probe] {side}: block us, median: the {int(first.sum())} blocks that started "
        f"before any ended {np.median(block_us[first]):.2f}, the {int((~first).sum())} later "
        f"{later}")

    def warp_line(label, b, w):
        r = rec[b, w]
        other = int(r[2] - sum(r[k] for k in phase))
        log(f"[bit-probe] {side}: {label}: block {int(blocks[b])} warp {w}: {int(r[2])} clocks; "
            f"set bits {int(r[8])}, groups {int(r[9])}; "
            + ", ".join(f"{n} {int(r[k])}" for n, k in zip(names, phase))
            + f", other {other}")

    b = int(np.argmax(bc))
    warp_line("slowest warp of the slowest block", b, int(np.argmax(clocks[b])))
    flat = int(np.argmax(clocks))
    warp_line("the warp with the most set bits",
              *np.unravel_index(int(np.argmax(np.where(warps, rec[:, :, 8], -1))), warps.shape))
    tot = {n: int(np.where(warps, rec[:, :, k], 0).sum()) for n, k in zip(names, phase)}
    all_clk = int(clocks.sum())
    log(f"[bit-probe] {side}: all warps: {all_clk} clocks, set bits "
        f"{int(np.where(warps, rec[:, :, 8], 0).sum())}; "
        + ", ".join(f"{n} {v} ({100 * v / all_clk:.1f}%)" for n, v in tot.items())
        + f"; slowest warp of all: block {int(blocks[flat // warps.shape[1]])}")
    order = np.argsort(np.where(warps, clocks, -1), axis=None)[::-1][:5]
    for b, w in zip(*np.unravel_index(order, warps.shape)):
        warp_line("one of the 5 slowest warps", int(b), int(w))


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--kernel", choices=("cols", "rows"), default="cols",
                    help="the column kernel (bit_cols_matmul) or the row kernel")
    ap.add_argument("--cluster", type=int, help="blocks a strip in place of bit_cols_plan's")
    ap.add_argument("--variants", default="", help=f"some of {','.join(VARIANTS)}")
    ap.add_argument("--widths", action="store_true",
                    help="also time a kernel that only streams the rows, by strip width")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_bit_probe: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("smoke_tools",
                                                  os.path.join(here, "chip_smoke.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    from recbole_tpu_torch.ops import bit_kernels as bk
    from recbole_tpu_torch.ops import cuda_build
    if args.cluster:
        plan = bk.bit_cols_plan
        bk.bit_cols_plan = lambda *a: {**plan(*a), "cluster": args.cluster}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    tools.log(f"[bit-probe] tree {tree}; {smi}")
    clock_ghz = float(smi.split(",")[-1].split()[0]) / 1e3
    with open(os.path.join(cuda_build.CSRC_DIR, "bit_kernels.cu")) as fh:
        source = fh.read()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    logs = cuda_build.build(["bit_kernels"])
    for line in logs["bit_kernels"].splitlines():
        tools.log(f"[bit-probe] ptxas: {line.strip()}")
    name = probe_set(source, args.kernel)
    _, pairs, names = PROBE_SETS[name]
    so = stamped(source, pairs, cuda_build.BUILD_DIR, "probe", cuda_build)
    tools.log(f"[bit-probe] probe set: {name}")
    occupancy = bk.rows_occupancy if args.kernel == "rows" else bk.cols_occupancy
    tools.log(f"[bit-probe] the kernel as built at D 64: (SMs, blocks an SM"
              f"{'' if args.kernel == 'rows' else ', largest cluster'}) "
              f"{occupancy(torch.device('cuda', 0), 64)} (the launcher's query)")
    variants = {v: stamped(source, [(a, b, 1) for a, b in VARIANTS[v]], cuda_build.BUILD_DIR, v,
                           cuda_build) for v in args.variants.split(",") if v}
    images = tools.yelp_bit_inputs(torch, seed=7)
    if args.widths:
        stream_widths(torch, tools, images, cuda_build)
    rng = np.random.RandomState(23)
    kernel = getattr(bk, f"bit_{args.kernel}_matmul_cuda")
    for side in ("user", "item"):
        bits, rows, n_cols, counts = images[side]
        R, nbytes = rows.numel(), bits.shape[1]
        if args.kernel == "cols":
            x = torch.from_numpy(rng.randn(R, 64).astype(np.float32) * 1e-3).cuda().bfloat16()
            extra = ()
        else:
            x = torch.from_numpy(rng.randn(n_cols, 64).astype(np.float32) * 0.1).cuda().bfloat16()
            extra = (counts,)
        use(bk, cuda_build, cuda_build.library_path("bit_kernels"))
        built_ms = tools.cuda_ms(torch, lambda: kernel(bits, rows, x, *extra), 50)
        want = kernel(bits, rows, x, *extra)
        lib = use(bk, cuda_build, so)
        lib.bit_probe_set.argtypes = [ctypes.c_void_p]
        buf = torch.zeros((8192, MAX_WARPS, FIELDS), dtype=torch.int64, device="cuda")
        err = lib.bit_probe_set(buf.data_ptr())
        if err:
            raise RuntimeError(f"torch_bit_probe: setting the probe buffer failed: CUDA error "
                               f"{err}")
        probed_ms = tools.cuda_ms(torch, lambda: kernel(bits, rows, x, *extra), 50)
        buf.zero_()
        got = kernel(bits, rows, x, *extra)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("torch_bit_probe: the probed kernel's result differs")
        tools.log(f"[bit-probe] {side} side R={R} nbytes={nbytes} D=64: events {built_ms:.4f} ms "
                  f"as built, {probed_ms:.4f} ms probed")
        summarize(tools.log, side, buf.cpu().numpy(), clock_ghz, names)
        del buf
        if variants:
            order = ["as built", *variants, "as built"]
            ms = []
            for tag in order:
                use(bk, cuda_build, variants.get(tag, cuda_build.library_path("bit_kernels")))
                ms.append(round(tools.graph_ms(torch, lambda: kernel(bits, rows, x, *extra)), 4))
            tools.log(f"[bit-probe] {side} side, graph ms of copies with a part taken out: "
                      + ", ".join(f"{t} {m}" for t, m in zip(order, ms)))


if __name__ == "__main__":
    main()
