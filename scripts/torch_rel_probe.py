"""Where the relation-apply kernels' time goes, on one CUDA card: clocks of
every warp of the forward kernel, read by ``clock64`` in a probed copy of the
source, and the kernels' times with a part taken out.

    python scripts/torch_rel_probe.py [TREE] [--variants no-mma,no-gather,...]

TREE (default: the checkout this script lies in) is a checkout whose
``recbole_tpu_torch/csrc/rel_apply.cu`` holds the forward kernel the probe
knows (``rel_fwd_kernel``, a persistent grid of warps that each gather 16
rows of every tile by cp.async and multiply them on the tensor cores). The
script writes copies of that source, builds them with the port's nvcc flags
into ``recbole_tpu_torch/_build/``, points the tree's own launchers at each
in turn, and runs them at RippleNet's step as ``chip_smoke.time_rel_apply``
draws it (seed 61: N 131,072, D 64, 53 relation ids). It prints:

* the probed forward and backward (fp32 and bf16 instances): the grid, the blocks' spans
  by ``%globaltimer`` (least, median, most) and the kernel's span; per warp
  the clocks by phase, summed over all warps and for the slowest warp:
  before the loop (the first tiles' perm rows and copies, the staging and
  packing of R[r]), waiting for a tile's rows, the products, and the rest
  (issuing the copies, the output stores); the backward's: before the loop,
  waiting for a tile's rows (with the block's barrier), dv's product, dR's,
  the barrier before the dv rows are written, and the rest;
* each variant's device time a kernel (torch.profiler) for the forward and
  the backward, both instances, beside the unchanged source's, in turns:
  ``no-mma`` (the products taken out), ``no-gather`` (no row copies: the
  products run on what the buffers hold), ``no-store`` (no output rows
  written), all with wrong results, and ``stages-3``, ``stages-4`` (the
  forward's ring);
* the count kernel's phases in the probed copy (``%globaltimer``): its
  blocks' counting, the last ticket, and the last block's two scans and
  its tile and block tables.

Exits non-zero without a card.
"""

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np

FIELDS = 10  # start ns, end ns, clocks, 3 phases, 2 unused, tiles, 1
MAX_WARPS = 4
MAX_BLOCKS = 4096
# the count kernel's records: 4 a block (start, counted, ticket, 1), then the
# last block's (ticket, first scan, second scan, tile table, its index)
COUNT_AT = MAX_BLOCKS * MAX_WARPS * FIELDS
LAST_AT = COUNT_AT + 4 * MAX_BLOCKS
# the backward kernel's records: 8 warps a block
BWD_AT = LAST_AT + 8
BWD_PHASES = ("before the loop", "waiting for rows (and the barrier)", "dv", "dR",
              "the dv rows' barrier")

HEADER = (
    "__device__ unsigned long long* g_probe;\n"
    "#define PCLK(v) asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(v) :: \"memory\")\n"
    "#define PGT(v) asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v) :: \"memory\")\n"
    "#define PSINK(x) do { if ((x) == 1234.5f) g_probe[0] = 7; } while (0)\n")

READ = ('\nextern "C" int rel_probe_set(void* p) {\n'
        "  return (int)cudaMemcpyToSymbol(g_probe, &p, sizeof(p));\n}\n")

PHASES = ("before the loop", "waiting for rows", "products")

PROBE = [
    ("namespace {\n\nconstexpr int kChunk", HEADER + "namespace {\n\nconstexpr int kChunk", 1),
    # the count kernel: each block's start, end of counting, ticket; the last
    # block's scans and tile table (%globaltimer)
    ("  __shared__ int last;\n  const int NB = NR + 1, warp = threadIdx.x >> 5, "
     "lane = threadIdx.x & 31;\n",
     "  __shared__ int last;\n  const int NB = NR + 1, warp = threadIdx.x >> 5, "
     "lane = threadIdx.x & 31;\n  unsigned long long q0, q1, q2, q3, q4, q5;\n  PGT(q0);\n", 1),
    ("  __threadfence();\n  __syncthreads();\n  if (threadIdx.x == 0) last = atomicAdd(",
     "  PGT(q1);\n  __threadfence();\n  __syncthreads();\n  if (threadIdx.x == 0) last = "
     "atomicAdd(", 1),
    ("  if (!last) return;\n  __threadfence();\n",
     "  PGT(q2);\n  if (threadIdx.x == 0) {\n"
     f"    unsigned long long* w = g_probe + {COUNT_AT} + blockIdx.x * 4;\n"
     "    w[0] = q0; w[1] = q1; w[2] = q2; w[3] = 1;\n  }\n"
     "  if (!last) return;\n  __threadfence();\n", 1),
    ("  // 2. the tiles (T in all)", "  PGT(q3);\n  // 2. the tiles (T in all)", 1),
    ("  block_scan(s2, tmp, T);\n", "  block_scan(s2, tmp, T);\n  PGT(q4);\n", 1),
    ("  if (tid == 0) *ticket = 0;\n}\n",
     "  PGT(q5);\n  if (tid == 0) {\n"
     f"    unsigned long long* w = g_probe + {LAST_AT};\n"
     "    w[0] = q2; w[1] = q3; w[2] = q4; w[3] = q5; w[4] = blockIdx.x;\n  }\n"
     "  if (tid == 0) *ticket = 0;\n}\n", 1),
    # the forward kernel
    ("  zero_pad(ring, NS * RW, D, S, lane, 32);\n",
     "  unsigned long long pt0, pg0, pa, pb, ph[3] = {0, 0, 0};\n  unsigned ptiles = 0;\n"
     "  PCLK(pt0);\n  PGT(pg0);\n  zero_pad(ring, NS * RW, D, S, lane, 32);\n", 1),
    ("  if (late) pack();\n  for (int t = 0; t < nt; ++t) {\n",
     "  if (late) pack();\n  PCLK(pa);\n  ph[0] = pa - pt0;\n  for (int t = 0; t < nt; ++t) {\n", 1),
    ("    cp_wait<NS - 1>();\n    __syncwarp();\n",
     "    PCLK(pa);\n    cp_wait<NS - 1>();\n    __syncwarp();\n    PCLK(pb);\n"
     "    ph[1] += pb - pa;\n    ++ptiles;\n", 1),
    ("    if (rows > 0) {\n      float acc[NT][4];\n",
     "    PCLK(pa);\n    if (rows > 0) {\n      float acc[NT][4];\n", 1),
    ("      // the output rows through the stage",
     "      PSINK(acc[0][0] + acc[NT - 1][3]);\n      PCLK(pb);\n      ph[2] += pb - pa;\n"
     "      // the output rows through the stage", 1),
    ("    __syncwarp();\n  }\n  cp_wait<0>();\n}\n",
     "    __syncwarp();\n  }\n  cp_wait<0>();\n"
     "  {\n    unsigned long long pt1, pg1;\n    PCLK(pt1);\n    PGT(pg1);\n"
     "    if (lane == 0) {\n"
     f"      unsigned long long* w = g_probe + ((size_t)blockIdx.x * {MAX_WARPS} + warp) * "
     f"{FIELDS};\n"
     "      w[0] = pg0; w[1] = pg1; w[2] = pt1 - pt0;\n"
     "      w[3] = ph[0]; w[4] = ph[1]; w[5] = ph[2]; w[6] = 0; w[7] = 0;\n"
     "      w[8] = ptiles; w[9] = 1;\n    }\n  }\n}\n", 1),
    # the backward kernel: a record a warp after the forward's
    ("  zero_pad(ring, NS * 2 * kTR, D, S, tid, blockDim.x);\n",
     "  unsigned long long qt0, qg0, qa, qb, qh[5] = {0, 0, 0, 0, 0};\n  unsigned qtiles = 0;\n"
     "  PCLK(qt0);\n  PGT(qg0);\n  zero_pad(ring, NS * 2 * kTR, D, S, tid, blockDim.x);\n", 1),
    ("  float sum[C::NDR][4] = {};\n  for (int t = 0; t < nt; ++t) {\n    cp_wait<NS - 2>();\n"
     "    __syncthreads();  // tile t has landed; every thread is done with tile t - 1\n",
     "  float sum[C::NDR][4] = {};\n  PCLK(qa);\n  qh[0] = qa - qt0;\n"
     "  for (int t = 0; t < nt; ++t) {\n    PCLK(qa);\n    cp_wait<NS - 2>();\n"
     "    __syncthreads();  // tile t has landed; every thread is done with tile t - 1\n"
     "    PCLK(qb);\n    qh[1] += qb - qa;\n    ++qtiles;\n", 1),
    ("    if (mv * 16 < cnt && nv > 0) {\n",
     "    PCLK(qa);\n    if (mv * 16 < cnt && nv > 0) {\n", 1),
    ("    // dR += dy^T v over the tile: A(m = i, k = row) = dy[row][i],\n",
     "    PCLK(qb);\n    qh[2] += qb - qa;\n    qa = qb;\n"
     "    // dR += dy^T v over the tile: A(m = i, k = row) = dy[row][i],\n", 1),
    ("    __syncthreads();  // the tile's dv rows are in their buffer\n",
     "    PSINK(sum[0][0] + sum[C::NDR - 1][3]);\n    PCLK(qb);\n    qh[3] += qb - qa;\n"
     "    __syncthreads();  // the tile's dv rows are in their buffer\n    PCLK(qa);\n"
     "    qh[4] += qa - qb;\n", 1),
    ("  if (r != NR) {  // the block's partial of dR[r]\n",
     "  {\n    unsigned long long qt1, qg1;\n    PCLK(qt1);\n    PGT(qg1);\n"
     "    if (lane == 0) {\n"
     f"      unsigned long long* w = g_probe + {BWD_AT} + ((size_t)blockIdx.x * 8 + warp) * "
     f"{FIELDS};\n"
     "      w[0] = qg0; w[1] = qg1; w[2] = qt1 - qt0;\n"
     "      w[3] = qh[0]; w[4] = qh[1]; w[5] = qh[2]; w[6] = qh[3]; w[7] = qh[4];\n"
     "      w[8] = qtiles; w[9] = 1;\n    }\n  }\n"
     "  if (r != NR) {  // the block's partial of dR[r]\n", 1),
]

# (anchor, replacement, times): parts taken out or changed, wrong results
# except the stages
VARIANTS = {
    "no-mma": [("      if (j < n) mma1688(", "      if (j < -1) mma1688(", 3),
               ("      if (j < n) mma16816(", "      if (j < -1) mma16816(", 1)],
    "no-gather": [
        ("          cp16(dst + at(S, ck.row[i], ck.col[i]), v + (size_t)p[i] * D + ck.col[i], 16);",
         "          {}", 1),
        ("          cp16(dyb + at(S, ck.row[i], ck.col[i]), dy + off, bytes);\n"
         "          cp16(vb + at(S, ck.row[i], ck.col[i]), v + off, bytes);\n", "", 1)],
    "no-store": [
        ("        if (ck.row[i] < rows)\n"
         "          *reinterpret_cast<float4*>(y + (size_t)m[ck.row[i]] * D + ck.col[i]) =\n"
         "              *reinterpret_cast",
         "        if (ck.row[i] < -1)\n"
         "          *reinterpret_cast<float4*>(y + (size_t)m[ck.row[i]] * D + ck.col[i]) =\n"
         "              *reinterpret_cast", 1),
        ("      if (ck.row[i] < cnt)\n"
         "        *reinterpret_cast<float4*>(dv + (size_t)m[ck.row[i]] * D + ck.col[i]) =\n"
         "            *reinterpret_cast",
         "      if (ck.row[i] < -1)\n"
         "        *reinterpret_cast<float4*>(dv + (size_t)m[ck.row[i]] * D + ck.col[i]) =\n"
         "            *reinterpret_cast", 1)],
    "stages-3": [("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;", 1)],
    "stages-4": [("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 4;", 1)],
}


def stamped(source, pairs, out_dir, tag, cuda_build):
    """Start an nvcc of ``source`` with each (anchor, replacement, count)
    applied (and, with the probes, the function that points them at a
    buffer); returns (process, .so)."""
    for anchor, new, n in pairs:
        if source.count(anchor) != n:
            raise SystemExit(f"torch_rel_probe: anchor not found {n} times:\n{anchor}")
        source = source.replace(anchor, new)
    cu = os.path.join(out_dir, f"rel_apply_{tag}.cu")
    so = os.path.join(out_dir, f"librel_apply_{tag}.so")
    with open(cu, "w") as fh:
        fh.write(source + (READ if "g_probe" in source else ""))
    proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def use(ra, cuda_build, so):
    """Point the port's launchers at the library ``so``."""
    load = cuda_build.load
    cuda_build.load = lambda name: ctypes.CDLL(so)
    ra._LIB = None
    ra._PARTIALS.clear()
    lib = ra._lib()
    cuda_build.load = load
    return lib


def device_ms(tools, torch, call, names):
    """The device ms a call of each kernel in ``names`` (torch.profiler)."""
    k = tools.kernels_per_call(torch, call)
    return {n: round(k[n][1], 5) for n in names if n in k}


def summarize(log, label, rec, clock_ghz, phases=PHASES):
    warps = rec[:, :, 9] == 1
    blocks = np.flatnonzero(warps.any(axis=1))
    rec, warps = rec[blocks], warps[blocks]
    start = np.where(warps, rec[:, :, 0], np.iinfo(np.int64).max).min(axis=1)
    end = np.where(warps, rec[:, :, 1], 0).max(axis=1)
    us = (end - start) / 1e3
    log(f"[rel-probe] {label}: {len(blocks)} blocks; kernel span "
        f"{(end.max() - start.min()) / 1e3:.2f} us; block us least {us.min():.2f}, median "
        f"{np.median(us):.2f}, most {us.max():.2f}; the last block started at "
        f"{(start.max() - start.min()) / 1e3:.2f} us; tiles a warp "
        f"{int(rec[:, :, 8][warps].min())}-{int(rec[:, :, 8][warps].max())}")
    clocks = np.where(warps, rec[:, :, 2], 0)
    tot = clocks.sum()
    parts = {n: int(np.where(warps, rec[:, :, 3 + k], 0).sum()) for k, n in enumerate(phases)}
    log(f"[rel-probe] {label}: all warps {int(tot)} clocks: "
        + ", ".join(f"{n} {100 * v / tot:.1f}%" for n, v in parts.items())
        + f", the rest {100 * (tot - sum(parts.values())) / tot:.1f}%")
    b, w = np.unravel_index(int(np.argmax(clocks)), clocks.shape)
    r = rec[b, w]
    log(f"[rel-probe] {label}: slowest warp (block {int(blocks[b])} warp {w}): {int(r[2])} "
        f"clocks ({r[2] / clock_ghz / 1e3:.2f} us), {int(r[8])} tiles; "
        + ", ".join(f"{n} {int(r[3 + k])}" for k, n in enumerate(phases)))


def count_summary(log, host):
    blk = host[COUNT_AT:LAST_AT].reshape(MAX_BLOCKS, 4)
    blk = blk[blk[:, 3] == 1]
    q2, q3, q4, q5, last = host[LAST_AT:LAST_AT + 5]
    t0 = blk[:, 0].min()
    log(f"[rel-probe] count kernel: {len(blk)} blocks; starts spread "
        f"{(blk[:, 0].max() - t0) / 1e3:.2f} us; counting us median "
        f"{np.median(blk[:, 1] - blk[:, 0]) / 1e3:.2f}, most {(blk[:, 1] - blk[:, 0]).max() / 1e3:.2f}; "
        f"the last ticket at {(blk[:, 2].max() - t0) / 1e3:.2f} us; the last block {int(last)}: "
        f"offsets scan {(q3 - q2) / 1e3:.2f} us, tiles scan {(q4 - q3) / 1e3:.2f} us, tile table "
        f"{(q5 - q4) / 1e3:.2f} us; kernel end at {(q5 - t0) / 1e3:.2f} us")


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_rel_probe: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("smoke_tools",
                                                  os.path.join(here, "chip_smoke.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import rel_apply as ra
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    tools.log(f"[rel-probe] tree {tree}; {smi}")
    clock_ghz = float(smi.split(",")[-1].split()[0]) / 1e3
    with open(os.path.join(cuda_build.CSRC_DIR, "rel_apply.cu")) as fh:
        source = fh.read()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    variants = [v for v in args.variants.split(",") if v]
    builds = {"base": stamped(source, [], cuda_build.BUILD_DIR, "base", cuda_build),
              "probe": stamped(source, PROBE, cuda_build.BUILD_DIR, "probe", cuda_build)}
    for name in variants:
        builds[name] = stamped(source, VARIANTS[name], cuda_build.BUILD_DIR, name, cuda_build)
    libs = {}
    for name, (proc, so) in builds.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"torch_rel_probe: nvcc failed for {name}:\n{out}")
        libs[name] = so
    N = 2 * tools.RIPPLENET["B"] * tools.RIPPLENET["hops"] * tools.RIPPLENET["M"]
    D, NR = tools.RIPPLENET["D"], tools.ML1M_KG[2] + 2
    v, rel, R, dy = tools.rel_inputs(torch, N, D, NR, 61)
    names = ("rel_count_kernel", "rel_scatter_kernel", "rel_fwd_kernel", "rel_bwd_kernel",
             "rel_dr_reduce_kernel")
    # the probed forward
    lib = use(ra, cuda_build, libs["probe"])
    lib.rel_probe_set.argtypes = [ctypes.c_void_p]
    buf = torch.zeros(BWD_AT + MAX_BLOCKS * 8 * FIELDS, dtype=torch.int64, device="cuda")
    if lib.rel_probe_set(buf.data_ptr()):
        raise SystemExit("torch_rel_probe: could not set the probe buffer")
    for bf16 in (False, True):
        for _ in range(3):
            ra.rel_apply_fwd_cuda(v, rel, R, bf16=bf16)
        buf.zero_()
        ra.rel_apply_fwd_cuda(v, rel, R, bf16=bf16)
        torch.cuda.synchronize()
        host = buf.cpu().numpy()
        rec = host[:COUNT_AT].reshape(MAX_BLOCKS, MAX_WARPS, FIELDS)
        summarize(tools.log, f"forward {'bf16' if bf16 else 'fp32'}", rec, clock_ghz)
        count_summary(tools.log, host)
        for _ in range(3):
            ra.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16)
        buf.zero_()
        ra.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16)
        torch.cuda.synchronize()
        host = buf.cpu().numpy()
        rec = host[BWD_AT:].reshape(MAX_BLOCKS, 8, FIELDS)
        summarize(tools.log, f"backward {'bf16' if bf16 else 'fp32'}", rec, clock_ghz,
                  BWD_PHASES)
    # the variants in turns with the source as built
    for rnd in range(2):
        for name in ["base", *variants]:
            use(ra, cuda_build, libs[name])
            for bf16 in (False, True):
                t = {**device_ms(tools, torch, lambda: ra.rel_apply_fwd_cuda(v, rel, R, bf16=bf16),
                                 names),
                     **device_ms(tools, torch,
                                 lambda: ra.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16),
                                 names[3:])}
                tools.log(f"[rel-probe] round {rnd} {name} {'bf16' if bf16 else 'fp32'}: {t}")


if __name__ == "__main__":
    main()
