"""Where a step of the GRU's one-block tensor-core kernels goes, on one CUDA
card: the clocks of each phase of a recurrence step, read by ``clock64`` in
thread 0 of block 0 and averaged over the L steps.

    python scripts/torch_gru_probe.py [TREE] [--no-copies] [--fp32]

TREE (default: the checkout this script lies in) is a checkout whose
``recbole_tpu_torch/csrc/fused_gru.cu`` has the tensor-core route. The
script writes a copy of that source with the probes put in, builds it with
the port's nvcc flags into ``recbole_tpu_torch/_build/``, runs the bf16
forward and backward at GRU4Rec's step (B 2,048, L 50, H 128) through the
port's own launchers, and prints, a step:

* forward: the product (with the next steps' copies issued before it), the
  gates and the h exchange, the wait and the barrier;
* backward: issuing the next step's copies, the recompute, the gates (dhh's
  terms, dxi and dhh into shared memory), the first barrier, dhh wh^T and
  the dh update, the rows to device memory, the wait and the second barrier.

A probe reads the clock once the values of the phase before it are in
registers, so a phase's time includes the latency of what it waits for.
``--fp32`` probes the fp32 instance's 3xTF32 kernels instead (forward: the
product, the gates and the stores, the barrier; backward: the recompute,
the gates, the first barrier, issuing the copies, dhh wh^T with the dh
update, the wait and the second barrier). ``--no-copies`` (bf16 only) also
builds a copy that issues no staging copies after the
first step (its results are wrong: a timing only) and prints both copies'
times by CUDA events, so the difference is what the copies cost. Exits
non-zero without a card.
"""

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

# (anchor, replacement) pairs: the probes, then what --no-copies changes
PROBES = [
    ("constexpr int kTcRows = 16;",
     "__device__ unsigned long long g_probe[16];\n"
     "#define PCLK(v) asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(v) :: \"memory\")\n"
     "constexpr int kTcRows = 16;"),
    ("  int cur = 0, xb = 0;  // xb = t % 3\n  for (int t = 0; t < L; ++t) {\n",
     "  int cur = 0, xb = 0;  // xb = t % 3\n"
     "  unsigned long long ps[3] = {0, 0, 0}, pc[4];\n  int sink = 0;\n"
     "  for (int t = 0; t < L; ++t) {\n    PCLK(pc[0]);\n"),
    ("    tc_product<NT>(hb + (size_t)cur * kTcRows * ks, whs, nks, hp, ks, u0, lane, acc);\n",
     "    tc_product<NT>(hb + (size_t)cur * kTcRows * ks, whs, nks, hp, ks, u0, lane, acc);\n"
     "    sink += acc[2][NT - 1][3] == 1234.5f;\n    PCLK(pc[1]);\n"),
    ("    cp_async_commit_wait_prior();  // xi_{t+1} has landed\n    __syncthreads();\n"
     "    cur ^= 1;\n    xb = xb == 2 ? 0 : xb + 1;\n  }\n}",
     "    PCLK(pc[2]);\n"
     "    cp_async_commit_wait_prior();  // xi_{t+1} has landed\n    __syncthreads();\n"
     "    PCLK(pc[3]);\n    for (int i = 0; i < 3; ++i) ps[i] += pc[i + 1] - pc[i];\n"
     "    cur ^= 1;\n    xb = xb == 2 ? 0 : xb + 1;\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 3; ++i) g_probe[i] = ps[i];\n    g_probe[3] = sink;\n  }\n}"),
    ("  for (int t = L - 1; t >= 0; --t) {\n    const int s = t & 1;\n"
     "    if (t > 0) stage(t - 1);  // in flight during this step\n",
     "  unsigned long long ps[7] = {0, 0, 0, 0, 0, 0, 0}, pc[8];\n  int sink = 0;\n"
     "  for (int t = L - 1; t >= 0; --t) {\n    PCLK(pc[0]);\n    const int s = t & 1;\n"
     "    if (t > 0) stage(t - 1);  // in flight during this step\n    PCLK(pc[1]);\n"),
    ("    tc_product<NT>(hrows(s), whs, nks, hp, ks, u0, lane, acc);\n",
     "    tc_product<NT>(hrows(s), whs, nks, hp, ks, u0, lane, acc);\n"
     "    sink += acc[2][NT - 1][3] == 1234.5f;\n    PCLK(pc[2]);\n"),
    ("    __syncthreads();  // dsc is complete\n    // P = (hi + lo) wh^T for the warp's units\n",
     "    PCLK(pc[3]);\n    __syncthreads();  // dsc is complete\n    PCLK(pc[4]);\n"
     "    // P = (hi + lo) wh^T for the warp's units\n"),
    ("    // the step's dxi and dhh rows to device memory, a warp a (row, gate) at a\n",
     "    sink += dh[NT - 1][3] == 1234.5f;\n    PCLK(pc[5]);\n"
     "    // the step's dxi and dhh rows to device memory, a warp a (row, gate) at a\n"),
    ("    cp_async_wait_all();  // the next step's staging has landed\n"
     "    __syncthreads();      // and nobody reads dsc any more\n  }\n",
     "    PCLK(pc[6]);\n    cp_async_wait_all();  // the next step's staging has landed\n"
     "    __syncthreads();      // and nobody reads dsc any more\n    PCLK(pc[7]);\n"
     "    for (int i = 0; i < 7; ++i) ps[i] += pc[i + 1] - pc[i];\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 7; ++i) g_probe[8 + i] = ps[i];\n    g_probe[15] = sink;\n  }\n"),
]
# the fp32 instance's 3xTF32 kernels (``--fp32``)
PROBES_TF32 = [
    ("constexpr int kTfFwdNT = 1, kTfBwdNT = 2;",
     "__device__ unsigned long long g_probe[16];\n"
     "#define PCLK(v) asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(v) :: \"memory\")\n"
     "constexpr int kTfFwdNT = 1, kTfBwdNT = 2;"),
    ("  int cur = 0;\n  for (int t = 0; t < L; ++t) {\n    if (t + 1 < L) load_x(t + 1, xn);\n",
     "  int cur = 0;\n  unsigned long long ps[3] = {0, 0, 0}, pc[4];\n  int sink = 0;\n"
     "  for (int t = 0; t < L; ++t) {\n    PCLK(pc[0]);\n    if (t + 1 < L) load_x(t + 1, xn);\n"),
    ("    tf_product<NT>(hb + (size_t)cur * kRows * ks, whs, hp, ks, u0, lane, acc);\n",
     "    tf_product<NT>(hb + (size_t)cur * kRows * ks, whs, hp, ks, u0, lane, acc);\n"
     "    sink += acc[2][NT - 1][3] == 1234.5f;\n    PCLK(pc[1]);\n"),
    ("    __syncthreads();\n    cur ^= 1;\n#pragma unroll\n",
     "    PCLK(pc[2]);\n    __syncthreads();\n    PCLK(pc[3]);\n"
     "    for (int i = 0; i < 3; ++i) ps[i] += pc[i + 1] - pc[i];\n"
     "    cur ^= 1;\n#pragma unroll\n"),
    ("        for (int g = 0; g < 3; ++g) xc[nt][i][g] = xn[nt][i][g];\n  }\n}\n",
     "        for (int g = 0; g < 3; ++g) xc[nt][i][g] = xn[nt][i][g];\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 3; ++i) g_probe[i] = ps[i];\n    g_probe[3] = sink;\n  }\n}\n"),
    ("  for (int t = L - 1; t >= 0; --t) {\n    if (t > 0) load_xy(t - 1, xn, yn);\n",
     "  unsigned long long ps[6] = {0, 0, 0, 0, 0, 0}, pc[7];\n  int sink = 0;\n"
     "  for (int t = L - 1; t >= 0; --t) {\n    PCLK(pc[0]);\n"
     "    if (t > 0) load_xy(t - 1, xn, yn);\n"),
    ("    tf_product<NT>(hs, whs, hp, ks, u0, lane, acc);\n",
     "    tf_product<NT>(hs, whs, hp, ks, u0, lane, acc);\n"
     "    sink += acc[2][NT - 1][3] == 1234.5f;\n    PCLK(pc[1]);\n"),
    ("    __syncthreads();  // ds is complete, and nobody reads hs any more this step\n"
     "    if (t > 0) tf_stage_h(hs, h0, out, b0, B, L, t - 1, H, hp, ks);\n",
     "    PCLK(pc[2]);\n"
     "    __syncthreads();  // ds is complete, and nobody reads hs any more this step\n"
     "    PCLK(pc[3]);\n    if (t > 0) tf_stage_h(hs, h0, out, b0, B, L, t - 1, H, hp, ks);\n"
     "    PCLK(pc[4]);\n"),
    ("      for (int e = 0; e < 4; ++e) dh[nt][e] = dh[nt][e] * acc[1][nt][e] + p[nt][e];\n",
     "      for (int e = 0; e < 4; ++e) dh[nt][e] = dh[nt][e] * acc[1][nt][e] + p[nt][e];\n"
     "    sink += dh[NT - 1][3] == 1234.5f;\n    PCLK(pc[5]);\n"),
    ("    __syncthreads();      // and nobody reads ds any more\n",
     "    __syncthreads();      // and nobody reads ds any more\n    PCLK(pc[6]);\n"
     "    for (int i = 0; i < 6; ++i) ps[i] += pc[i + 1] - pc[i];\n"),
    ("            make_float2(dh[nt][2 * i], dh[nt][2 * i + 1]);\n"
     "    // the block's dbh over its rows",
     "            make_float2(dh[nt][2 * i], dh[nt][2 * i + 1]);\n"
     "    if (nt == 0 && blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "      for (int i = 0; i < 6; ++i) g_probe[8 + i] = ps[i];\n      g_probe[15] = sink;\n    }\n"
     "    // the block's dbh over its rows"),
]
NO_COPIES = [
    ("    if (t + 2 < L) tc_stage_rows(", "    if (t + 2 < 2) tc_stage_rows("),
    ("    if (t > 0) stage(t - 1);  // in flight during this step\n",
     "    if (t == 1) stage(t - 1);  // in flight during this step\n"),
]
READ = ('\nextern "C" int fused_gru_probe(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n")


def stamped(source, pairs, out_dir, tag, cuda_build):
    """Build ``source`` with each pair's anchor replaced (and, with the
    probes, a function that reads them); returns the .so."""
    for anchor, new in pairs:
        if source.count(anchor) != 1:
            raise SystemExit(f"torch_gru_probe: anchor not found once in fused_gru.cu:\n{anchor}")
        source = source.replace(anchor, new)
    cu = os.path.join(out_dir, f"fused_gru_{tag}.cu")
    so = os.path.join(out_dir, f"libfused_gru_{tag}.so")
    with open(cu, "w") as fh:
        fh.write(source + (READ if "g_probe" in source else ""))
    built = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
                           capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"torch_gru_probe: nvcc failed for {cu}:\n{built.stdout}{built.stderr}")
    return so


def use(fg, cuda_build, so):
    """Point the port's launchers at the library ``so``."""
    load = cuda_build.load
    cuda_build.load = lambda name: ctypes.CDLL(so)
    fg._LIB = None
    lib = fg._lib()
    cuda_build.load = load
    return lib


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--no-copies", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_gru_probe: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("smoke_tools",
                                                  os.path.join(here, "chip_smoke.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import fused_gru as fg
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tools.log(f"[gru-probe] tree {tree}; {smi}")
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_gru.cu")) as fh:
        source = fh.read()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    B, L, H = tools.GRU4REC["B"], tools.GRU4REC["L"], tools.GRU4REC["H"]
    xi, hinit, wh, bh, dout = tools.gru_inputs(torch, B, L, H, 41, not args.fp32, False)

    lib = use(fg, cuda_build, stamped(source, PROBES_TF32 if args.fp32 else PROBES,
                                      cuda_build.BUILD_DIR, "probe", cuda_build))
    lib.fused_gru_probe.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 16)()
    for _ in range(3):
        y = fg.fused_gru_fwd_cuda(xi, hinit, wh, bh)
        fg.fused_gru_bwd_cuda(xi, hinit, wh, bh, y, dout)
    torch.cuda.synchronize()
    err = lib.fused_gru_probe(ctypes.addressof(buf))
    if err:
        raise RuntimeError(f"torch_gru_probe: reading the probes failed: CUDA error {err}")
    v = [x / L for x in buf]
    if args.fp32:
        tools.log(f"[gru-probe] fp32 (3xTF32) forward clocks a step (B={B} L={L} H={H}): "
                  f"product {v[0]:.0f}, gates and stores {v[1]:.0f}, barrier {v[2]:.0f}")
        tools.log(f"[gru-probe] fp32 backward clocks a step: recompute {v[8]:.0f}, gates "
                  f"{v[9]:.0f}, first barrier {v[10]:.0f}, copies issued {v[11]:.0f}, dhh wh^T "
                  f"and the dh update {v[12]:.0f}, wait and second barrier {v[13]:.0f}")
        return
    tools.log(f"[gru-probe] forward clocks a step (B={B} L={L} H={H}): product "
              f"{v[0]:.0f}, gates and exchange {v[1]:.0f}, wait and barrier {v[2]:.0f}")
    tools.log(f"[gru-probe] backward clocks a step: copies issued {v[8]:.0f}, recompute "
              f"{v[9]:.0f}, gates {v[10]:.0f}, first barrier {v[11]:.0f}, dhh wh^T "
              f"{v[12]:.0f}, rows out {v[13]:.0f}, wait and second barrier {v[14]:.0f}")
    if args.no_copies:
        libs = {tag: stamped(source, pairs, cuda_build.BUILD_DIR, tag, cuda_build)
                for tag, pairs in (("plain", []), ("nocopies", NO_COPIES))}
        for tag in ("plain", "nocopies", "plain"):
            use(fg, cuda_build, libs[tag])
            y = fg.fused_gru_fwd_cuda(xi, hinit, wh, bh)
            t = {"fwd_ms": tools.cuda_ms(torch, lambda: fg.fused_gru_fwd_cuda(xi, hinit, wh, bh),
                                         20),
                 "bwd_ms": tools.cuda_ms(torch, lambda: fg.fused_gru_bwd_cuda(
                     xi, hinit, wh, bh, y, dout), 20)}
            tools.log(f"[gru-probe] {tag} copy (events): {t}")


if __name__ == "__main__":
    main()
