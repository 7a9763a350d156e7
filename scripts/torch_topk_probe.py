"""Time copies of the masked top-k kernel with a part taken out, to see
where its time goes, on one CUDA card.

    python scripts/torch_topk_probe.py [--variants base,no-select,...]
                                       [--shapes 4096x3707,943x1683]
                                       [--plans 4:4,2:2,1:1]

Each variant is ``recbole_tpu_torch/csrc/masked_topk.cu`` with one part
removed by a text substitution, built by nvcc with the build's flags into a
temporary directory and launched through ``masked_topk_cuda`` (its plan,
scratch and tickets) in place of the built library. Results of the cut
variants are wrong: they are timings only. Variants:

* ``base``: the source as it is;
* ``no-select``: no selection (the scores are written and the rows
  flagged, no list kept);
* ``no-sort``: the first tile of a slice is not sorted into the list;
* ``no-insert``: later tiles' candidates are found, not placed;
* ``no-mma``: the three products a k-step replaced by one fp32 add;
* ``no-mask``: the mask bytes are not staged (nothing is masked);
* ``no-merge``: the last block of a row tile does not merge;
* ``sel8``: 8 selecting warps in place of 16 (timings right);
* ``roll``: the k-steps of a K chunk not unrolled (timings right);
* ``no-split``: operands fed to the tensor cores unsplit (lo 0);
* ``mma-only``: the products' operands constants, no loads or splits;
* ``clocks``: the source with ``clock64`` stamps, printing the product
  warps' clocks waiting for a stage (and the barrier), in the products,
  storing the scores, and in all, the selecting warps' waiting, selecting
  and in all, and each merging block's clocks in the merge (means and
  maxima over the warps).

For each variant and shape (D 64, k 10, ``chip_smoke.topk_inputs``): ms by
CUDA events and in a CUDA graph; ``--plans`` times the base at each given
(block height in m16 tiles : slices) in place of the plan's choice (the
shared memory as the plan computes it for that height). Exits
non-zero without a card.
"""

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys
import tempfile

SUBS = {
    "no-select": [("  unsigned flagged = __ballot_sync(", "  unsigned flagged = 0 & __ballot_sync(")],
    "no-sort": [("      sort64(sv0, si0, sv1, si1, lane);\n", "")],
    "no-insert": [("    if (!(bal0 | bal1)) continue;\n", "    if (bal0 | bal1 | 1) continue;\n")],
    "no-mma": [("        mma1688(d, al, bh0, bh1);\n        mma1688(d, ah, bl0, bl1);\n        mma1688(d, ah, bh0, bh1);\n",
                "        d[0] = __uint_as_float(al[0] ^ bh0 ^ bl1); d[1] = __uint_as_float(ah[1] ^ bh1);\n"
                "        d[2] = __uint_as_float(ah[2] ^ bl0); d[3] = __uint_as_float(ah[3] ^ al[3]);\n")],
    "no-mask": [("      if (c == nch - 1) {\n        int8_t* s_m", "      if (c == nch - 1 && nch < 0) {\n        int8_t* s_m"),
                ("            v[e] = live && mr[col + e] > 0 ? kNegInf : acc[j][2 * half + e];\n",
                 "            v[e] = acc[j][2 * half + e];\n")],
    "no-merge": [("    if (!*s_last) return;\n", "    if (*s_last >= 0) { if (tid == 0 && *s_last) tickets[blockIdx.x] = 0; return; }\n")],
    "sel8": [("constexpr int kSelWarps = 16;", "constexpr int kSelWarps = 8;")],
    "no-split": [("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n  lo = __float_as_uint(x - __uint_as_float(hi));\n",
                  "  hi = __float_as_uint(x);\n  lo = 0u;\n")],
    "mma-only": [("      split_tf32(s_q[8 * ks], ah[0], al[0]);\n      split_tf32(s_q[8 * AS + 8 * ks], ah[1], al[1]);\n"
                  "      split_tf32(s_q[8 * ks + 4], ah[2], al[2]);\n      split_tf32(s_q[8 * AS + 8 * ks + 4], ah[3], al[3]);\n",
                  "      ah[0] = al[0] = ah[1] = al[1] = ah[2] = al[2] = ah[3] = al[3] = 0x3c000000u + ks;\n"),
                 ("        split_tf32(s_it[8 * j * kIS + 8 * ks], bh0, bl0);\n        split_tf32(s_it[8 * j * kIS + 8 * ks + 4], bh1, bl1);\n",
                  "        bh0 = bl0 = bh1 = bl1 = 0x3c000000u + j;\n")],
    "roll": [("#pragma unroll\n    for (int ks = 0; ks < kKC / 8; ++ks) {", "#pragma unroll 1\n    for (int ks = 0; ks < kKC / 8; ++ks) {")],
}


CLOCKS = [
    ("  for (int step = 0; step < nsteps; ++step) {\n    cp_wait<kStages - 2>();\n"
     "    __syncthreads();  // step's stage landed; the stage refilled below is consumed\n",
     "  long long pc[6] = {0, 0, 0, 0, 0, 0};\n  const long long pc_start = clock64();\n"
     "  for (int step = 0; step < nsteps; ++step) {\n    const long long c0 = clock64();\n"
     "    cp_wait<kStages - 2>();\n"
     "    __syncthreads();  // step's stage landed; the stage refilled below is consumed\n"
     "    const long long c1 = clock64();\n    pc[0] += c1 - c0;\n"),
    ("      continue;\n    }\n    if (c == 0) {\n",
     "      pc[3] += clock64() - c1;\n      continue;\n    }\n    if (c == 0) {\n"),
    ("    if (c != nch - 1) continue;\n",
     "    const long long c2 = clock64();\n    pc[1] += c2 - c1;\n    if (c != nch - 1) continue;\n"),
    ("        if (cand && live) flags[lr] = 1;\n      }\n    }\n  }\n  cp_wait<0>();\n",
     "        if (cand && live) flags[lr] = 1;\n      }\n    }\n    pc[2] += clock64() - c2;\n  }\n  cp_wait<0>();\n"),
    ("  __syncthreads();  // every row's list is final\n",
     "  __syncthreads();  // every row's list is final\n  pc[4] = clock64() - pc_start;\n"
     "  {\n    unsigned long long* o = g_probe + ((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 32 + warp) * 6;\n"
     "    if (lane == 0) for (int e = 0; e < 5; ++e) o[e] = pc[e];\n    if (lane == 0) o[5] = 0;\n  }\n"),
    ("    if (!*s_last) return;\n    __threadfence();\n",
     "    if (!*s_last) return;\n    __threadfence();\n    const long long m0 = clock64();\n"),
    ("    if (tid == 0) tickets[blockIdx.x] = 0;\n",
     "    if (lane == 0) g_probe[((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 32 + warp) * 6 + 5] = clock64() - m0;\n"
     "    if (tid == 0) tickets[blockIdx.x] = 0;\n"),
]
PROBE_DECL = "__device__ unsigned long long g_probe[4096 * 32 * 6];\n"
PROBE_READ = (
    "\nextern \"C\" int probe_read(unsigned long long* dst, long long n) {\n"
    "  return (int)cudaMemcpyFromSymbol(dst, g_probe, n * sizeof(unsigned long long));\n}\n"
    "extern \"C\" int probe_clear() {\n"
    "  static unsigned long long zero[4096 * 32 * 6];\n"
    "  return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));\n}\n")


def variant_source(src, name):
    if name == "base":
        return src
    if name == "clocks":
        for old, new in CLOCKS:
            if old not in src:
                raise SystemExit(f"torch_topk_probe: clocks: an anchor is not in the source: {old!r}")
            src = src.replace(old, new)
        return src.replace("namespace {\n", "namespace {\n" + PROBE_DECL, 1) + PROBE_READ
    for old, new in SUBS[name]:
        if old not in src:
            raise SystemExit(f"torch_topk_probe: variant {name}: its anchor is not in the source")
        src = src.replace(old, new)
    return src


def print_clocks(torch, tools, lib, call, plan):
    """One call's clock64 stamps: each phase's mean and maximum over the
    product warps (waiting, products, storing the scores), the selecting
    warps (waiting, selecting) and all, and the merge's over the merging
    blocks' warps."""
    import numpy as np
    lib.probe_clear()
    call()
    torch.cuda.synchronize()
    n = plan.row_tiles * plan.slices * 32 * 6
    buf = np.zeros(n, np.uint64)
    lib.probe_read(ctypes.c_void_p(buf.ctypes.data), ctypes.c_longlong(n))
    per = buf.reshape(-1, 32, 6).astype(np.float64)
    pw, sel = (16 if plan.mt >= 2 else 8), 16

    def mm(a):
        return (round(float(a.mean())), round(float(a.max()))) if a.size else None

    out = {"product warps": {nm: mm(per[:, :pw, e]) for e, nm in
                             ((0, "wait"), (1, "products"), (2, "scores"), (4, "total"))},
           "selecting warps": {nm: mm(per[:, pw:pw + sel, e]) for e, nm in
                               ((0, "wait"), (3, "select"), (4, "total"))}}
    merged = per[:, :, 5][per[:, :, 5] > 0]
    out["merge"] = mm(merged)
    tools.log(f"[topk-probe] clocks a warp (mean, max) {plan}: {out}")


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base,no-select,no-sort,no-insert,no-mma,no-mask,no-merge")
    ap.add_argument("--shapes", default="4096x3707,943x1683")
    ap.add_argument("--plans", default="")
    args = ap.parse_args()
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_topk_probe: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("smoke_tools", os.path.join(here, "chip_smoke.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import masked_topk as mt
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout
    tools.log(f"[topk-probe] {smi.strip()}")
    with open(os.path.join(cuda_build.CSRC_DIR, "masked_topk.cu")) as fh:
        src = fh.read()
    names = args.variants.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in names:
            path = os.path.join(tmp, f"{name}.cu")
            with open(path, "w") as fh:
                fh.write(variant_source(src, name))
            procs[name] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", os.path.join(tmp, f"{name}.so"),
                 path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        libs = {}
        for name, proc in procs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"torch_topk_probe: nvcc failed for {name}:\n{out}")
            regs = [line.strip() for line in out.splitlines() if "Used" in line]
            tools.log(f"[topk-probe] {name} built; {regs[:3]}")
            libs[name] = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        for shape in args.shapes.split(","):
            B, N = (int(x) for x in shape.split("x"))
            q, items, mask = tools.topk_inputs(torch, B, N, 64, 1)
            for name in names:
                lib = libs[name]
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.masked_topk_f32.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, p, p]
                lib.masked_topk_f32.restype = i
                mt._LIB = lib

                def call():
                    return mt.masked_topk_cuda(q, items, mask, 10)

                t = {"ms": tools.cuda_ms(torch, call, 50),
                     "graph_ms": tools.graph_ms(torch, call, calls=20, replays=10)}
                tools.log(f"[topk-probe] {name} B={B} N={N}: {t}")
                if name == "clocks":
                    print_clocks(torch, tools, lib, call, mt.masked_topk_plan(B, N, 64, 10))
                if name == "base" and args.plans:
                    for spec_ in args.plans.split(","):
                        m_, s_ = (int(x) for x in spec_.split(":"))
                        rows = -(-B // (16 * m_))
                        mt._PLANS[(q.device.index, B, N, 64, 10)] = mt.MaskedTopkPlan(
                            m_, rows, min(s_, -(-N // mt.TN)), mt.masked_topk_smem(m_, 64, 10))
                        t = {"ms": tools.cuda_ms(torch, call, 50),
                             "graph_ms": tools.graph_ms(torch, call, calls=20, replays=10)}
                        tools.log(f"[topk-probe] plan mt={m_} S={s_} ({rows * s_} blocks) "
                                  f"B={B} N={N}: {t}")
                    mt._PLANS.clear()
            mt._LIB = None


if __name__ == "__main__":
    main()
