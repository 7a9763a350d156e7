"""Where the time of the whole-layer kernels goes, on one CUDA card.

    python scripts/torch_trm_phases.py [--variants base,nog,noact,kkb2,kkb8]

Builds copies of ``recbole_tpu_torch/csrc/trm_layer.cu`` into the package's
build directory, one for each variant, each with a clock stamp after every
block barrier of the layer's body, which both instances share (the bf16
kernels and the fp32 instance's 3xTF32 ones): thread 0 of each block adds
the cycles since its previous stamp to a counter kept for the stamp's source
line. At SASRec's train step (B 2,048, L 50, D 64, H 2, I 256, causal,
dropout 0.5) it prints for each variant and both instances the forward's
and the backward's time (CUDA events over 10 calls), the size of each
kernel's machine code (cuobjdump), and the phases (the work between two
barriers, named by the nearest call above the stamp) in order of cycles a
sequence a block. The variants other than ``base`` are measurements, not versions of
the kernel: ``nog`` skips the weight-gradient adds to device memory,
``noact`` takes the activation and its derivative as the identity (their
results are wrong); ``kkb2`` and ``kkb8`` load B fragments half or twice as
many k-steps at a time (bf16 4, fp32 2). The stamps themselves cost a few
percent. Exits non-zero without a card.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

HEAD = """
__device__ unsigned long long g_probe[8192];
__device__ long long g_prev[8192];
#define PROBE(id) do { if (threadIdx.x == 0) { long long t_ = clock64(); \\
  atomicAdd(&g_probe[id], (unsigned long long)(t_ - g_prev[blockIdx.x])); \\
  g_prev[blockIdx.x] = t_; } } while (0)
#define PROBE_START() do { if (threadIdx.x == 0) g_prev[blockIdx.x] = clock64(); } while (0)
"""
TAIL = """
extern "C" int trm_probe_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_probe, sizeof(g_probe));
}
extern "C" int trm_probe_reset() {
  static unsigned long long zero[8192];
  return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
}
"""
VARIANTS = {
    "base": [],
    "nog": [("old[j][e] = row < M && col < N ? G[(size_t)row * ldg + cm[j][e & 1]] : 0.0f;",
             "old[j][e] = 0.0f;"),
            ("if (row < M && col < N) G[(size_t)row * ldg + cm[j][e & 1]] = old[j][e] + acc[j][e];",
             "if (row < M && col < N && acc[j][e] == 1.2345f) G[(size_t)row * ldg + cm[j][e & 1]] = "
             "acc[j][e];")],
    "noact": [("float tc_act(int act, float x) { return act_fn(act, x); }",
               "float tc_act(int act, float x) { return x; }"),
              ("  if (act == GELU) {\n    const float e = erff",
               "  return make_float2(x, 1.0f);\n  if (act == GELU) {\n    const float e = erff")],
    "kkb2": [("kShift = 4, kKB = 4, kStrips = 1;", "kShift = 4, kKB = 2, kStrips = 1;"),
             ("kShift = 3, kKB = 2, kStrips = 2;", "kShift = 3, kKB = 1, kStrips = 2;")],
    "kkb8": [("kShift = 4, kKB = 4, kStrips = 1;", "kShift = 4, kKB = 8, kStrips = 1;"),
             ("kShift = 3, kKB = 2, kStrips = 2;", "kShift = 3, kKB = 4, kStrips = 2;")],
}
KERNELS = {"bf16": "trm_layer_bf16_", "fp32": "trm_layer_tf32x3_"}


def instrument(src):
    """The source with a stamp after each barrier of the layer's body."""
    a = src.index("// ============================================================ the layer")
    b = src.index("// ==================================================================== shared")
    first, last = src[:a].count("\n"), src[:b].count("\n")
    lines = src.split("\n")
    for n in range(first, last):
        if "__syncthreads();" in lines[n]:
            lines[n] = lines[n].replace("__syncthreads();", f"__syncthreads(); PROBE({n + 1});")
        if "extern __shared__ float4 smem4[];" in lines[n]:
            lines[n] += " PROBE_START();"
    return "\n".join(lines).replace("namespace {\n", HEAD + "\nnamespace {\n", 1) + TAIL


def sass_sizes(cuobjdump, path):
    """Machine instructions of each kernel in a built library."""
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True).stdout
    sizes, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            sizes[fn] = 0
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[fn] += 1
    return sizes


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base")
    args = ap.parse_args()
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_trm_phases: needs a CUDA card")
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import trm_layer as tl
    import chip_smoke as tools
    src = open(os.path.join(cuda_build.CSRC_DIR, "trm_layer.cu")).read()
    names = []
    for v in args.variants.split(","):
        text = src
        for old, new in VARIANTS[v]:
            if old not in text:
                raise SystemExit(f"variant {v}: the source no longer has {old!r}")
            text = text.replace(old, new)
        name = f"trm_phases_{v}"
        with open(os.path.join(cuda_build.CSRC_DIR, f"{name}.cu"), "w") as fh:
            fh.write(instrument(text))
        names.append((v, name))
    try:
        paths = {name: cuda_build.library_path(name) for _, name in names}
        cuda_build.build([n for _, n in names])
    finally:
        for _, name in names:
            os.remove(os.path.join(cuda_build.CSRC_DIR, f"{name}.cu"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[trm-phases] {smi}")
    B, L, D, H, I = (tools.SASREC[k] for k in "BLDHI")
    x, params, valid, dy = tools.trm_inputs(torch, B, L, D, H, I, seed=21)
    seed = torch.tensor([21], dtype=torch.int64, device="cuda")
    lines = src.split("\n")
    for v, name in names:
        lib_path = paths[name]
        cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
        for fn, n in sass_sizes(cuobjdump, lib_path).items():
            for inst, prefix in KERNELS.items():
                if prefix in fn:
                    print(f"[trm-phases] {v}: {inst} {fn.split(prefix)[1][:10]} {n} "
                          f"instructions ({n * 16 / 1024:.1f} KB)")
        tl._LIB, tl._BLOCKS = None, {}
        lib = ctypes.CDLL(lib_path)
        cuda_build._LOADED[cuda_build.library_path("trm_layer")] = lib
        lib = tl._lib()
        lib.trm_probe_read.argtypes = [ctypes.c_void_p]
        for inst, way in ((i, w) for i in KERNELS for w in ("fwd", "bwd")):
            kw = dict(n_heads=H, causal=True, dropout=0.5, attn_dropout=0.5, bf16=inst == "bf16")
            if way == "fwd":
                def call():
                    return tl.trm_layer_fwd_cuda(x, params, valid, seed, **kw)
            else:
                def call():
                    return tl.trm_layer_bwd_cuda(x, params, valid, dy, seed, **kw)
            blocks = tl._lib().trm_layer_blocks(B, L, D, H, I, int(inst == "bf16"),
                                                int(way == "bwd"))
            ms = tools.cuda_ms(torch, call, 10)
            lib.trm_probe_reset()
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8192)()
            lib.trm_probe_read(ctypes.addressof(buf))
            total = sum(buf)
            print(f"[trm-phases] {v} {inst} {way}: {ms:.4f} ms, {blocks} blocks, "
                  f"{total / B:.0f} cycles a sequence a block")
            for c, i in sorted(((buf[i], i) for i in range(8192) if buf[i]), reverse=True)[:25]:
                j = i - 2
                while j > 0 and not re.search(r"mma_|for_keep|colsum|ln_|tc_|load_rows|//",
                                              lines[j]):
                    j -= 1
                print(f"  line {i:5d} {c / B:9.0f} cycles a sequence {100 * c / total:5.1f}%  "
                      f"after {lines[j].strip()[:80]}")
        tl._LIB, tl._BLOCKS = None, {}
        cuda_build._LOADED.pop(cuda_build.library_path("trm_layer"), None)


if __name__ == "__main__":
    main()
