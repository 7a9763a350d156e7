"""Time the port's masked top-k kernel and BPR's full-sort valid pass that
launches it, for one checkout of the repository, on one CUDA card.

    python scripts/torch_topk_ab.py [TREE] [--kernels-only]

TREE (default: the checkout this script lies in) is the root of a checkout:
its ``recbole_tpu_torch`` and its ``chip_smoke.py`` phases are imported, the
timing tools are this checkout's ``chip_smoke.py``, so two checkouts are
compared by running the script once for each, in turns (A, B, B, A), on one
machine. It prints, for ``masked_topk_cuda`` at D 64, k 10 on
``chip_smoke.topk_inputs`` (power-law histories, ~3.6% of items a row):

* B 4,096 / N 3,707 and B 1,944 / N 3,707 (an ml-1m-shaped pass's two
  batches), B 943 / N 1,683 (ml-100k's), and B 4,096 / N 98,409 (the
  Yelp-shaped item count; its mask is 403 MB, the plain version is skipped);
* for each: ``ms`` by CUDA events over back-to-back calls, ``graph_ms``
  with the calls captured in one CUDA graph, ``host_ms`` the host's enqueue
  a call, the bounds (bytes, the fp32 rate and the 3xTF32 rate), the
  library call (matmul + masked_fill + topk) by events and in a graph, the
  kernels a call with their device time (torch.profiler; left out, and
  said so, where it did not see a whole number of launches a call), and
  the worst value error against the plain version;

then BPR's two epochs on the ml-1m-shaped file with their full-sort valid
passes, as the tree's ``chip_smoke.phase_bpr`` logs them (``--kernels-only``
skips them). Exits non-zero without a card.
"""

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile

SHAPES = ((4096, 3707, True), (1944, 3707, True), (943, 1683, True), (4096, 98409, False))


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--kernels-only", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_topk_ab: needs a CUDA card")
    spec = importlib.util.spec_from_file_location(
        "smoke_tools", os.path.join(here, "chip_smoke.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    import chip_smoke as cs
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import masked_topk as mt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    tools.log(f"[topk-ab] tree {tree}; {smi.strip()}")
    logs = cuda_build.build(["masked_topk", "fused_adam"])
    for line in logs["masked_topk"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            tools.log(f"[topk-ab] ptxas {line.strip()}")
    for B, N, plain in SHAPES:
        t = tools.time_topk(torch, mt.masked_topk_cuda, B, N, 64, 10, seed=1, plain=plain)
        q, items, mask = tools.topk_inputs(torch, B, N, 64, 1)
        kernels = tools.kernels_per_call(torch, lambda: mt.masked_topk_cuda(q, items, mask, 10))
        if all(n >= 1 and n == round(n) for n, _ in kernels.values()):
            t["kernels"] = kernels
        else:
            tools.log(f"[topk-ab] the profiler saw part of the launches: {kernels}; left out")
        if plain:
            v, _ = mt.masked_topk_cuda(q, items, mask, 10)
            ref, _ = mt.masked_topk_torch(q, items, mask, 10)
            t["max_abs_err"] = float((v - ref).abs().max())
        del q, items, mask
        tools.log(f"[topk-ab] masked_topk B={B} N={N} D=64 k=10: {t}")
        torch.cuda.empty_cache()
    if args.kernels_only:
        return
    cs.count_adam_steps()  # the phase holds Adam to one launch a step
    with tempfile.TemporaryDirectory() as tmp:
        cs.phase_bpr(torch, tmp)


if __name__ == "__main__":
    main()
