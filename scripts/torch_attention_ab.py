"""Time the port's attention-only kernels, for one checkout of the repository,
on one CUDA card.

    python scripts/torch_attention_ab.py [TREE] [--phases sasrec_attention]

TREE (default: the checkout this script lies in) is the root of a checkout:
its ``recbole_tpu_torch`` is imported, so two checkouts are compared by
running the script once for each, in turns (A, B, B, A), on one machine.
At SASRec's step (B 2,048, H 2, hd 32, causal; key lengths drawn from a
seed) at L 50 (the kernel table's row 7) and L 200 (row 7b) it prints, for
the forward at dropout 0.5 (the main path's) and 0 (like for like with the
library), and for the backward at 0.5:

* ``ms``: CUDA events over back-to-back calls (what chip_smoke.py reports);
* ``graph_ms``: the same calls captured in one CUDA graph and replayed, so
  the host's launch rate drops out;
* ``kernels``: each kernel a call launches, with its count and device time
  per call (torch.profiler);
* ``library_ms``: F.scaled_dot_product_attention in fp32 with a boolean
  mask, no dropout, on inputs already in its (B, H, L, hd) layout: forward,
  and forward + backward beside the backward;
* ``route`` and ``blocks_per_sm`` where the tree has routes (the resident
  blocks of the route's kernel on this card).

``--phases`` then runs the tree's own chip_smoke.py phases (its launch
counters are the tree's: ``sasrec_attention`` is SASRec with
fused_attention True, 1 epoch and 20 steps under the profiler). The timing
tools are this checkout's chip_smoke.py helpers, whatever the tree. Exits
non-zero without a card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--phases", default="")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from torch.nn import functional as F
    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_ab: needs a CUDA card")
    tools = load_smoke(here, "smoke_tools")
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import fused_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tools.log(f"[attn-ab] tree {tree}; {smi}")
    cuda_build.build(["fused_attention"])
    B, H = tools.SASREC["B"], tools.SASREC["H"]
    hd = tools.SASREC["D"] // H
    for L in (tools.SASREC["L"], 200):
        q, k, v, valid, do = tools.attention_inputs(torch, B, L, H, hd, 51, empty_row=False)
        seed = torch.tensor([51], dtype=torch.int64, device="cuda")
        where = {}
        if hasattr(fa, "fused_attention_route"):
            where = {"route": fa.fused_attention_route(L, hd),
                     "blocks_per_sm": [fa.fused_attention_blocks_per_sm(L, hd, True, backward)
                                       for backward in (False, True)]}
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
        allowed = (valid[:, None, None, :] > 0) & torch.tril(
            torch.ones(L, L, dtype=torch.bool, device="cuda"))
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (qt, kt, vt))

        def lib_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)

        def lib_fwd_bwd():
            for t in (qg, kg, vg):
                t.grad = None
            F.scaled_dot_product_attention(qg, kg, vg, attn_mask=allowed).backward(dot)

        library = {"fwd": tools.cuda_ms(torch, lib_fwd, 50),
                   "bwd": tools.cuda_ms(torch, lib_fwd_bwd, 50)}
        o, stats = fa.fused_attention_fwd_cuda(q, k, v, valid, seed, with_stats=True,
                                               causal=True, rate=0.5)
        calls = {
            "fwd": (lambda: fa.fused_attention_fwd_cuda(q, k, v, valid, seed, causal=True,
                                                        rate=0.5), library["fwd"]),
            "fwd_rate0": (lambda: fa.fused_attention_fwd_cuda(q, k, v, valid, causal=True),
                          library["fwd"]),
            "bwd": (lambda: fa.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o,
                                                        stats=stats, causal=True, rate=0.5),
                    library["bwd"])}
        for way, (kernel, lib_ms) in calls.items():
            t = {"ms": tools.cuda_ms(torch, kernel, 50),
                 "graph_ms": tools.graph_ms(torch, kernel, calls=10, replays=10),
                 "library_ms": lib_ms, **where,
                 "kernels": tools.kernels_per_call(torch, kernel, calls=10)}
            tools.log(f"[attn-ab] {way} B={B} L={L} H={H} hd={hd} causal: {json.dumps(t)}")
    if args.phases:
        phases = load_smoke(tree, "tree_smoke")
        with tempfile.TemporaryDirectory() as tmp:
            phases.write_ml1m_shape(os.path.join(tmp, "data", "ml-1m-shape", "ml-1m-shape.inter"))
            for phase in args.phases.split(","):
                getattr(phases, f"phase_{phase}")(torch, tmp)


def load_smoke(root, name):
    """The chip_smoke.py of the checkout at ``root``, as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


if __name__ == "__main__":
    main()
