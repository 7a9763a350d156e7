"""Time the port's one-hot embedding-gradient path and the training steps
that launch it, for one checkout of the repository, on one CUDA card.

    python scripts/torch_onehot_ab.py [TREE] [--kernels-only | --phases deepfm,...]

TREE (default: the checkout this script lies in) is the root of a checkout:
its ``chip_smoke.py`` helpers and its ``recbole_tpu_torch`` are imported, so
two checkouts are compared by running the script once for each, in turns
(A, B, B, A), on one machine. It prints, for ``onehot_matmul_grad_cuda`` at
Criteo's 17 small fields (as ``GroupedTakeRows.backward`` calls it) and at
the SASRec step's shape (as ``dense_row_grad`` calls it):

* ``ms``: CUDA events over back-to-back calls (what chip_smoke.py reports);
* ``graph_ms``: the same calls captured in one CUDA graph and replayed, so
  the host's launch rate drops out;
* ``kernels``: each kernel a call launches, with its count and device time
  per call (torch.profiler);

(the timing tools are this checkout's ``chip_smoke.py`` helpers, whatever
the tree)
* ``library_ms``: ``index_add_`` into zeros on the same inputs;
* ``host_ms``: the host's time to enqueue one call;

then the steady training step (wall, card busy share, launches) of DeepFM at
the Criteo width and of SASRec and GRU4Rec on the ml-1m-shaped file, as the
checkout's ``chip_smoke.py`` phases log them (``--phases`` picks some of
``deepfm``, ``sasrec``, ``gru4rec``; ``--kernels-only`` none).
Exits non-zero without a card.
"""

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile


def time_call(torch, tools, label, kernel, library, iters):
    t = {"host_ms": tools.host_ms(torch, kernel), "ms": tools.cuda_ms(torch, kernel, iters),
         "library_ms": tools.cuda_ms(torch, library, iters),
         "graph_ms": tools.graph_ms(torch, kernel),
         "library_graph_ms": tools.graph_ms(torch, library),
         "kernels": tools.kernels_per_call(torch, kernel)}
    tools.log(f"[onehot-ab] {label}: {json.dumps(t)}")
    return t


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--phases", default="deepfm,sasrec,gru4rec")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_onehot_ab: needs a CUDA card")
    # the timing tools from this checkout's chip_smoke.py, the inputs and
    # the training phases from the tree's
    spec = importlib.util.spec_from_file_location(
        "smoke_tools", os.path.join(here, "chip_smoke.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    import chip_smoke as cs
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import embed_grad as eg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    cs.log(f"[onehot-ab] tree {tree}; {smi.strip()}")
    cuda_build.build(["masked_topk", "embed_grad", "trm_layer", "fused_gru"])

    fields = cs.criteo_field_spec()
    n_large = sum(v > 16384 for _, v in fields)
    ids, g = cs.grad_inputs(torch, cs.CRITEO_BATCH, fields, cs.CRITEO_DIM, seed=8)
    bids, bg = ids[:, n_large:], g[:, n_large:]
    off, n_rows = fields[n_large][0], sum(v for _, v in fields[n_large:])
    kw = {"id_base": off}
    if "col_off" in inspect.signature(eg.onehot_matmul_grad_cuda).parameters:
        # the earlier design's hint, as its GroupedTakeRows passed it
        kw["col_off"] = torch.tensor([o for o, _ in fields[n_large:]] + [sum(fields[-1])],
                                     device="cuda")
    dest = torch.empty((n_rows, cs.CRITEO_DIM), device="cuda")
    local = (bids.reshape(-1) - off).contiguous()
    flat = bg.reshape(-1, cs.CRITEO_DIM).contiguous()
    time_call(torch, tools, f"criteo small fields R={bids.numel()} n_rows={n_rows}",
              lambda: eg.onehot_matmul_grad_cuda(bids, bg, n_rows, out=dest, **kw),
              lambda: dest.zero_().index_add_(0, local, flat), 200)

    V = cs.ML1M[1] + 1
    sids, sg = cs.seq_grad_inputs(torch, seed=11)
    sdest = torch.empty((V, sg.shape[1]), device="cuda")
    time_call(torch, tools, f"sasrec step R={sids.numel()} n_rows={V}",
              lambda: eg.onehot_matmul_grad_cuda(sids, sg, V, out=sdest),
              lambda: sdest.zero_().index_add_(0, sids, sg), 50)

    if args.kernels_only:
        return
    with tempfile.TemporaryDirectory() as tmp:
        phases = args.phases.split(",")
        if "sasrec" in phases or "gru4rec" in phases:
            cs.write_ml1m_shape(os.path.join(tmp, "data", "ml-1m-shape", "ml-1m-shape.inter"))
        for phase in phases:
            getattr(cs, f"phase_{phase}")(torch, tmp)


if __name__ == "__main__":
    main()
