"""Time the port's windowed embedding-gradient path and the training steps
that launch it, for one checkout of the repository, on one CUDA card.

    python scripts/torch_windowed_ab.py [TREE] [--kernels-only | --phases deepfm,lightgcn] [--probe]
    python scripts/torch_windowed_ab.py [TREE] --pairs N --against PARENT [--phases deepfm]

TREE (default: the checkout this script lies in) is the root of a checkout:
its ``recbole_tpu_torch`` and its ``chip_smoke.py`` phases are imported, the
timing tools are this checkout's ``chip_smoke.py`` (``time_windowed``), so
two checkouts are compared by running the script once for each, in turns
(A, B, B, A), on one machine. It prints, for ``windowed_grad_cuda`` at
DeepFM-Criteo's 9 large fields and at a LightGCN step's two tables (Yelp
shape, D 64):

* ``ms``: CUDA events over back-to-back calls;
* ``graph_ms``: the same calls captured in one CUDA graph and replayed, so
  the host's launch rate drops out;
* ``library_ms`` / ``library_graph_ms``: ``index_add_`` into zeros;
* ``host_ms``: the host's time to enqueue one call;
* ``stage_launches``: each kernel a call launches, with its count and device
  time per call (torch.profiler);

then the steady training step (wall, card busy share, launches, windowed
calls a step) of DeepFM at the Criteo width and of LightGCN at the Yelp
shape, as the tree's ``chip_smoke.py`` phases log them (``--phases`` picks
some of ``deepfm``, ``lightgcn``; ``--kernels-only`` none). ``--probe`` adds,
for the tree's kernel, CUDA-graph times and the stage split at the same
shapes with uniform ids, with R = 0 (the zero fill and the scan alone) and
R = 1, and at D 11 and 16, beside ``zero_()`` of the Criteo table. The
stages run under programmatic dependent launch, so the piece kernel's device
time holds the fill and its wait for the bucketing.

``--pairs N --against PARENT`` runs the phases' steps alone (no kernel
timing), in a process each, for PARENT and TREE in turns, N pairs with the
side that runs first alternating, and prints for each phase and each side
the steady step's wall ms (median and quartiles), the change's wins, and
the verdict: ``better`` or ``worse`` where one side wins at least nine
pairs in ten and the medians differ by more than the distance between the
parent's quartiles, else ``unresolved``. Exits non-zero without a card.
"""

import argparse
import importlib.util
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

STEP = re.compile(r"\[(\w+)\] steady step: ([0-9.]+) ms wall .*card busy ([0-9.]+) ms.*; "
                  r"([0-9.]+) kernel launches per step")


def probe(torch, tools, eg):
    """Where the windowed path's time goes: the same call on other ids."""
    def one(label, ids, g, n_rows):
        dest = torch.empty((n_rows, g.shape[-1]), device="cuda")

        def call():
            return eg.windowed_grad_cuda(ids, g, n_rows, out=dest)

        graph = tools.graph_ms(torch, call)
        stages = tools.kernels_per_call(torch, call)
        tools.log(f"[windowed-ab] probe {label}: graph_ms {graph:.4f}; stages (us): "
                  + ", ".join(f"{k} {v[1] * 1e3:.1f}" for k, v in stages.items()))

    rng = np.random.RandomState(0)
    _, items, lg = tools.lightgcn_grad_inputs(torch)
    n_items = tools.YELP[1] + 1
    one("items", items, lg, n_items)
    one("items, uniform ids", torch.from_numpy(rng.randint(0, n_items, 4096)).cuda(), lg,
        n_items)
    one("items, R=0", items[:0], lg[:0], n_items)
    one("items, R=1", items[:1], lg[:1], n_items)
    for D in (16, 11):
        one(f"items, D={D}", items, lg[:, :D].contiguous(), n_items)
    spec = tools.criteo_field_spec()
    n_large = sum(v > 16384 for _, v in spec)
    ids, g = tools.grad_inputs(torch, tools.CRITEO_BATCH, spec, tools.CRITEO_DIM, seed=8)
    n_rows = spec[n_large][0]
    big = ids[:, :n_large].reshape(-1).contiguous()
    big_g = g[:, :n_large].reshape(-1, tools.CRITEO_DIM).contiguous()
    one("criteo", big, big_g, n_rows)
    one("criteo, uniform ids", torch.from_numpy(rng.randint(0, n_rows, big.numel())).cuda(),
        big_g, n_rows)
    one("criteo, R=0", big[:0], big_g[:0], n_rows)
    one("criteo, R=1", big[:1], big_g[:1], n_rows)
    dest = torch.empty((n_rows, tools.CRITEO_DIM), device="cuda")
    tools.log(f"[windowed-ab] probe criteo zero_() alone: graph_ms "
              f"{tools.graph_ms(torch, dest.zero_):.4f}")


def pairs(tree, parent, n, phases):
    """N pairs of step-only runs of PARENT and TREE, in turns; a summary of
    the steady step's wall ms for each phase."""
    runs = {"parent": [], "change": []}
    for i in range(n):
        order = (("parent", parent), ("change", tree))
        for side, root in order if i % 2 == 0 else order[::-1]:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--steps-only",
                                  "--phases", phases], capture_output=True, text=True)
            steps = {m[1]: [float(m[2]), float(m[3]), float(m[4])]
                     for m in STEP.finditer(out.stdout)}
            print(f"[windowed-ab] pair {i} {side}: {steps}", flush=True)
            if out.returncode or not steps:
                sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
                raise SystemExit(f"torch_windowed_ab: the {side} run failed")
            runs[side].append(steps)
    for phase in phases.split(","):
        wall = {side: np.array([r[phase][0] for r in rs]) for side, rs in runs.items()}
        p25, p50, p75 = np.percentile(wall["parent"], [25, 50, 75])
        c25, c50, c75 = np.percentile(wall["change"], [25, 50, 75])
        wins = int((wall["change"] < wall["parent"]).sum())
        losses = int((wall["change"] > wall["parent"]).sum())
        gap = abs(c50 - p50) > p75 - p25
        verdict = ("better" if wins >= 0.9 * n and gap else
                   "worse" if losses >= 0.9 * n and gap else "unresolved")
        busy = {side: float(np.median([r[phase][1] for r in rs])) for side, rs in runs.items()}
        launches = {side: sorted({r[phase][2] for r in rs}) for side, rs in runs.items()}
        print(f"[windowed-ab] {phase} steady step ms wall, {n} pairs: parent median {p50} "
              f"(quartiles {p25}, {p75}), change median {c50} (quartiles {c25}, {c75}); the "
              f"change faster in {wins} pairs, slower in {losses}: {verdict}; card busy ms "
              f"median {busy}; launches a step {launches}", flush=True)


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--phases", default="deepfm,lightgcn")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--steps-only", action="store_true")
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--against")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    if args.pairs:
        if not args.against:
            raise SystemExit("torch_windowed_ab: --pairs needs --against PARENT")
        pairs(tree, os.path.abspath(args.against), args.pairs, args.phases)
        return
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_windowed_ab: needs a CUDA card")
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
    tools.log(f"[windowed-ab] tree {tree}; {smi.strip()}")
    cuda_build.build(["masked_topk", "embed_grad", "bit_kernels"])
    if not args.steps_only:
        tools.time_windowed(torch, eg, plain=False)
        if args.probe:
            probe(torch, tools, eg)
    if args.kernels_only:
        return
    with tempfile.TemporaryDirectory() as tmp:
        for phase in args.phases.split(","):
            getattr(cs, f"phase_{phase}")(torch, tmp)


if __name__ == "__main__":
    main()
