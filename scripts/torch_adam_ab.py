"""Time the port's Adam step and the steady training steps that run it, for
one checkout of the repository, on one CUDA card.

    python scripts/torch_adam_ab.py [TREE] [--kernels-only]

TREE (default: the checkout this script lies in) is the root of a checkout:
its ``recbole_tpu_torch`` is imported, so two checkouts are compared by
running the script once for each, in turns (A, B, B, A), on one machine.
The timing tools are this checkout's ``chip_smoke.py`` helpers, whatever the
tree. For each main path's leaf set (``chip_smoke.ADAM_SETS``: BPR's,
DeepFM-Criteo's, SASRec's 36 with the [PAD] row, LightGCN's) it times one
Adam step as the tree's trainer takes it: one ``adam_multi_cuda`` call where
the tree has it, else ``adam_leaf_triton`` leaf by leaf after the [PAD]-row
fill, over ``chip_smoke.adam_copies`` copies of the leaves in turn (so
that a step's leaves come from HBM, not from L2). It prints:

* ``ms``: CUDA events over back-to-back steps;
* ``graph_ms``: the same steps captured in one CUDA graph and replayed, so
  the host's launch rate drops out;
* ``host_ms``: the host's time to enqueue one step;
* ``library_ms`` / ``library_graph_ms``: ``torch.optim.Adam(fused=True)``'s
  step on the same leaves (``capturable=True`` in the graph);
* ``bound_ms``: the bytes the step must move over the card's rate;

then, unless ``--kernels-only``, the steady training step
(``chip_smoke.profile_steps``: 20 steps' wall, the card's busy time, kernel
launches a step, the top kernels) of BPR, DeepFM at the Criteo width, and
SASRec on the ml-1m-shaped file (the default ``"layer2"``, then
``fused_attention: True``). Exits non-zero without a card.
"""

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile


def adam_step(torch, fa, shapes, heads):
    """One Adam step over fresh leaves of ``shapes`` as the tree's trainer
    takes it, and the leaves (p, grads) for the library's step."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    p = [torch.randn(s, device="cuda", generator=gen) * 0.1 for s in shapes]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    grads = [torch.randn(s, device="cuda", generator=gen) * 1e-3 for s in shapes]
    kw = dict(b1=0.9, b2=0.999, lr=1e-3, eps=1e-8)
    if hasattr(fa, "adam_multi_cuda"):
        leaves = fa.AdamLeaves(p, m, v, heads)
        return (lambda: fa.adam_multi_cuda(leaves, grads, 10.0, 1000.0, **kw)), p, grads

    def per_leaf():
        for i, head in enumerate(heads):
            if head:
                grads[i][0] = 0.0
            fa.adam_leaf_triton(p[i], m[i], v[i], grads[i], 10.0, 1000.0, **kw)

    return per_leaf, p, grads


def time_sets(torch, tools, fa):
    for label, (shapes, heads) in tools.ADAM_SETS.items():
        copies = tools.adam_copies(shapes)
        made = [adam_step(torch, fa, shapes, heads) for _ in range(copies)]
        step = tools.rotating([s for s, _, _ in made])
        sets = [(p, grads) for _, p, grads in made]
        iters = 20 if label == "deepfm_criteo" else 200
        calls = copies * -(-20 // copies)
        n = sum(x.numel() for x in sets[0][0])
        t = {"ms": tools.cuda_ms(torch, step, iters),
             "graph_ms": tools.graph_ms(torch, step, calls),
             "host_ms": tools.host_ms(torch, step),
             "library_ms": tools.cuda_ms(torch, tools.adam_library(torch, sets), iters),
             "library_graph_ms": tools.graph_ms(
                 torch, tools.adam_library(torch, sets, capturable=True), calls)}
        t["bound_ms"], _ = tools.bound(14.0 * n, 28 * n - 4 * sum(heads))
        tools.log(f"[adam-ab] {label}: {len(shapes)} leaves, {n} elements, {copies} copies "
                  f"in turn: {t}")
        del step, sets, made
        torch.cuda.empty_cache()


def steady_bpr(tmp):
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    config = Config("BPR", "ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "device": "cuda",
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "WARNING", "show_progress": False},
        _parse_cmd_line=False)
    return config, data_preparation(config, create_dataset(config))[0]


def steady_deepfm(tools, tmp):
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import data_preparation
    config = Config("DeepFM", "criteo-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "device": "cuda",
        "USER_ID_FIELD": None, "ITEM_ID_FIELD": None, "LABEL_FIELD": "label",
        "TIME_FIELD": None, "train_batch_size": tools.CRITEO_BATCH,
        "checkpoint_dir": os.path.join(tmp, "saved"), "log_dir": os.path.join(tmp, "log"),
        "state": "WARNING", "show_progress": False}, _parse_cmd_line=False)
    return config, data_preparation(config, tools.synth_ctr_dataset(config, tools.CRITEO))[0]


def steady(torch, tools, tmp, phase):
    """The tree's trainer built for ``phase`` and 20 steady steps under the
    profiler (``chip_smoke.profile_steps``)."""
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    if phase == "bpr":
        config, train = steady_bpr(tmp)
    elif phase == "deepfm":
        config, train = steady_deepfm(tools, tmp)
    else:
        extra = {"fused_attention": True} if phase == "sasrec_attention" else {}
        train, _ = tools.seq_loaders(torch, tmp, "SASRec", {"state": "WARNING", **extra})
        config = train.config
    model = get_model(config["model"])(config, train.dataset)
    trainer = get_trainer(config["MODEL_TYPE"], config["model"])(config, model)
    trainer.prepare(train)
    tools.profile_steps(torch, trainer, train, phase)


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
        raise SystemExit("torch_adam_ab: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("smoke_tools", os.path.join(here, "chip_smoke.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import fused_adam as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout
    route = "adam_multi_cuda" if hasattr(fa, "adam_multi_cuda") else "adam_leaf_triton"
    tools.log(f"[adam-ab] tree {tree}; Adam by {route}; {smi.strip()}")
    csrc = [n[:-3] for n in os.listdir(os.path.join(tree, "recbole_tpu_torch", "csrc"))
            if n.endswith(".cu") and (n == "fused_adam.cu" or not args.kernels_only)]
    for line in cuda_build.build(csrc).get("fused_adam", "").splitlines():
        if "registers" in line or "spill" in line:
            tools.log(f"[adam-ab] ptxas: {line.strip()}")
    time_sets(torch, tools, fa)
    if args.kernels_only:
        return
    with tempfile.TemporaryDirectory() as tmp:
        tools.write_ml1m_shape(os.path.join(tmp, "data", "ml-1m-shape", "ml-1m-shape.inter"))
        for phase in ("bpr", "deepfm", "sasrec", "sasrec_attention"):
            steady(torch, tools, tmp, phase)


if __name__ == "__main__":
    main()
