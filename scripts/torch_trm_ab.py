"""Time the port's whole-layer transformer kernels, for one checkout of the
repository, on one CUDA card.

    python scripts/torch_trm_ab.py [TREE] [--sasrec]

TREE (default: the checkout this script lies in) is the root of a checkout:
its ``recbole_tpu_torch`` is imported, so two checkouts are compared by
running the script once for each, in turns (A, B, B, A), on one machine.
At SASRec's train step (B 2,048, L 50, D 64, H 2, I 256, causal, dropout
0.5; key lengths drawn from a seed) it prints, for the bf16 instance (the
kernel table's row 5) and the fp32 one (row 6), forward and backward:

* ``ms``: CUDA events over back-to-back calls (what chip_smoke.py reports);
* ``graph_ms``: the same calls captured in one CUDA graph and replayed, so
  the host's launch rate drops out;
* ``kernels``: each kernel a call launches, with its count and device time
  per call (torch.profiler);
* ``library_ms`` and ``library_bf16_ms``: nn.TransformerEncoderLayer at the
  same widths without dropout, in fp32 and under
  ``torch.autocast("cuda", dtype=torch.bfloat16)``: forward, and forward +
  backward beside the backward kernel (which recomputes the forward);
* each instance's worst relative error per tensor (y, dx and the 16
  gradients) against the plain version at that step, on the inputs
  chip_smoke.py's timing uses.

``--sasrec`` adds SASRec's steady train step
at the ml-1m shape, the tree's model and trainer at their defaults on an
ml-1m-shaped file written from a seed, once at its default compute dtype
(bf16: the bf16 instance) and once under ``compute_dtype: float32`` (the
fp32 instance): after 5 steps of warm-up, the wall time of 20 steps, then 20
more under torch.profiler: card-busy ms, launches and the longest kernels a
step. The timing tools are this checkout's chip_smoke.py helpers, whatever
the tree. Exits non-zero without a card.
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
    ap.add_argument("--sasrec", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_trm_ab: needs a CUDA card")
    tools = load_smoke(here, "smoke_tools")
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import trm_layer as tl
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tools.log(f"[trm-ab] tree {tree}; {smi}")
    cuda_build.build(["trm_layer"])
    B, L, D, H, I = (tools.SASREC[k] for k in "BLDHI")
    x, params, valid, dy = tools.trm_inputs(torch, B, L, D, H, I, seed=21)
    seed = torch.tensor([21], dtype=torch.int64, device="cuda")
    library = library_times(torch, tools, x, valid, dy, D, H, I, L)
    tools.log(f"[trm-ab] nn.TransformerEncoderLayer B={B} L={L} D={D} H={H} I={I}: "
              f"{json.dumps(library)}")
    for bf16, name in ((True, "trm_layer"), (False, "fused_transformer_layer")):
        kw = dict(n_heads=H, causal=True, act="gelu", dropout=0.5, attn_dropout=0.5, bf16=bf16)
        calls = {"fwd": lambda: tl.trm_layer_fwd_cuda(x, params, valid, seed, **kw),
                 "bwd": lambda: tl.trm_layer_bwd_cuda(x, params, valid, dy, seed, **kw)}
        blocks = [tl._lib().trm_layer_blocks(B, L, D, H, I, int(bf16), backward)
                  for backward in (0, 1)]
        for way, kernel in calls.items():
            t = {"ms": tools.cuda_ms(torch, kernel, 50),
                 "graph_ms": tools.graph_ms(torch, kernel, calls=10, replays=10),
                 "library_ms": library["fp32"][way], "library_bf16_ms": library["bf16"][way],
                 "blocks": blocks, "kernels": tools.kernels_per_call(torch, kernel, calls=10)}
            tools.log(f"[trm-ab] {name}_{way} B={B} L={L} D={D} H={H} I={I} causal, dropout "
                      f"0.5: {json.dumps(t)}")
        errs = tools.trm_rel_errors(torch, tl, x, params, valid, dy, seed, H, True, 0.5, bf16)
        tools.log(f"[trm-ab] {name} worst relative error per tensor: "
                  f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
    if args.sasrec:
        with tempfile.TemporaryDirectory() as tmp:
            tools.write_ml1m_shape(os.path.join(tmp, "data", "ml-1m-shape", "ml-1m-shape.inter"))
            for cdt in ("auto", "float32"):
                sasrec_step(torch, tools, tmp, cdt)


def library_times(torch, tools, x, valid, dy, D, H, I, L):
    """nn.TransformerEncoderLayer (gelu, post-LN, no dropout, causal with key
    padding) in fp32 and under bf16 autocast: forward, and forward +
    backward."""
    lib = torch.nn.TransformerEncoderLayer(D, H, I, dropout=0.0, activation="gelu",
                                           batch_first=True, device="cuda")
    lib.train()
    causal = torch.triu(torch.ones(L, L, dtype=torch.bool, device="cuda"), diagonal=1)
    pad = valid == 0
    xg = x.clone().requires_grad_(True)
    out = {}
    for kind, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        def ctx():
            return torch.autocast("cuda", dtype=dtype, enabled=dtype is not None)

        def fwd():
            with torch.no_grad(), ctx():
                return lib(x, src_mask=causal, src_key_padding_mask=pad)

        def fwd_bwd():
            for p in lib.parameters():
                p.grad = None
            xg.grad = None
            with ctx():
                y = lib(xg, src_mask=causal, src_key_padding_mask=pad)
            y.float().backward(dy)

        out[kind] = {"fwd": tools.cuda_ms(torch, fwd, 20), "bwd": tools.cuda_ms(torch, fwd_bwd, 20)}
    return out


def sasrec_step(torch, tools, tmp, cdt):
    """SASRec at its defaults on the ml-1m-shaped file under ``tmp``, at
    compute dtype ``cdt``: 20 steady steps timed, 20 under the profiler
    (chip_smoke.py's profile_steps)."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    from recbole_tpu_torch.utils.utils import init_seed
    config = Config("SASRec", "ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "epochs": 1, "device": "cuda",
        "compute_dtype": cdt,
        "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "show_progress": False}, _parse_cmd_line=False)
    init_seed(config["seed"], config["reproducibility"])
    train, _, _ = data_preparation(config, create_dataset(config))
    model = get_model("SASRec")(config, train.dataset)
    trainer = get_trainer(config["MODEL_TYPE"], "SASRec")(config, model)
    tools.log(f"[trm-ab] SASRec: fused_attention {config['fused_attention']!r}, compute dtype "
              f"{model.compute_dtype}, batch {train.batch_size}, {len(train)} steps an epoch")
    trainer.prepare(train)
    tools.profile_steps(torch, trainer, train, f"trm-ab sasrec {cdt}")


def load_smoke(root, name):
    """The chip_smoke.py of the checkout at ``root``, as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


if __name__ == "__main__":
    main()
