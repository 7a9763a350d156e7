"""Time the port's relation-apply kernels and the RippleNet step that launches
them, for one checkout of the repository, on one CUDA card.

    python scripts/torch_rel_ab.py [TREE] [--kernels-only]

TREE (default: the checkout this script lies in) is the root of a checkout:
its ``recbole_tpu_torch`` and its ``chip_smoke.py`` phases are imported, the
timing tools are this checkout's ``chip_smoke.py``, so two checkouts are
compared by running the script once for each, in turns (A, B, B, A), on one
machine. It prints, for ``rel_apply_fwd_cuda`` and ``rel_apply_bwd_cuda`` in
both instances at RippleNet's step (``chip_smoke.rel_inputs``, seed 61: N
131,072 rows, D 64, 53 relation ids, uniform):

* ``ms``: CUDA events over back-to-back calls; ``graph_ms``: the same calls
  captured in one CUDA graph and replayed, so the host's launch rate drops
  out; ``host_ms``: the host's enqueue a call;
* ``bound_ms`` at the instance's rate (fp32 FMA or bf16 tensor cores) and,
  for the fp32 instance, ``bound_3xtf32_ms`` at the 3xTF32 rate its kernels
  run at (a third of dense TF32); ``library_ms``: R gathered by rel, then
  ``torch.bmm`` (forward; forward + autograd backward beside the backward);
* ``err``: the largest |difference| from the plain version over the tensor's
  largest |value|, per output;
* ``kernels``: the kernels one call launches, with their device time
  (torch.profiler);

then the forward and backward through the autograd dispatcher
(``rel_apply``: the tree's backward, which may reuse the forward's buckets),
by events and with the kernels a step's pair launches; and RippleNet's steady
step at the ml-1m KG shape (wall, card busy, launches) as the tree's
``chip_smoke.phase_ripplenet`` logs it (``--kernels-only`` skips the step).
Exits non-zero without a card.
"""

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile


def rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def time_kernels(torch, tools, ra):
    N = 2 * tools.RIPPLENET["B"] * tools.RIPPLENET["hops"] * tools.RIPPLENET["M"]
    D, NR = tools.RIPPLENET["D"], tools.ML1M_KG[2] + 2
    v, rel, R, dy = tools.rel_inputs(torch, N, D, NR, 61)
    rel64 = rel.long()
    vg, Rg = v.clone().requires_grad_(True), R.clone().requires_grad_(True)

    def lib_fwd():
        return torch.bmm(R[rel64], v[:, :, None])[:, :, 0]

    def lib_bwd():
        vg.grad = Rg.grad = None
        torch.bmm(Rg[rel64], vg[:, :, None])[:, :, 0].backward(dy)

    lib = {"fwd": tools.cuda_ms(torch, lib_fwd, 20), "bwd": tools.cuda_ms(torch, lib_bwd, 20)}
    for bf16 in (False, True):
        name = "bf16" if bf16 else "fp32"
        ref = (ra.rel_apply_torch(v, rel, R, bf16), *ra.rel_apply_torch_bwd(v, rel, R, dy, bf16))
        got = (ra.rel_apply_fwd_cuda(v, rel, R, bf16=bf16),
               *ra.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16))
        torch.cuda.synchronize()
        errs = {k: rel_err(a, b) for k, a, b in zip(("y", "dv", "dR"), got, ref)}
        tools.log(f"[rel-ab] {name} err {errs}")
        calls = {"fwd": lambda: ra.rel_apply_fwd_cuda(v, rel, R, bf16=bf16),
                 "bwd": lambda: ra.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16)}
        for way, call in calls.items():
            flops = 2.0 * N * D * D * (2 if way == "bwd" else 1)
            nbytes = 4 * (N * D * (3 if way == "bwd" else 2) + N
                          + NR * D * D * (2 if way == "bwd" else 1))
            t = {"ms": tools.cuda_ms(torch, call, 50),
                 "graph_ms": tools.graph_ms(torch, call, calls=20, replays=10),
                 "host_ms": tools.host_ms(torch, call, 50), "library_ms": lib[way]}
            t["bound_ms"], t["bound_by"] = tools.bound(
                flops, nbytes, tools.PEAK_BF16_FLOPS if bf16 else tools.PEAK_FP32_FLOPS)
            if not bf16:
                t["bound_3xtf32_ms"], _ = tools.bound(flops, nbytes, tools.PEAK_TF32_FLOPS / 3)
            t["kernels"] = tools.kernels_per_call(torch, call)
            tools.log(f"[rel-ab] rel_apply_{way} {name} N={N} D={D} NR={NR} "
                      f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB): {t}")
        # the pair as autograd runs it in a training step
        vg2, Rg2 = v.clone().requires_grad_(True), R.clone().requires_grad_(True)

        def step():
            vg2.grad = Rg2.grad = None
            ra.rel_apply(vg2, rel, Rg2, bf16=bf16).backward(dy)

        t = {"ms": tools.cuda_ms(torch, step, 50), "host_ms": tools.host_ms(torch, step, 50),
             "kernels": tools.kernels_per_call(torch, step)}
        tools.log(f"[rel-ab] rel_apply autograd forward + backward {name}: {t}")


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
        raise SystemExit("torch_rel_ab: needs a CUDA card")
    spec = importlib.util.spec_from_file_location(
        "smoke_tools", os.path.join(here, "chip_smoke.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    import chip_smoke as cs
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops import rel_apply as ra
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    tools.log(f"[rel-ab] tree {tree}; {smi.strip()}")
    logs = cuda_build.build(["rel_apply", "fused_adam"])
    for line in logs["rel_apply"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            tools.log(f"[rel-ab] ptxas {line.strip()}")
    time_kernels(torch, tools, ra)
    if args.kernels_only:
        return
    cs.count_adam_steps()  # the phase holds Adam to one launch a step
    with tempfile.TemporaryDirectory() as tmp:
        cs.write_ml1m_shape(os.path.join(tmp, "data", "ml-1m-shape", "ml-1m-shape.inter"))
        cs.phase_ripplenet(torch, tmp)


if __name__ == "__main__":
    main()
