#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (recbole_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. device: the card's name, count, and nvidia-smi's name and power limit;
  2. build: nvcc builds the three csrc/*.cu, one process per source, all at
     once (its -Xptxas -v report is printed), and the Triton Adam kernel is
     launched once;
  3. each kernel against its plain PyTorch version, on the card, at the main
     paths' shapes and at edge shapes, and twice on the same input to
     compare the two results bit for bit; the whole-layer transformer
     kernels in both instances (bf16-rounded and fp32 operands), forward and
     backward, with dropout off and on (the plain version is handed the
     masks the kernels draw);
  4. the main paths, each with every kernel's launch count set to 0 just
     before and read just after (each kernel of the path must be > 0):
     a. run_recbole(model="BPR") for 2 epochs on an ml-1m-shaped dataset
        written from a seed;
     b. DeepFM at the full Criteo width (13 float + 26 token fields, a
        (2,565,692, 11) merged table, batch 2048, 2,292,530 rows from a
        seed) through Config -> data_preparation -> get_model ->
        get_trainer -> fit with validation -> evaluate(test), 2 epochs;
     c. run_recbole(model="SASRec") at its default widths (2 layers, 2
        heads, hidden 64, inner 256, 50 positions, dropout 0.5, CE) for 2
        epochs on the same ml-1m-shaped file under TO_LS,full, then 20
        steps under torch.profiler; and one epoch of the same model on
        ml-100k with fused_attention "layer" under compute_dtype float32,
        which goes through the fp32 instance of the transformer kernels;
  5. quality on the bundled ml-100k under PARITY.md's protocols: BPR's and
     SASRec's test recall@10 and DeepFM's test AUC, each held to a floor;
  6. timing with CUDA events at the main paths' shapes: kernel, plain
     version, the one-call library yardstick, and the card's bound for the
     same work.

It prints a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero. It
imports nothing of JAX or of the JAX package recbole_tpu.
"""

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, bf16 in them (dense), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# ml-1m's shape (users, items, interactions)
ML1M = (6040, 3706, 1_000_209)
# JAX package's ml-100k BPR test metrics on a TPU v5e (PARITY.md:18-24)
JAX_ML100K = {"recall@10": 0.2342, "mrr@10": 0.4522, "ndcg@10": 0.2805,
              "hit@10": 0.7582, "precision@10": 0.1951}
RECALL_FLOOR = 0.21

# the Criteo shape the JAX package benches (scripts/bench_ctr.py:44-52): rows,
# float fields, and the token vocabulary of each field (2,565,692 ids in all)
CRITEO = dict(
    n=2_292_530, n_float=13,
    vocabs=[1_200_000, 530_000, 310_000, 190_000, 120_000, 80_000, 50_000,
            30_000, 20_000, 12_000, 8_000, 5_000, 3_000, 2_000, 1_500,
            1_000, 800, 600, 500, 400, 300, 200, 150, 100, 80, 62])
CRITEO_BATCH, CRITEO_DIM = 2048, 11
# the leaves Adam sweeps in one DeepFM step at that shape: the merged table,
# float_embedding, float_weight, the 0-d first_order_bias, three MLP layers
# over 39 fields x 10, and the output layer
DEEPFM_LEAF_SHAPES = [(sum(CRITEO["vocabs"]), CRITEO_DIM), (13, 10), (13,), (), (390, 128),
                      (128,), (128, 128), (128,), (128, 128), (128,), (128, 1), (1,)]
# the distinct shapes among the 36 leaves Adam sweeps in one SASRec step at the
# ml-1m shape: item and position embeddings, the input LayerNorm, and per layer
# four (64, 64) projections, two FFN matrices, their biases and two LayerNorms
SASREC_LEAF_SHAPES = [(ML1M[1] + 1, 64), (50, 64), (64, 64), (64,), (64, 256), (256,),
                      (256, 64)]
# ml-100k under the CTR quick-start protocol (PARITY.md:72-91): DeepFM test
# AUC of the JAX package over 3 seeds 0.7811-0.7919, of the original RecBole
# 0.7781-0.7881
ML100K_CTR = {
    "threshold": {"rating": 4},
    "load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"],
                 "user": ["user_id", "age", "gender", "occupation"],
                 "item": ["item_id", "release_year", "class"]},
    "epochs": 50}
AUC_FLOOR = 0.77
# ml-100k SASRec under the TO_LS full-sort protocol of PARITY.md:124-152 (the
# "seq" preset of scripts/parity_head2head.py): the JAX package on a TPU, 3
# seeds, test recall@10 0.1304-0.1442, with its layer2 kernel 0.1326
ML100K_SEQ = {"eval_setting": "TO_LS,full", "training_neg_sample_num": 0,
              "load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"]},
              "epochs": 50}
SASREC_RECALL_FLOOR = 0.115

# masked_topk: the kernel's fp32 sums run in another order than cuBLAS's
TOPK_RTOL, TOPK_ATOL = 1e-5, 1e-6
# adam_leaf: rtol 1e-6 of each element, plus 1e-6 of the tensor's largest
# magnitude: the kernel contracts b*m + (1-b)*g into one FMA, and where the
# two terms cancel the result keeps an absolute error of an ulp of the terms
ADAM_RTOL = 1e-6
# embedding gradients: the kernels add a row's cotangents in fp32 in the
# order of r, index_add_ in the order its atomics land, so each element may
# differ by the rounding of its own terms: 1e-5 of the sum of their
# magnitudes, plus 1e-7
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7


def log(msg):
    print(msg, flush=True)


def bound(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(torch, fn, iters):
    """Mean milliseconds per call of ``fn`` over ``iters`` calls, by CUDA
    events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- inputs

def topk_inputs(torch, B, N, D, seed):
    """Queries and items at embedding scale, and a history mask drawn like
    the ml-1m-shaped data: ~3.6% of items per user, power-law popularity."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, D).astype(np.float32) * 0.1
    items = rng.randn(N, D).astype(np.float32) * 0.1
    mask = np.zeros((B, N), np.int8)
    mask[:, 0] = 1
    lens = rng.binomial(N, 0.036, size=B)
    rows = np.repeat(np.arange(B), lens)
    cols = 1 + np.floor((N - 1) * rng.random_sample(rows.size) ** 2.2).astype(np.int64)
    mask[rows, np.minimum(cols, N - 1)] = 1
    dev = torch.device("cuda")
    return (torch.from_numpy(q).to(dev), torch.from_numpy(items).to(dev),
            torch.from_numpy(mask).to(dev))


def adam_leaves(torch, shapes, seed):
    rng = np.random.RandomState(seed)
    out = []
    for shape in shapes:
        p = np.asarray(rng.standard_normal(shape) * 0.1, np.float32)
        grads = [np.asarray(rng.standard_normal(shape) * 1e-3, np.float32) for _ in range(3)]
        out.append((p, grads))
    return out


def criteo_field_spec():
    offs = np.concatenate([[0], np.cumsum(CRITEO["vocabs"])[:-1]])
    return tuple((int(o), int(v)) for o, v in zip(offs, CRITEO["vocabs"]))


def grad_inputs(torch, B, spec, D, seed):
    """One step's backward inputs as the main path gives them: (B, F) global
    ids drawn like the synthetic Criteo columns (cubic skew toward each
    field's first ids) and a (B, F, D) cotangent."""
    rng = np.random.RandomState(seed)
    ids = np.stack([off + 1 + np.floor((vocab - 2) * rng.random_sample(B) ** 3.0)
                    .astype(np.int64) for off, vocab in spec], axis=1)
    g = rng.randn(B, len(spec), D).astype(np.float32) * 1e-2
    dev = torch.device("cuda")
    return torch.from_numpy(ids).to(dev), torch.from_numpy(g).to(dev)


def seq_grad_inputs(torch, seed):
    """The backward of embed_seq in a SASRec step at the ml-1m shape: 2048 x
    50 item ids, power-law items, 15% of them [PAD] (id 0) as in the
    ml-1m-shaped train table, and their (R, 64) cotangent."""
    R, V, D = SASREC["B"] * SASREC["L"], ML1M[1] + 1, SASREC["D"]
    rng = np.random.RandomState(seed)
    ids = 1 + np.floor((V - 1) * rng.random_sample(R) ** 2.2).astype(np.int64)
    ids[rng.random_sample(R) < 0.15] = 0
    g = rng.randn(R, D).astype(np.float32) * 1e-2
    return torch.from_numpy(np.minimum(ids, V - 1)).cuda(), torch.from_numpy(g).cuda()


def synth_ctr_columns(shape, seed=42):
    """Post-remap columns of a pure-feature CTR dataset (the draw of
    scripts/bench_ctr.py's _synth_columns): a 25%-positive label, uniform
    floats, and power-law token ids in 1..vocab-1 (0 is [PAD])."""
    rng = np.random.RandomState(seed)
    n = shape["n"]
    cols = {"label": (rng.random_sample(n) < 0.25).astype(np.float32)}
    for j in range(shape["n_float"]):
        cols[f"I{j + 1}"] = rng.random_sample(n).astype(np.float32)
    for j, vocab in enumerate(shape["vocabs"]):
        r = rng.random_sample(n)
        cols[f"C{j + 1}"] = (1 + np.floor((vocab - 2) * r ** 3.0)).astype(np.int32)
    return cols


def synth_ctr_dataset(config, shape, seed=42):
    """The port's Dataset filled with those columns directly: no atomic-file
    round trip at millions of rows."""
    from recbole_tpu_torch.data.dataset import Dataset
    from recbole_tpu_torch.utils.enums import FeatureSource, FeatureType
    ds = Dataset(config, _build=False)
    ds.inter_feat = synth_ctr_columns(shape, seed)
    for field in ds.inter_feat:
        ds.field2type[field] = (FeatureType.TOKEN if field.startswith("C")
                                else FeatureType.FLOAT)
        ds.field2source[field] = FeatureSource.INTERACTION
    for j, vocab in enumerate(shape["vocabs"]):
        # a stand-in vocabulary: its length drives num()
        ds.field2id_token[f"C{j + 1}"] = np.arange(vocab)
        ds.field2token_id[f"C{j + 1}"] = {}
    return ds


def write_ml1m_shape(path, seed=42):
    """An atomic .inter file of ml-1m's shape: uniform users, power-law
    items (the draw of bench.py's synth_ml1m)."""
    n_users, n_items, n_inter = ML1M
    rng = np.random.RandomState(seed)
    uids = rng.randint(1, n_users + 1, size=n_inter)
    iids = 1 + np.floor((n_items - 1) * rng.random_sample(n_inter) ** 2.2).astype(np.int64)
    ts = np.arange(n_inter)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("user_id:token\titem_id:token\ttimestamp:float\n")
        np.savetxt(fh, np.stack([uids, iids, ts], axis=1), fmt="%d", delimiter="\t")


# ----------------------------------------------------------------- phases

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs on a GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return name, count, smi


def phase_build(torch):
    from recbole_tpu_torch.ops import cuda_build
    from recbole_tpu_torch.ops.fused_adam import adam_leaf_triton
    t0 = time.time()
    logs = cuda_build.build(["masked_topk", "embed_grad", "trm_layer"])
    log(f"[build] nvcc {time.time() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            log(f"[build] {name}: {line.strip()}")
    t0 = time.time()
    x = torch.zeros(4096, device="cuda")
    adam_leaf_triton(x, x.clone(), x.clone(), x.clone(), 1.0, 1.0,
                     b1=0.9, b2=0.999, lr=1e-3, eps=1e-8)
    torch.cuda.synchronize()
    log(f"[build] triton adam_leaf first launch {time.time() - t0:.1f}s")


def check_topk(torch, B, N, D, k, seed, pad_only=False):
    """``pad_only``: the mask a sequential full-sort pass gives, column 0
    ([PAD]) set and nothing else, in place of a user's history."""
    from recbole_tpu_torch.ops.masked_topk import masked_topk_cuda, masked_topk_torch
    q, items, mask = topk_inputs(torch, B, N, D, seed)
    if pad_only:
        mask.zero_()
        mask[:, 0] = 1
    kv, ki = masked_topk_cuda(q, items, mask, k)
    torch.cuda.synchronize()
    pv, pi = masked_topk_torch(q, items, mask, k)
    scores = torch.where(mask > 0, torch.full((), -1e15, device="cuda"), q @ items.T)
    kv, ki, pv, pi = kv.cpu(), ki.cpu().long(), pv.cpu(), pi.cpu().long()
    scores = scores.cpu()
    tol = TOPK_ATOL + TOPK_RTOL * pv.abs()
    if not bool(((kv - pv).abs() <= tol).all()):
        raise AssertionError(f"masked_topk values differ at B={B} N={N}: max "
                             f"{float((kv - pv).abs().max())}")
    # the kernel's values are the plain scores of the ids it returns
    own = torch.gather(scores, 1, ki)
    if not bool(((own - kv).abs() <= TOPK_ATOL + TOPK_RTOL * own.abs()).all()):
        raise AssertionError("masked_topk returned values that are not its ids' scores")
    diff = ki != pi
    swaps = int(diff.sum())
    if swaps:
        a = torch.gather(scores, 1, ki)[diff]
        b = torch.gather(scores, 1, pi)[diff]
        if not bool(((a - b).abs() <= TOPK_ATOL + TOPK_RTOL * b.abs()).all()):
            raise AssertionError("masked_topk ids differ beyond near-tie swaps")
    if bool(torch.gather(mask.cpu(), 1, ki).any()):
        raise AssertionError("masked_topk returned a masked item")
    err = float((kv - pv).abs().max())
    log(f"[check] masked_topk B={B} N={N} D={D} k={k}{' only [PAD] masked' if pad_only else ''}: "
        f"max|err| {err:.3e}, "
        f"near-tie id swaps {swaps} of {B * k}")
    return err


def check_adam(torch, shapes, seed):
    from recbole_tpu_torch.ops.fused_adam import adam_leaf_triton, adam_leaf_torch
    err = 0.0
    for p0, grads in adam_leaves(torch, shapes, seed):
        state = {}
        for name in ("kernel", "plain"):
            p = torch.from_numpy(p0).cuda()
            m, v = torch.zeros_like(p), torch.zeros_like(p)
            fn = adam_leaf_triton if name == "kernel" else adam_leaf_torch
            for t, g in enumerate(grads, start=1):
                c1, c2 = 1.0 / (1.0 - 0.9 ** t), 1.0 / (1.0 - 0.999 ** t)
                fn(p, m, v, torch.from_numpy(g).cuda(), c1, c2,
                   b1=0.9, b2=0.999, lr=1e-3, eps=1e-8)
            torch.cuda.synchronize()
            state[name] = (p.cpu(), m.cpu(), v.cpu())
        for a, b in zip(state["kernel"], state["plain"]):
            tol = ADAM_RTOL * (b.abs() + b.abs().max())
            if not bool(((a - b).abs() <= tol).all()):
                raise AssertionError(f"adam_leaf differs at {p0.shape}: max "
                                     f"{float((a - b).abs().max())}")
            err = max(err, float((a - b).abs().max()))
    log(f"[check] adam_leaf {len(shapes)} leaves, {shapes[0]} to {shapes[-1]}, x3 steps: "
        f"max|err| {err:.3e}")
    return err


def _grad_agrees(torch, out, ref, ids, g, n_rows, id_base, what):
    """max|out - ref|, held to GRAD_RTOL * sum|g| + GRAD_ATOL elementwise."""
    scale = torch.zeros_like(ref).index_add_(
        0, ids.reshape(-1) - id_base, g.reshape(-1, g.shape[-1]).abs().float())
    diff = (out - ref).abs()
    if not bool((diff <= GRAD_RTOL * scale + GRAD_ATOL).all()):
        raise AssertionError(f"{what}: max|err| {float(diff.max())} beyond "
                             f"{GRAD_RTOL} * sum|g| + {GRAD_ATOL}")
    return float(diff.max())


def check_embed_grad(torch, name, cases):
    """One of the two embedding-gradient kernels against its plain version
    on each (label, ids, g, n_rows, id_base) case, and a second run of the
    kernel on the same input compared bit for bit."""
    from recbole_tpu_torch.ops import embed_grad as eg
    kernel = getattr(eg, f"{name}_cuda")
    plain = getattr(eg, f"{name}_torch")
    worst = 0.0
    for label, ids, g, n_rows, id_base, *hint in cases:
        kw = {"id_base": id_base, **(hint[0] if hint else {})}
        out = kernel(ids, g, n_rows, **kw)
        torch.cuda.synchronize()
        again = kernel(ids, g, n_rows, **kw)
        ref = plain(ids, g, n_rows, id_base=id_base)
        err = _grad_agrees(torch, out, ref, ids, g, n_rows, id_base, f"{name} {label}")
        same = bool(torch.equal(out, again))
        log(f"[check] {name} {label}: R={ids.numel()} n_rows={n_rows} "
            f"D={g.shape[-1]} max|err| {err:.3e} (tolerance {GRAD_RTOL} * sum|g| + "
            f"{GRAD_ATOL}); two runs bit-identical: {same}")
        if not same:
            raise AssertionError(f"{name} {label}: two runs differ, the kernel "
                                 "is meant to be deterministic")
        worst = max(worst, err)
    return worst


def embed_grad_cases(torch):
    """The main paths' shapes and the edge shapes, for both kernels."""
    spec = criteo_field_spec()
    n_large = sum(v > 16384 for _, v in spec)
    ids, g = grad_inputs(torch, CRITEO_BATCH, spec, CRITEO_DIM, seed=5)
    small_off, small_rows = spec[n_large][0], sum(v for _, v in spec[n_large:])
    large_rows = spec[n_large][0]
    # ml-100k under the CTR protocol: user_id, item_id, age, gender,
    # occupation, release_year, all small
    ml = tuple(zip(np.concatenate([[0], np.cumsum([944, 1683, 62, 3, 22, 73])[:-1]]).tolist(),
                   [944, 1683, 62, 3, 22, 73]))
    ml_ids, ml_g = grad_inputs(torch, CRITEO_BATCH, ml, CRITEO_DIM, seed=6)
    flat_ids = ids[:, n_large:].reshape(-1).contiguous()
    flat_g = g[:, n_large:].reshape(-1, CRITEO_DIM).contiguous()
    col_off = torch.tensor([o for o, _ in spec[n_large:]] + [spec[-1][0] + spec[-1][1]],
                           device="cuda")
    ml_off = torch.tensor([o for o, _ in ml] + [ml[-1][0] + ml[-1][1]], device="cuda")
    onehot = [
        ("criteo small fields, (B, 17) block in place", ids[:, n_large:], g[:, n_large:],
         small_rows, small_off),
        ("criteo small fields, block in place with column ranges", ids[:, n_large:],
         g[:, n_large:], small_rows, small_off, {"col_off": col_off}),
        ("ml-100k fields with column ranges", ml_ids, ml_g, sum(v for _, v in ml), 0,
         {"col_off": ml_off}),
        ("criteo small fields, contiguous", flat_ids, flat_g, small_rows, small_off),
        ("ml-100k fields", ml_ids, ml_g, sum(v for _, v in ml), 0),
        ("D=1", flat_ids, flat_g[:, :1].contiguous(), small_rows, small_off),
        ("R=1", flat_ids[:1], flat_g[:1], small_rows, small_off),
        ("every id equal", torch.full_like(flat_ids, small_off + 7), flat_g, small_rows,
         small_off),
        ("bf16 cotangent", flat_ids, flat_g.to(torch.bfloat16), small_rows, small_off),
        ("SASRec step, ids cut into slices", *seq_grad_inputs(torch, seed=12), ML1M[1] + 1, 0),
        ("SASRec step, every id [PAD]", torch.zeros(SASREC["B"] * SASREC["L"], dtype=torch.int64,
                                                     device="cuda"),
         seq_grad_inputs(torch, seed=13)[1], ML1M[1] + 1, 0),
    ]
    big_ids = ids[:, :n_large].reshape(-1).contiguous()
    big_g = g[:, :n_large].reshape(-1, CRITEO_DIM).contiguous()
    windowed = [
        ("criteo large fields, (B, 9) block in place", ids[:, :n_large], g[:, :n_large],
         large_rows, 0),
        ("criteo large fields, contiguous", big_ids, big_g, large_rows, 0),
        ("every id equal", torch.full_like(big_ids, 1_234_567), big_g, large_rows, 0),
        ("D=1", big_ids, big_g[:, :1].contiguous(), large_rows, 0),
        ("R=1", big_ids[:1], big_g[:1], large_rows, 0),
    ]
    return {"onehot_matmul_grad": onehot, "windowed_grad": windowed}


# whole-layer transformer kernels against the plain version, as the largest
# |difference| of a tensor over its largest |value|. fp32 instance: the same
# fp32 arithmetic in another order (sums over up to 102,400 rows, erff and
# expf against the library's). bf16 instance: both round the same operands at
# the same places, but an fp32 sum that lands on the other side of a rounding
# boundary moves an operand by one bf16 step (2^-8 of its value), and the
# layer chains a dozen such products. A parameter gradient whose true value
# is 0 is measured against a hundredth of the layer's largest gradient
TRM_TOL = {False: 2e-4, True: 1e-2}
# SASRec's default widths (sasrec.py:25-29) at the train batch
SASREC = dict(B=2048, L=50, D=64, H=2, I=256)


def trm_inputs(torch, B, L, D, H, I, seed, empty_row=False):
    """x, 16 parameters (all of them away from their initial zeros and
    ones), key validity from random lengths, and a cotangent."""
    from recbole_tpu_torch.ops.trm_layer import param_shapes
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    params = {}
    for k, shape in param_shapes(D, I).items():
        if len(shape) == 2:
            lim = np.sqrt(6.0 / sum(shape))
            v = rng.uniform(-lim, lim, shape)
        elif k.endswith("_g"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        params[k] = torch.from_numpy(v.astype(np.float32)).to(dev)
    x = torch.from_numpy((0.5 * rng.randn(B, L, D)).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.randn(B, L, D).astype(np.float32)).to(dev)
    lens = rng.randint(1, L + 1, B)
    if empty_row:
        lens[0] = 0
    valid = torch.from_numpy((np.arange(L)[None, :] < lens[:, None]).astype(np.int32)).to(dev)
    return x, params, valid, dy


def trm_cases():
    """(label, shape, causal, act, bf16, dropout, empty_row, backward). The
    SASRec run's own batches are among them: 2,048 and the ragged last 1,097
    in training, 4,096 and the ragged last 1,944 in a full-sort pass (forward
    only, no dropout)."""
    small = dict(B=1, L=8, D=16, H=2, I=32)
    cases = []
    for bf16 in (True, False):
        for causal in (True, False):
            for rate in (0.0, 0.5):
                cases.append(("SASRec shape", SASREC, causal, "gelu", bf16, rate, not causal))
        for act in ("relu", "swish", "tanh", "sigmoid"):
            cases.append(("B=7", dict(SASREC, B=7), True, act, bf16, 0.5, False))
        cases.append(("B=1 L=8", small, False, "gelu", bf16, 0.0, True))
        cases.append(("B=7 L=8", dict(small, B=7), True, "gelu", bf16, 0.5, False))
        cases.append(("B=1 L=50", dict(SASREC, B=1), True, "gelu", bf16, 0.5, False))
        cases.append(("ragged B=1001, I=384", dict(SASREC, B=1001, I=384), False, "gelu", bf16,
                      0.5, True))
        cases.append(("last train batch", dict(SASREC, B=1097), True, "gelu", bf16, 0.5, False))
    cases = [(*c, True) for c in cases]
    for bf16 in (True, False):
        cases.append(("eval batch", dict(SASREC, B=4096), True, "gelu", bf16, 0.0, False, False))
        cases.append(("last eval batch", dict(SASREC, B=1944), True, "gelu", bf16, 0.0, False,
                      False))
    return cases


def check_keep_rate(mask, rate, what):
    """A keep mask holds 0 and 1 / (1 - rate) only, and keeps a share within
    4 sigma of 1 - rate."""
    n = mask.numel()
    kept = int((mask > 0).sum())
    inv = 1.0 / (1.0 - rate)
    if not bool(((mask == 0) | ((mask - inv).abs() < 1e-6)).all()):
        raise AssertionError(f"{what}: values other than 0 and {inv}")
    sigma = (rate * (1.0 - rate) / n) ** 0.5
    if abs(kept / n - (1.0 - rate)) > 4 * sigma + 1e-12:
        raise AssertionError(f"{what}: kept {kept / n:.5f} of {n}, expected {1 - rate} "
                             f"+- {4 * sigma:.5f}")
    return kept / n


def check_trm_layer(torch):
    """trm_layer_fwd / trm_layer_bwd against the plain version on the card:
    y, dx and the 16 parameter gradients, both instances, with the dropout
    masks the kernels draw handed to the plain version; and two runs of the
    kernels compared bit for bit."""
    from recbole_tpu_torch.ops import trm_layer as tl
    worst = {f"{name}_{way}": 0.0 for name in ("trm_layer", "fused_transformer_layer")
             for way in ("fwd", "bwd")}
    for n, (label, shape, causal, act, bf16, rate, empty_row, backward) in enumerate(trm_cases()):
        B, L, D, H, I = (shape[k] for k in "BLDHI")
        x, params, valid, dy = trm_inputs(torch, B, L, D, H, I, seed=100 + n,
                                          empty_row=empty_row)
        seed = torch.tensor([0x1234567 + 77 * n], dtype=torch.int64, device="cuda")
        kw = dict(n_heads=H, causal=causal, act=act, eps=1e-12, dropout=rate,
                  attn_dropout=rate, layer=n % 3, bf16=bf16)

        def run():
            out = {"y": tl.trm_layer_fwd_cuda(x, params, valid, seed, **kw)}
            if backward:
                out["dx"], g = tl.trm_layer_bwd_cuda(x, params, valid, dy, seed, **kw)
                out.update(g)
            torch.cuda.synchronize()
            return out

        got, again = run(), run()
        same = all(torch.equal(got[k], again[k]) for k in got)
        masks, kept = None, ""
        if rate > 0.0:
            masks = tl.trm_dropout_masks_cuda(seed, B, H, L, D, rate, rate, layer=n % 3)
            kept = " kept " + "/".join(
                f"{check_keep_rate(masks[k], rate, f'{label} {k} mask'):.4f}"
                for k in ("attn", "attn_out", "ffn"))
            other = tl.trm_dropout_masks_cuda(seed, B, H, L, D, rate, rate, layer=n % 3 + 1)
            if bool(torch.equal(other["ffn"], masks["ffn"])):
                raise AssertionError("two layers drew the same dropout mask")
        cfg = (H, causal, act, 1e-12, bf16)
        ref = {"y": tl.trm_layer_torch_fwd(x, params, valid, masks, *cfg)}
        # a gradient that is 0 but for rounding (bk: the softmax does not see
        # a key bias) is held to a hundredth of the largest gradient instead
        floor = 1e-30
        if backward:
            ref["dx"], ref_g = tl.trm_layer_torch_bwd(x, params, valid, masks, dy, *cfg)
            ref.update(ref_g)
            floor = 1e-2 * max(float(v.abs().max()) for v in ref_g.values())

        def rel(k):
            least = 1e-30 if k in ("y", "dx") else floor
            return float((got[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), least)

        errs = {k: rel(k) for k in got}
        e_fwd = errs.pop("y")
        e_bwd = max(errs.values(), default=0.0)
        tol = TRM_TOL[bf16]
        detail = (f"dx {errs['dx']:.3e}, worst gradient {max(errs, key=errs.get)} {e_bwd:.3e}"
                  if backward else "forward only")
        log(f"[check] trm_layer {'bf16' if bf16 else 'fp32'} ({label}) B={B} L={L} D={D} H={H} "
            f"I={I} causal={causal} act={act} dropout={rate} empty_row={empty_row}: "
            f"y {e_fwd:.3e}, {detail} (tolerance {tol} of the tensor's "
            f"largest value){kept}; two runs bit-identical: {same}")
        if not all(bool(torch.isfinite(got[k]).all()) for k in ("y", "dx") if k in got):
            raise AssertionError(f"trm_layer {label}: non-finite output")
        if e_fwd > tol or e_bwd > tol:
            raise AssertionError(f"trm_layer {label}: beyond tolerance {tol}: y {e_fwd}, {errs}")
        if not same:
            raise AssertionError(f"trm_layer {label}: two runs differ, the kernels are "
                                 "meant to be deterministic")
        name = "trm_layer" if bf16 else "fused_transformer_layer"
        worst[f"{name}_fwd"] = max(worst[f"{name}_fwd"],
                                   float((got["y"] - ref["y"]).abs().max()))
        worst[f"{name}_bwd"] = max([worst[f"{name}_bwd"],
                                    *(float((got[k] - ref[k]).abs().max()) for k in errs)])
    return worst


def capture_epoch_times():
    """Collect the trainer's own epoch and evaluation timings from its log
    records (a logger filter survives init_logger's handler reset)."""
    times = {"train": [], "eval": []}

    class Grab(logging.Filter):
        def filter(self, record):
            msg = record.msg if isinstance(record.msg, str) else ""
            if msg.startswith("epoch %d training"):
                times["train"].append(record.args[1])
            elif msg.startswith("epoch %d evaluating"):
                times["eval"].append(record.args[1])
            return True

    logger = logging.getLogger("recbole_tpu_torch")
    grab = Grab()
    logger.addFilter(grab)
    return times, lambda: logger.removeFilter(grab)


def check_result(result, keys):
    for split in ("best_valid_result", "test_result"):
        vals = result[split]
        if set(vals) != set(keys) or not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"bad {split}: {vals}")


def kernel_wrappers():
    from recbole_tpu_torch.ops import embed_grad as eg
    from recbole_tpu_torch.ops import trm_layer as tl
    from recbole_tpu_torch.ops.fused_adam import adam_leaf_triton
    from recbole_tpu_torch.ops.masked_topk import masked_topk_cuda
    return {"masked_topk": masked_topk_cuda, "adam_leaf": adam_leaf_triton,
            "onehot_matmul_grad": eg.onehot_matmul_grad_cuda,
            "windowed_grad": eg.windowed_grad_cuda,
            "trm_layer_fwd": tl.trm_layer_fwd_cuda, "trm_layer_bwd": tl.trm_layer_bwd_cuda}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_fp32"):
            fn.launches_fp32 = 0


def read_launches(path, must_launch):
    """The wrappers' counts; the transformer wrappers count both instances,
    told apart here: trm_layer_* is the bf16 instance's share,
    fused_transformer_layer_* the fp32 instance's."""
    launches = {}
    for name, fn in kernel_wrappers().items():
        launches[name] = fn.launches - getattr(fn, "launches_fp32", 0)
        if hasattr(fn, "launches_fp32"):
            launches[name.replace("trm_layer", "fused_transformer_layer")] = fn.launches_fp32
    log(f"[{path}] launches {launches}")
    never = [name for name in must_launch if launches[name] <= 0]
    if never:
        raise AssertionError(f"kernels of the {path} path never launched: {never}")
    return launches


def phase_bpr(torch, tmp):
    from recbole_tpu_torch import run_recbole
    t0 = time.time()
    write_ml1m_shape(os.path.join(tmp, "data", "ml-1m-shape", "ml-1m-shape.inter"))
    log(f"[bpr] wrote the ml-1m-shaped .inter in {time.time() - t0:.1f}s")
    times, release = capture_epoch_times()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    result = run_recbole(model="BPR", dataset="ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "epochs": 2,
        "valid_full_to_uni1000": False, "device": "cuda",
        "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO",
        "show_progress": False})
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches("bpr", ("masked_topk", "adam_leaf"))
    release()
    log(f"[bpr] run_recbole BPR ml-1m-shape 2 epochs: {wall:.2f}s wall")
    log(f"[bpr] result {json.dumps(result)}")
    check_result(result, JAX_ML100K)
    n_train = round(ML1M[2] * 0.8)
    log(f"[bpr] epoch seconds {times['train']} (epoch 0 includes the upload); "
        f"train examples/s (epoch 1): {n_train / times['train'][-1]:.1f}")
    log(f"[bpr] full-sort valid eval seconds {times['eval']}")
    log(f"[bpr] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return launches


def phase_deepfm(torch, tmp):
    """DeepFM at the full Criteo width through the normal entry points, cut
    to 2 epochs. The labels are random at this shape, so AUC is about 0.5
    and only its finiteness is checked."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    config = Config("DeepFM", "criteo-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "epochs": 2, "device": "cuda",
        "USER_ID_FIELD": None, "ITEM_ID_FIELD": None, "LABEL_FIELD": "label",
        "TIME_FIELD": None, "train_batch_size": CRITEO_BATCH,
        "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO",
        "show_progress": False}, _parse_cmd_line=False)
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    t0 = time.time()
    dataset = synth_ctr_dataset(config, CRITEO)
    train, valid, test = data_preparation(config, dataset)
    log(f"[deepfm] criteo-shaped dataset and splits in {time.time() - t0:.1f}s: "
        f"train {train.n} valid {valid.n} test {test.n} rows")
    model = get_model("DeepFM")(config, train.dataset)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    log(f"[deepfm] parameters {shapes}")
    if shapes["token_embedding"] != (sum(CRITEO["vocabs"]), CRITEO_DIM) \
            or model.num_fields != 39:
        raise AssertionError("DeepFM was not built at the full Criteo width")
    trainer = get_trainer(config["MODEL_TYPE"], "DeepFM")(config, model)
    times, release = capture_epoch_times()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    best_score, best_valid = trainer.fit(train, valid, saved=False)
    test_result = trainer.evaluate(test, load_best_model=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches("deepfm", ("adam_leaf", "onehot_matmul_grad", "windowed_grad"))
    release()
    result = {"best_valid_result": best_valid, "test_result": test_result}
    log(f"[deepfm] fit (2 epochs, validation each) + test: {wall:.2f}s wall")
    log(f"[deepfm] result {json.dumps(result)}")
    check_result(result, ("auc", "logloss"))
    steps = 2 * len(train)
    log(f"[deepfm] {steps} steps; launches per step: adam_leaf "
        f"{launches['adam_leaf'] / steps:.2f}, onehot_matmul_grad "
        f"{launches['onehot_matmul_grad'] / steps:.2f}, windowed_grad "
        f"{launches['windowed_grad'] / steps:.2f}")
    log(f"[deepfm] epoch seconds {times['train']} (epoch 0 includes the upload); "
        f"train examples/s (epoch 1): {train.n / times['train'][-1]:.1f}; "
        f"ms/step (epoch 1): {1e3 * times['train'][-1] / len(train):.3f}")
    log(f"[deepfm] value-metric valid pass seconds {times['eval']}")
    log(f"[deepfm] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(torch, trainer, train, "deepfm")
    return launches


def phase_sasrec(torch, tmp):
    """SASRec at its default widths on the ml-1m-shaped file (written by
    phase_bpr, with timestamps), TO_LS,full, cut to 2 epochs; then 20 steady
    steps under the profiler."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    config = Config("SASRec", "ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "epochs": 2, "device": "cuda",
        "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False},
        _parse_cmd_line=False)
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    t0 = time.time()
    train, valid, test = data_preparation(config, create_dataset(config))
    log(f"[sasrec] dataset, TO_LS splits and loaders in {time.time() - t0:.1f}s: train "
        f"{train.n} valid {valid.n} test {test.n} examples, eval batch {valid.batch_size}")
    model = get_model("SASRec")(config, train.dataset)
    widths = {k: config[k] for k in ("n_layers", "n_heads", "hidden_size", "inner_size",
                                     "MAX_ITEM_LIST_LENGTH", "hidden_dropout_prob",
                                     "attn_dropout_prob", "hidden_act", "loss_type",
                                     "fused_attention", "train_batch_size")}
    log(f"[sasrec] widths {widths}; compute dtype {model.compute_dtype}; "
        f"{sum(p.numel() for p in model.parameters())} parameters in "
        f"{len(list(model.parameters()))} leaves")
    if (widths["n_layers"], widths["n_heads"], widths["hidden_size"], widths["inner_size"],
            widths["MAX_ITEM_LIST_LENGTH"], widths["train_batch_size"]) != (2, 2, 64, 256, 50, 2048) \
            or model.cdt != torch.bfloat16 or widths["fused_attention"] != "layer2":
        raise AssertionError("SASRec was not built at its default widths")
    trainer = get_trainer(config["MODEL_TYPE"], "SASRec")(config, model)
    times, release = capture_epoch_times()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    best_score, best_valid = trainer.fit(train, valid, saved=False)
    test_result = trainer.evaluate(test, load_best_model=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches("sasrec", ("trm_layer_fwd", "trm_layer_bwd", "onehot_matmul_grad",
                                        "adam_leaf", "masked_topk"))
    release()
    if launches["windowed_grad"] or launches["fused_transformer_layer_fwd"]:
        raise AssertionError(f"kernels off the SASRec path were launched: {launches}")
    result = {"best_valid_result": best_valid, "test_result": test_result}
    log(f"[sasrec] fit (2 epochs, validation each) + test: {wall:.2f}s wall")
    log(f"[sasrec] result {json.dumps(result)}")
    check_result(result, JAX_ML100K)
    steps = 2 * len(train)
    log(f"[sasrec] {steps} steps; launches per step: trm_layer_bwd "
        f"{launches['trm_layer_bwd'] / steps:.2f}, onehot_matmul_grad "
        f"{launches['onehot_matmul_grad'] / steps:.2f}, adam_leaf "
        f"{launches['adam_leaf'] / steps:.2f}; trm_layer_fwd {launches['trm_layer_fwd']} = "
        f"2 a step + 2 an eval batch")
    log(f"[sasrec] epoch seconds {times['train']} (epoch 0 includes the upload); "
        f"train examples/s (epoch 1): {train.n / times['train'][-1]:.1f}; "
        f"ms/step (epoch 1): {1e3 * times['train'][-1] / len(train):.3f}")
    log(f"[sasrec] full-sort valid pass seconds {times['eval']}")
    log(f"[sasrec] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(torch, trainer, train, "sasrec")
    return launches


def phase_sasrec_fp32(torch, tmp):
    """One epoch of SASRec on ml-100k with fused_attention "layer" under
    compute_dtype float32: the path through the fp32 instance."""
    from recbole_tpu_torch import run_recbole
    reset_launches()
    t0 = time.time()
    result = run_recbole(model="SASRec", dataset="ml-100k", config_dict={
        **ML100K_SEQ, "epochs": 1, "fused_attention": "layer", "compute_dtype": "float32",
        "valid_full_to_uni1000": False, "device": "cuda",
        "checkpoint_dir": os.path.join(tmp, "saved100k"),
        "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING", "show_progress": False})
    torch.cuda.synchronize()
    launches = read_launches("sasrec_fp32", ("fused_transformer_layer_fwd",
                                             "fused_transformer_layer_bwd",
                                             "onehot_matmul_grad", "adam_leaf", "masked_topk"))
    if launches["trm_layer_fwd"] or launches["trm_layer_bwd"]:
        raise AssertionError(f"the bf16 instance ran under compute_dtype float32: {launches}")
    log(f"[sasrec_fp32] ml-100k, 1 epoch, fused_attention layer, float32: "
        f"{time.time() - t0:.1f}s; test {json.dumps(result['test_result'])}")
    check_result(result, JAX_ML100K)
    return launches


def profile_steps(torch, trainer, train, tag, steps=20):
    """Where a steady train step's time goes: ``steps`` more steps under
    torch.profiler. Logs the wall time, the time the card is busy, the
    kernel launches per step, and the ops that hold the card longest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mode = trainer._build_mode(train)
    B = train.batch_size

    def run(first, count):
        for i in range(first, first + count):
            idx = torch.arange(i * B, (i + 1) * B, device="cuda")
            mode["step"](trainer._take_batch(mode["tables"], idx), mode["consts"])
        torch.cuda.synchronize()

    run(0, 5)
    t0 = time.time()
    run(5, steps)
    wall = (time.time() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(5 + steps, steps)
    events = prof.key_averages()
    # the kernels and copies themselves; the operator events repeat their time
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    busy = sum(device_us(e) for e in on_card) / steps / 1e3
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel"))) / steps
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    log(f"[{tag}] steady step: {wall:.3f} ms wall (unprofiled), card busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%; "
        f"{launches:.1f} kernel launches per step")
    for e in sorted(on_card, key=device_us, reverse=True)[:10]:
        log(f"[{tag}]   {device_us(e) / steps / 1e3:8.4f} ms/step  x{e.count / steps:5.1f}  "
            f"{e.key[:90]}")


def phase_quality(torch, tmp):
    from recbole_tpu_torch import run_recbole
    t0 = time.time()
    result = run_recbole(model="BPR", dataset="ml-100k", config_dict={
        "valid_full_to_uni1000": False, "device": "cuda",
        "checkpoint_dir": os.path.join(tmp, "saved100k"),
        "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING",
        "show_progress": False})
    test = result["test_result"]
    log(f"[quality] ml-100k BPR early-stopped run {time.time() - t0:.1f}s; best "
        f"valid mrr@10 {result['best_valid_score']}")
    for key, ref in JAX_ML100K.items():
        log(f"[quality]   {key:<13} port {test[key]:.4f}   JAX (TPU v5e, PARITY.md) {ref:.4f}")
    check_result(result, JAX_ML100K)
    if test["recall@10"] < RECALL_FLOOR:
        raise AssertionError(f"ml-100k test recall@10 {test['recall@10']} < {RECALL_FLOOR}")

    t0 = time.time()
    result = run_recbole(model="DeepFM", dataset="ml-100k", config_dict={
        **ML100K_CTR, "device": "cuda",
        "checkpoint_dir": os.path.join(tmp, "saved100k"),
        "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING",
        "show_progress": False})
    test = result["test_result"]
    log(f"[quality] ml-100k DeepFM (CTR protocol, early stopping on AUC) "
        f"{time.time() - t0:.1f}s; best valid {result['best_valid_result']}")
    log(f"[quality]   test auc {test['auc']:.4f} logloss {test['logloss']:.4f}   JAX "
        "package, 3 seeds (PARITY.md): auc 0.7811-0.7919, logloss mean 0.5690")
    check_result(result, ("auc", "logloss"))
    if test["auc"] < AUC_FLOOR:
        raise AssertionError(f"ml-100k DeepFM test AUC {test['auc']} < {AUC_FLOOR}")

    t0 = time.time()
    result = run_recbole(model="SASRec", dataset="ml-100k", config_dict={
        **ML100K_SEQ, "valid_full_to_uni1000": False, "device": "cuda",
        "checkpoint_dir": os.path.join(tmp, "saved100k"),
        "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING",
        "show_progress": False})
    test = result["test_result"]
    log(f"[quality] ml-100k SASRec (TO_LS full-sort, early stopping on mrr@10) "
        f"{time.time() - t0:.1f}s; best valid {result['best_valid_result']}")
    log(f"[quality]   test {json.dumps(test)}   JAX package on a TPU, 3 seeds "
        "(PARITY.md:124-152): recall@10 0.1304-0.1442, ndcg@10 0.0597-0.0668")
    check_result(result, JAX_ML100K)
    if test["recall@10"] < SASREC_RECALL_FLOOR:
        raise AssertionError(f"ml-100k SASRec test recall@10 {test['recall@10']} < "
                             f"{SASREC_RECALL_FLOOR}")


def time_adam(torch, leaves, iters):
    from recbole_tpu_torch.ops.fused_adam import adam_leaf_triton, adam_leaf_torch

    def step(fn):
        for p, m, v, g in leaves:
            fn(p, m, v, g, 10.0, 1000.0, b1=0.9, b2=0.999, lr=1e-3, eps=1e-8)

    params = [torch.nn.Parameter(p.clone()) for p, _, _, _ in leaves]
    for prm, (_, _, _, g) in zip(params, leaves):
        prm.grad = g.clone()
    opt = torch.optim.Adam(params, lr=1e-3, fused=True)
    n = sum(p.numel() for p, _, _, _ in leaves)
    t = {"ms": cuda_ms(torch, lambda: step(adam_leaf_triton), iters),
         "plain_ms": cuda_ms(torch, lambda: step(adam_leaf_torch), iters),
         "library_ms": cuda_ms(torch, opt.step, iters)}
    t["bound_ms"], t["bound_by"] = bound(14.0 * n, 28 * n)
    return n, t


def phase_timing(torch):
    from recbole_tpu_torch.ops import embed_grad as eg
    from recbole_tpu_torch.ops.masked_topk import masked_topk_cuda, masked_topk_torch
    out = {}
    B, N, D, k = 4096, ML1M[1] + 1, 64, 10
    q, items, mask = topk_inputs(torch, B, N, D, seed=1)

    def library():
        s = (q @ items.T).masked_fill_(mask > 0, -1e15)
        return torch.topk(s, k, dim=1)

    t = {"ms": cuda_ms(torch, lambda: masked_topk_cuda(q, items, mask, k), 50),
         "plain_ms": cuda_ms(torch, lambda: masked_topk_torch(q, items, mask, k), 20),
         "library_ms": cuda_ms(torch, library, 20)}
    t["bound_ms"], t["bound_by"] = bound(2.0 * B * N * D,
                                         4 * (B * D + N * D) + B * N + 8 * B * k)
    out["masked_topk"] = t
    log(f"[time] masked_topk B={B} N={N} D={D} k={k}: {t}")

    shapes = [(ML1M[0] + 1, 64), (ML1M[1] + 1, 64)]
    leaves = [[torch.from_numpy(p).cuda(), torch.zeros(p.shape, device="cuda"),
               torch.zeros(p.shape, device="cuda"), torch.from_numpy(g[0]).cuda()]
              for p, g in adam_leaves(torch, shapes, seed=2)]
    n, t = time_adam(torch, leaves, 200)
    out["adam_leaf"] = t
    log(f"[time] adam_leaf one step over {shapes} ({n} elements, "
        f"{len(shapes)} launches): {t}")
    # the DeepFM-Criteo leaf set: the merged table and eleven small leaves
    shapes = DEEPFM_LEAF_SHAPES
    leaves = [[torch.randn(shape, device="cuda") * 0.1, torch.zeros(shape, device="cuda"),
               torch.zeros(shape, device="cuda"), torch.randn(shape, device="cuda") * 1e-3]
              for shape in shapes]
    n, t = time_adam(torch, leaves, 20)
    out["adam_leaf"]["deepfm_criteo"] = t
    log(f"[time] adam_leaf one step over the DeepFM-Criteo leaves ({n} elements, "
        f"{len(shapes)} launches): {t}")
    del leaves

    # one step's backward at the Criteo shape: the 17 small fields through
    # the one-hot kernel, the 9 large ones through the windowed kernel, each
    # reading its column block in place. index_add_ into zeros is the library
    # call for both.
    spec = criteo_field_spec()
    n_large = sum(v > 16384 for _, v in spec)
    ids, g = grad_inputs(torch, CRITEO_BATCH, spec, CRITEO_DIM, seed=8)
    for name, cols, off in (("onehot_matmul_grad", slice(n_large, None), spec[n_large][0]),
                            ("windowed_grad", slice(0, n_large), 0)):
        bids, bg = ids[:, cols], g[:, cols]
        n_rows = sum(v for _, v in spec[cols])
        kernel, plain = getattr(eg, f"{name}_cuda"), getattr(eg, f"{name}_torch")
        # as GroupedTakeRows.backward calls them: the one-hot kernel is told
        # the fields' column ranges
        hint = {"col_off": torch.tensor([o for o, _ in spec[cols]] + [sum(spec[-1])],
                                        device="cuda")} if name == "onehot_matmul_grad" else {}
        dest = torch.empty((n_rows, CRITEO_DIM), device="cuda")
        local = (bids.reshape(-1) - off).contiguous()
        flat = bg.reshape(-1, CRITEO_DIM).contiguous()

        def library():
            return dest.zero_().index_add_(0, local, flat)

        iters = 200 if n_rows < 100_000 else 50
        t = {"ms": cuda_ms(torch, lambda: kernel(bids, bg, n_rows, out=dest, id_base=off,
                                                 **hint), iters),
             "plain_ms": cuda_ms(torch, lambda: plain(bids, bg, n_rows, out=dest, id_base=off),
                                 iters),
             "library_ms": cuda_ms(torch, library, iters)}
        R = bids.numel()
        t["bound_ms"], t["bound_by"] = bound(
            float(R * CRITEO_DIM), R * 8 + R * CRITEO_DIM * 4 + n_rows * CRITEO_DIM * 4)
        out[name] = t
        log(f"[time] {name} R={R} n_rows={n_rows} D={CRITEO_DIM}: {t}")
    out["onehot_matmul_grad"]["sasrec"] = time_onehot_sasrec(torch)
    out.update(time_trm_layer(torch))
    return out


def time_onehot_sasrec(torch):
    """The one-hot kernel as TakeRowsDenseGrad calls it in a SASRec step at
    the ml-1m shape: R = 2048 x 50 ids into 3,707 rows of width 64."""
    from recbole_tpu_torch.ops import embed_grad as eg
    R, V, D = SASREC["B"] * SASREC["L"], ML1M[1] + 1, SASREC["D"]
    ids, g = seq_grad_inputs(torch, seed=11)
    dest = torch.empty((V, D), device="cuda")
    t = {"ms": cuda_ms(torch, lambda: eg.onehot_matmul_grad_cuda(ids, g, V, out=dest), 50),
         "plain_ms": cuda_ms(torch, lambda: eg.onehot_matmul_grad_torch(ids, g, V, out=dest), 50),
         "library_ms": cuda_ms(torch, lambda: dest.zero_().index_add_(0, ids, g), 50)}
    t["bound_ms"], t["bound_by"] = bound(float(R * D), R * 8 + R * D * 4 + V * D * 4)
    log(f"[time] onehot_matmul_grad at the SASRec step's shape R={R} n_rows={V} D={D}: {t}")
    return t


def trm_work(B, L, D, H, I, causal, backward):
    """Operations and bytes of one layer call: the four projections, the
    FFN and the per-head attention products (each head over its own D / H
    lanes; a causal layer needs the L (L + 1) / 2 query-key pairs at or below
    the diagonal only), the backward with the forward it recomputes (each
    forward product has two backward products); x and y (and dy, dx) and the
    parameters (and their gradients) moved once."""
    R = B * L
    pairs = L * (L + 1) // 2 if causal else L * L
    fwd = 2.0 * R * D * D * 4 + 2.0 * R * D * I * 2 + 4.0 * B * pairs * D
    P = 4 * D * D + 2 * D * I + 9 * D + I
    if backward:
        return 3.0 * fwd, 4 * (3 * R * D + B * L + 2 * P)
    return fwd, 4 * (2 * R * D + B * L + P)


def time_trm_layer(torch):
    """Both kernels, both instances, at SASRec's train shape with dropout
    0.5, beside the plain version, the bound and the library's layer
    (nn.TransformerEncoderLayer without dropout: forward, and forward +
    backward beside the backward kernel, which recomputes the forward)."""
    from recbole_tpu_torch.ops import trm_layer as tl
    B, L, D, H, I = (SASREC[k] for k in "BLDHI")
    x, params, valid, dy = trm_inputs(torch, B, L, D, H, I, seed=21)
    seed = torch.tensor([21], dtype=torch.int64, device="cuda")
    lib = torch.nn.TransformerEncoderLayer(D, H, I, dropout=0.0, activation="gelu",
                                           batch_first=True, device="cuda")
    lib.train()
    causal = torch.triu(torch.ones(L, L, dtype=torch.bool, device="cuda"), diagonal=1)
    pad = valid == 0
    xg = x.clone().requires_grad_(True)

    def lib_fwd():
        with torch.no_grad():
            return lib(x, src_mask=causal, src_key_padding_mask=pad)

    def lib_fwd_bwd():
        for p in lib.parameters():
            p.grad = None
        xg.grad = None
        lib(xg, src_mask=causal, src_key_padding_mask=pad).backward(dy)

    library = {"fwd": cuda_ms(torch, lib_fwd, 10), "bwd": cuda_ms(torch, lib_fwd_bwd, 10)}
    out = {}
    for bf16, name in ((True, "trm_layer"), (False, "fused_transformer_layer")):
        kw = dict(n_heads=H, causal=True, act="gelu", dropout=0.5, attn_dropout=0.5, bf16=bf16)
        masks = tl.trm_dropout_masks_cuda(seed, B, H, L, D, 0.5, 0.5)
        cfg = (H, True, "gelu", 1e-12, bf16)
        calls = {
            "fwd": (lambda: tl.trm_layer_fwd_cuda(x, params, valid, seed, **kw),
                    lambda: tl.trm_layer_torch_fwd(x, params, valid, masks, *cfg)),
            "bwd": (lambda: tl.trm_layer_bwd_cuda(x, params, valid, dy, seed, **kw),
                    lambda: tl.trm_layer_torch_bwd(x, params, valid, masks, dy, *cfg))}
        for way, (kernel, plain) in calls.items():
            t = {"ms": cuda_ms(torch, kernel, 20), "plain_ms": cuda_ms(torch, plain, 10),
                 "library_ms": library[way]}
            flops, nbytes = trm_work(B, L, D, H, I, True, way == "bwd")
            t["bound_ms"], t["bound_by"] = bound(
                flops, nbytes, PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
            out[f"{name}_{way}"] = t
            log(f"[time] {name}_{way} B={B} L={L} D={D} H={H} I={I} causal, dropout 0.5 "
                f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB): {t}")
    return out


KERNEL_META = {
    "masked_topk": {"route": "cuda", "source": "recbole_tpu_torch/csrc/masked_topk.cu",
                    "replaces": "recbole_tpu/ops/masked_topk.py:94"},
    "adam_leaf": {"route": "triton", "source": "recbole_tpu_torch/ops/fused_adam.py",
                  "replaces": "recbole_tpu/ops/fused_adam.py:75"},
    "onehot_matmul_grad": {"route": "cuda", "source": "recbole_tpu_torch/csrc/embed_grad.cu",
                           "replaces": "recbole_tpu/ops/embed_grad.py:78"},
    "windowed_grad": {"route": "cuda", "source": "recbole_tpu_torch/csrc/embed_grad.cu",
                      "replaces": "recbole_tpu/ops/embed_grad.py:170"},
    # the two whole-layer kernels, each in its bf16 instance (the JAX package's
    # trm_layer.py) and its fp32 instance (fused_transformer.py)
    "trm_layer_fwd": {"route": "cuda", "source": "recbole_tpu_torch/csrc/trm_layer.cu",
                      "replaces": "recbole_tpu/ops/trm_layer.py:433"},
    "trm_layer_bwd": {"route": "cuda", "source": "recbole_tpu_torch/csrc/trm_layer.cu",
                      "replaces": "recbole_tpu/ops/trm_layer.py:433"},
    "fused_transformer_layer_fwd": {"route": "cuda",
                                    "source": "recbole_tpu_torch/csrc/trm_layer.cu",
                                    "replaces": "recbole_tpu/ops/fused_transformer.py:409"},
    "fused_transformer_layer_bwd": {"route": "cuda",
                                    "source": "recbole_tpu_torch/csrc/trm_layer.cu",
                                    "replaces": "recbole_tpu/ops/fused_transformer.py:409"},
}


def main():
    if not os.path.isdir(os.path.join(REPO, "recbole_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository "
                         "(recbole_tpu_torch/ not found beside it)")
    sys.path.insert(0, REPO)
    import torch

    name, count, smi = phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build(torch)
    err = {"masked_topk": max(check_topk(torch, 4096, ML1M[1] + 1, 64, 10, seed=0),
                              check_topk(torch, 943, 1683, 64, 10, seed=3),
                              # SASRec's full-sort batches: 4,096, then the last 1,944
                              check_topk(torch, 4096, ML1M[1] + 1, 64, 10, seed=14, pad_only=True),
                              check_topk(torch, 1944, ML1M[1] + 1, 64, 10, seed=15, pad_only=True)),
           "adam_leaf": max(check_adam(torch, [(ML1M[0] + 1, 64), (ML1M[1] + 1, 64)], seed=4),
                            check_adam(torch, DEEPFM_LEAF_SHAPES, seed=9),
                            check_adam(torch, SASREC_LEAF_SHAPES, seed=16))}
    for kname, cases in embed_grad_cases(torch).items():
        err[kname] = check_embed_grad(torch, kname, cases)
    err.update(check_trm_layer(torch))
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        by_path["bpr"] = phase_bpr(torch, tmp)
        by_path["deepfm"] = phase_deepfm(torch, tmp)
        by_path["sasrec"] = phase_sasrec(torch, tmp)
        by_path["sasrec_fp32"] = phase_sasrec_fp32(torch, tmp)
        phase_quality(torch, tmp)
    timing = phase_timing(torch)
    kernels = [{"name": kname, **KERNEL_META[kname],
                "launches": sum(path[kname] for path in by_path.values()),
                "launches_by_path": {p: path[kname] for p, path in by_path.items()},
                "max_abs_err": err[kname], **timing[kname]} for kname in KERNEL_META]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": count}}))


if __name__ == "__main__":
    main()
