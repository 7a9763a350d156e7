#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (recbole_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. device: the card's name, count, and nvidia-smi's name and power limit;
  2. build: nvcc builds the seven csrc/*.cu, one process per source, all at
     once (its -Xptxas -v report is printed), and the Triton Adam kernel is
     launched once;
  3. each kernel against its plain PyTorch version, on the card, at the main
     paths' shapes and at edge shapes, and twice on the same input to
     compare the two results bit for bit; the whole-layer transformer
     kernels in both instances (bf16-rounded and fp32 operands), forward and
     backward, with dropout off and on (the plain version is handed the
     masks the kernels draw); the packed-bit row and column kernels on the
     Yelp shape's packed rows and on random bytes; the GRU recurrence
     kernels in both instances, forward and backward, at GRU4Rec's and
     NARM's step, ragged and eval batches, with zero and nonzero h0, and a
     two-layer stack, and at H 10 (zero-padded) and H 256 (the instance
     with wh in device memory); the attention-only kernels, causal and
     bidirectional, dropout off and on, with a sequence that has no valid
     key, at L 50 and L 200 (key tiles); the rel_apply kernels in both
     instances, forward and backward, at RippleNet's step and at edge
     shapes;
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
     d. LightGCN at its defaults (embedding 64, 2 layers, batch 2048) on a
        file of the Yelp shape the reference times it on (102,046 users,
        98,408 items, 2,905,370 interactions, written from a seed) through
        Config -> data_preparation -> get_model -> get_trainer -> fit with
        validation -> evaluate(test): the hybrid operator and the restricted
        step, 1 epoch, then 20 steps under torch.profiler;
     e. GRU4Rec at its defaults (embedding 64, hidden 128, 1 layer, dropout
        0.3, CE, batch 2048, bf16) on the ml-1m-shaped file under TO_LS,full,
        2 epochs, then 20 steps under torch.profiler;
     f. NARM at its defaults (embedding 64, hidden 128, dropouts 0.25 and
        0.5, CE; its GRU in fp32) on the same file, 1 epoch;
     g. SASRec at its default widths with fused_attention True (the
        attention-only kernel) on the same file, 1 epoch;
     h. a few steps and a valid pass at widths the kernels took only after
        their limits were lifted: GRU4Rec at hidden 10 and 256, SASRec at
        hidden 128 and at 200 positions under the default fused_attention
        "layer2" (routed around the whole-layer kernel) and True;
     i. RippleNet at its defaults (embedding 64, 2 hops, 16 memories,
        batch 2048) under KGTrainer on the ml-1m-shaped file with a KG of
        the reference's ml-1m KG shape (79,388 entities, 385,923 triples, 51
        relations, written from a seed), 1 epoch, then 20 steps under
        torch.profiler;
  5. quality on the bundled ml-100k under PARITY.md's protocols: BPR's,
     SASRec's, LightGCN's, GRU4Rec's, NARM's and RippleNet's test recall@10
     and DeepFM's test AUC, each held to a floor;
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

# the Yelp shape the reference times LightGCN on (users, items, interactions;
# asset/time_test_result/General_recommendation.md:123-140, the shape of
# scripts/bench_scale.py)
YELP = (102_046, 98_408, 2_905_370)
# the two embedding tables Adam sweeps in a LightGCN step at that shape
# ([PAD] included)
LIGHTGCN_LEAF_SHAPES = [(YELP[0] + 1, 64), (YELP[1] + 1, 64)]
# ml-100k LightGCN under PARITY.md's default protocol, 30 epochs (PARITY.md:45:
# test recall@10 0.1848 for the JAX package, 0.1887 for the original
# RecBole), with the restricted step forced on so that the bit kernels run
ML100K_LIGHTGCN = {"epochs": 30, "use_restricted_step": True}
LIGHTGCN_RECALL_FLOOR = 0.165

# GRU4Rec's defaults (gru4rec.py:26-28) at the train batch: batch, positions,
# embedding and hidden width; NARM's GRU has the same widths (narm.py:25-27)
GRU4REC = dict(B=2048, L=50, E=64, H=128)
# ml-100k GRU4Rec and NARM under the TO_LS full-sort protocol of
# PARITY.md:93-160 at its 25-epoch budget: the JAX package on a TPU, 3 seeds,
# test recall@10 0.1251-0.1357 (GRU4Rec; 0.1230 in fp32 on the CPU) and
# 0.1273-0.1357 (NARM)
ML100K_GRU = {**ML100K_SEQ, "epochs": 25}
GRU_RECALL_FLOOR = 0.11
# fused_gru against its plain version, as the largest |difference| of a
# tensor over its largest |value|. fp32 instance: the same fp32 arithmetic in
# another order, carried through 50 steps. bf16 instance: both round at the
# same places, but an fp32 sum that lands on the other side of a rounding
# boundary moves a stored h_t (or dxi) by one bf16 step, 2^-8 of its value
GRU_TOL = {False: 1e-4, True: 1e-2}
# fused_attention against its plain version: fp32 sums and exp in another
# order
ATTN_TOL = 1e-4
# rel_apply against its plain version, as the largest |difference| of a
# tensor over its largest |value|: fp32 instance, fp32 sums in another order
# (rtol 2e-4, the bar of the port's fp32 tests); bf16 instance, the bound
# the JAX kernel is held to against the fp32 loop
# (tests/test_round5_fixes.py:163-195)
REL_TOL = {False: 2e-4, True: 2e-2}
# RippleNet's defaults (ripplenet.py:63-64) at the train batch: batch, hops,
# memories, embedding; a step sees the batch and one negative each, so the
# relation apply runs on B x 2 x n_hop x n_memory rows
RIPPLENET = dict(B=2048, hops=2, M=16, D=64)
# the reference's ml-1m KG shape (entities, triples, relations;
# Knowledge-based_recommendation.md:5-9, the recipe of
# scripts/bench_models.py:106-121)
ML1M_KG = (79_388, 385_923, 51)
# ml-100k RippleNet under the general full-sort protocol (RO_RS, valid full
# sort), 40 epochs with early stopping on mrr@10: the JAX package on the
# CPU, 3 seeds (python run.py --model=RippleNet --dataset=ml-100k
# --epochs=40 --seed=<s>), test recall@10 0.1877, 0.1756 and 0.1953 for
# seeds 2020-2022 (ndcg@10 0.2181, 0.2189, 0.2283); the floor lies below.
# At 20 epochs the seed decides whether the valid curve has made its jump
# (epochs 12-16), and the spread is too wide to hold a floor
ML100K_RIPPLE = {"epochs": 40}
RIPPLE_JAX_SPREAD = "0.1756-0.1953 (seeds 2020-2022: 0.1877, 0.1756, 0.1953)"
RIPPLE_RECALL_FLOOR = 0.155

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
# the packed-bit products are held to the same rule: the kernels add exact
# terms in fp32 in the order of the set bits (rows) or of r (columns), the
# plain version through a library product


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


def yelp_draw(seed=42):
    """Raw user and item ids of the Yelp shape, drawn as
    scripts/bench_scale.py:46-53 draws them: uniform users, power-law items
    1 + floor((n_items - 1) * r ** 2.2)."""
    n_users, n_items, n_inter = YELP
    rng = np.random.RandomState(seed)
    uids = rng.randint(1, n_users + 1, size=n_inter)
    iids = 1 + np.floor((n_items - 1) * rng.random_sample(n_inter) ** 2.2).astype(np.int64)
    return uids, iids


def write_yelp_shape(path, seed=42):
    uids, iids = yelp_draw(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("user_id:token\titem_id:token\ttimestamp:float\n")
        np.savetxt(fh, np.stack([uids, iids, np.arange(len(uids))], axis=1), fmt="%d",
                   delimiter="\t")


def yelp_bit_inputs(torch, seed=42):
    """The two packed images of the Yelp-shaped draw on the card (raw ids,
    [PAD] row 0 empty), and a train batch's rows: 2,048 users, and 4,096
    items (2,048 positives drawn from the interactions, 2,048 uniform
    negatives)."""
    from recbole_tpu_torch.ops.bitgraph import _pack_side
    uids, iids = yelp_draw(seed)
    n_u, n_i = YELP[0] + 1, YELP[1] + 1
    user_bits = torch.from_numpy(_pack_side(uids, iids, n_u, n_i)).cuda()
    item_bits = torch.from_numpy(_pack_side(iids, uids, n_i, n_u)).cuda()
    rng = np.random.RandomState(seed + 1)
    pick = rng.randint(0, len(uids), 2048)
    rows_u = torch.from_numpy(uids[pick].astype(np.int64)).cuda()
    rows_i = torch.from_numpy(np.concatenate(
        [iids[pick], rng.randint(1, n_i, 2048)]).astype(np.int64)).cuda()
    return {"user": (user_bits, rows_u, n_i), "item": (item_bits, rows_i, n_u)}


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
    logs = cuda_build.build(["masked_topk", "embed_grad", "trm_layer", "bit_kernels",
                             "fused_gru", "fused_attention", "rel_apply"])
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
    # a LightGCN step at the Yelp shape: the restricted backward's dense
    # gradient at the batch users (R 2,048) and items (R 4,096), and the ego
    # gathers of its L2 term (R 2,048 into the item table)
    rng = np.random.RandomState(17)
    lg_u = torch.from_numpy(rng.randint(1, YELP[0] + 1, 2048).astype(np.int64)).cuda()
    lg_i = torch.from_numpy((1 + np.floor(YELP[1] * rng.random_sample(4096) ** 2.2))
                            .astype(np.int64)).cuda()
    lg_g = torch.from_numpy(rng.randn(4096, 64).astype(np.float32) * 1e-3).cuda()
    windowed = [
        ("LightGCN users R=2048 into the user table", lg_u, lg_g[:2048], YELP[0] + 1, 0),
        ("LightGCN items R=4096 into the item table", lg_i, lg_g, YELP[1] + 1, 0),
        ("LightGCN positives R=2048 into the item table", lg_i[:2048], lg_g[2048:], YELP[1] + 1,
         0),
        ("criteo large fields, (B, 9) block in place", ids[:, :n_large], g[:, :n_large],
         large_rows, 0),
        ("criteo large fields, contiguous", big_ids, big_g, large_rows, 0),
        ("every id equal", torch.full_like(big_ids, 1_234_567), big_g, large_rows, 0),
        ("D=1", big_ids, big_g[:, :1].contiguous(), large_rows, 0),
        ("R=1", big_ids[:1], big_g[:1], large_rows, 0),
    ]
    return {"onehot_matmul_grad": onehot, "windowed_grad": windowed}


def bit_cases(torch, images):
    """(label, bits, rows, n_cols): both Yelp sides at a train batch's R, a
    ragged batch and R = 1, on the Yelp-shaped packed rows (about 28 set bits
    a row) and on random bytes of the same shapes."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for kind in ("packed rows", "random bytes"):
        sides = {}
        for side in ("user", "item"):
            bits, rows, n_cols = images[side]
            if kind == "random bytes":
                bits = torch.randint(0, 256, tuple(bits.shape), dtype=torch.uint8, device="cuda",
                                     generator=gen)
            sides[side] = (bits, rows, n_cols)
            cases.append((f"{side} side, {kind}", bits, rows, n_cols))
        bits, rows, n_cols = sides["item"]
        cases.append((f"item side, {kind}, ragged R=1864", bits, rows[:1864].contiguous(),
                      n_cols))
        bits, rows, n_cols = sides["user"]
        cases.append((f"user side, {kind}, R=1", bits, rows[:1].contiguous(), n_cols))
    return cases


def check_bit_kernels(torch, images):
    """Both packed-bit kernels against their plain versions on each case:
    within GRAD_RTOL of the sum of the terms' magnitudes plus GRAD_ATOL, and
    a second run compared bit for bit."""
    from recbole_tpu_torch.ops import bit_kernels as bk
    worst = {"bit_rows_matmul": 0.0, "bit_cols_matmul": 0.0}
    rng = np.random.RandomState(19)
    for label, bits, rows, n_cols in bit_cases(torch, images):
        R = rows.numel()
        v = torch.from_numpy(rng.randn(n_cols, 64).astype(np.float32) * 0.1).cuda().bfloat16()
        g = torch.from_numpy(rng.randn(R, 64).astype(np.float32) * 1e-3).cuda().bfloat16()
        for name, x in (("bit_rows_matmul", v), ("bit_cols_matmul", g)):
            kernel, plain = getattr(bk, f"{name}_cuda"), getattr(bk, f"{name}_torch")
            out = kernel(bits, rows, x)
            torch.cuda.synchronize()
            same = bool(torch.equal(out, kernel(bits, rows, x)))
            ref = plain(bits, rows, x)
            scale = plain(bits, rows, x.abs())
            diff = (out - ref).abs()
            err = float(diff.max())
            log(f"[check] {name} {label}: R={R} nbytes={bits.shape[1]} D=64 max|err| {err:.3e} "
                f"(tolerance {GRAD_RTOL} * sum|terms| + {GRAD_ATOL}); set bits "
                f"{int(bk.unpack_bits(bits[rows]).sum())}; two runs bit-identical: {same}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} {label}: non-finite output")
            if not bool((diff <= GRAD_RTOL * scale + GRAD_ATOL).all()):
                raise AssertionError(f"{name} {label}: beyond tolerance, max|err| {err}")
            if not same:
                raise AssertionError(f"{name} {label}: two runs differ, the kernel is meant "
                                     "to be deterministic")
            worst[name] = max(worst[name], err)
    return worst


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


def gru_inputs(torch, B, L, H, seed, bf16, h0):
    """xi (bf16 in the bf16 instance), h0 (zero or not), wh in gru_init's
    xavier-uniform range, bh and a cotangent, on the card."""
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    xi = torch.from_numpy(rng.randn(B, L, 3 * H).astype(np.float32)).to(dev)
    if bf16:
        xi = xi.to(torch.bfloat16)
    lim = np.sqrt(6.0 / (4 * H))
    wh = torch.from_numpy(rng.uniform(-lim, lim, (H, 3 * H)).astype(np.float32)).to(dev)
    bh = torch.from_numpy((0.1 * rng.randn(3 * H)).astype(np.float32)).to(dev)
    hinit = torch.from_numpy(((0.5 if h0 else 0.0) * rng.randn(B, H)).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.randn(B, L, H).astype(np.float32)).to(dev).to(xi.dtype)
    return xi, hinit, wh, bh, dout


def rel_err(a, b):
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def gru_stack(torch, gru, x, cdt, plain):
    """layers.gru_apply's stack with every recurrence through the plain
    version, for a CUDA tensor (the dispatcher would take the kernels)."""
    from recbole_tpu_torch.models.layers import dot_c, gru_apply
    from recbole_tpu_torch.ops.fused_gru import fused_gru_torch
    if not plain:
        return gru_apply(gru, x, compute_dtype=cdt)
    for layer in gru:
        xi = dot_c(x, layer.wi, cdt) + layer.bi
        if cdt is not None:
            xi = xi.to(cdt)
        h0 = torch.zeros((x.shape[0], layer.wh.shape[0]), device=x.device)
        x = fused_gru_torch(xi, h0, layer.wh, layer.bh, bf16=cdt is not None)
    return x


def check_gru(torch):
    """fused_gru_fwd / fused_gru_bwd against the plain version on the card:
    out, dxi, dh0, dwh, dbh, both instances (bf16 = GRU4Rec's default, fp32 =
    NARM's GRU and GRU4Rec under float32), at the step (2,048), the ragged
    last train batch of the ml-1m-shaped file (1,097), a full-sort batch
    (4,096) and its last (1,944), h0 zero and not; two runs compared bit for
    bit; then a two-layer GRU4Rec stack at full width through
    layers.gru_apply against the plain version, forward and gradients."""
    from recbole_tpu_torch.models.layers import GRU
    from recbole_tpu_torch.ops import fused_gru as fg
    L, E, H = GRU4REC["L"], GRU4REC["E"], GRU4REC["H"]
    worst = {"fused_gru_fwd": 0.0, "fused_gru_bwd": 0.0}
    log(f"[check] fused_gru shared memory a block: forward {fg._lib().fused_gru_smem_bytes(H, 0)}"
        f", backward {fg._lib().fused_gru_smem_bytes(H, 1)} bytes at H={H}")
    n = 0
    for bf16 in (True, False):
        for label, B in (("step", GRU4REC["B"]), ("last train batch", 1097),
                         ("eval batch", 4096), ("last eval batch", 1944)):
            for h0 in (False, True):
                n += 1
                xi, hinit, wh, bh, dout = gru_inputs(torch, B, L, H, 200 + n, bf16, h0)

                def run():
                    out = fg.fused_gru_fwd_cuda(xi, hinit, wh, bh)
                    grads = fg.fused_gru_bwd_cuda(xi, hinit, wh, bh, out, dout)
                    torch.cuda.synchronize()
                    return (out, *grads)

                got, again = run(), run()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ref = (fg.fused_gru_torch_fwd(xi, hinit, wh, bh, bf16),
                       *fg.fused_gru_torch_bwd(xi, hinit, wh, bh, got[0], dout, bf16))
                names = ("out", "dxi", "dh0", "dwh", "dbh")
                errs = {k: rel_err(a, b) for k, a, b in zip(names, got, ref)}
                tol = GRU_TOL[bf16]
                log(f"[check] fused_gru {'bf16' if bf16 else 'fp32'} ({label}) B={B} L={L} H={H} "
                    f"h0={'nonzero' if h0 else 'zero'}: " + ", ".join(
                        f"{k} {v:.3e}" for k, v in errs.items())
                    + f" (tolerance {tol} of the tensor's largest value); two runs "
                    f"bit-identical: {same}")
                if not all(bool(torch.isfinite(t.float()).all()) for t in got):
                    raise AssertionError(f"fused_gru {label}: non-finite output")
                if max(errs.values()) > tol:
                    raise AssertionError(f"fused_gru {label}: beyond tolerance {tol}: {errs}")
                if not same:
                    raise AssertionError(f"fused_gru {label}: two runs differ, the kernels are "
                                         "meant to be deterministic")
                worst["fused_gru_fwd"] = max(worst["fused_gru_fwd"],
                                             float((got[0].float() - ref[0].float()).abs().max()))
                worst["fused_gru_bwd"] = max([worst["fused_gru_bwd"], *(
                    float((a.float() - b.float()).abs().max()) for a, b in zip(got[1:], ref[1:]))])
    for cdt in (torch.bfloat16, None):
        gru = GRU(torch.Generator(device="cuda").manual_seed(5), E, H, 2, "cuda")
        rng = np.random.RandomState(31)
        x0 = torch.from_numpy(rng.randn(GRU4REC["B"], L, E).astype(np.float32)).cuda()
        dy = torch.from_numpy(rng.randn(GRU4REC["B"], L, H).astype(np.float32)).cuda()
        res = {}
        for plain in (False, True):
            x = x0.clone().requires_grad_(True)
            for p in gru.parameters():
                p.grad = None
            out = gru_stack(torch, gru, x, cdt, plain)
            (out.float() * dy.to(out.dtype).float()).sum().backward()
            torch.cuda.synchronize()
            res[plain] = {"out": out.detach(), "dx": x.grad,
                          **{n: p.grad.clone() for n, p in gru.named_parameters()}}
        errs = {k: rel_err(res[False][k], res[True][k]) for k in res[True]}
        tol = GRU_TOL[cdt is not None]
        log(f"[check] gru_apply two layers {'bf16' if cdt else 'fp32'} B={GRU4REC['B']} L={L} "
            f"{E}->{H}->{H}: worst {max(errs, key=errs.get)} {max(errs.values()):.3e} "
            f"(tolerance {tol})")
        if max(errs.values()) > tol:
            raise AssertionError(f"gru_apply two layers: beyond tolerance {tol}: {errs}")
    # hidden sizes beyond the shared-memory instance: H 256 (wh in device
    # memory) and H 10 (zero-padded to 12 by the dispatcher), through
    # fused_gru and autograd at the step's batch
    lib = fg._lib()
    for H2 in (256, 10):
        log(f"[check] fused_gru H={H2}: runs at H={fg.padded_hidden(H2)}, "
            f"{'wh in device memory' if H2 > lib.fused_gru_max_shared_hidden() else 'wh in shared memory'}, "
            f"{lib.fused_gru_smem_bytes(fg.padded_hidden(H2), 1)} bytes of shared memory a block "
            "(backward)")
        for bf16 in (True, False):
            xi, hinit, wh, bh, dout = gru_inputs(torch, GRU4REC["B"], L, H2, 260 + H2 + bf16,
                                                 bf16, True)

            def run(fn):
                args = [t.clone().requires_grad_(True) for t in (xi, hinit, wh, bh)]
                out = fn(*args)
                (out.float() * dout.float()).sum().backward()
                torch.cuda.synchronize()
                return [out.detach()] + [a.grad for a in args]

            before = (fg.fused_gru_fwd_cuda.launches, fg.fused_gru_bwd_cuda.launches)
            got = run(fg.fused_gru)
            if (fg.fused_gru_fwd_cuda.launches - before[0],
                    fg.fused_gru_bwd_cuda.launches - before[1]) != (1, 1):
                raise AssertionError(f"fused_gru H={H2} did not launch the kernels once each way")
            same = all(torch.equal(a, b) for a, b in zip(got, run(fg.fused_gru)))
            ref = run(lambda *a: fg.fused_gru_torch(*a, bf16=bf16))
            errs = {k: rel_err(a, b) for k, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"),
                                                        got, ref)}
            tol = GRU_TOL[bf16]
            log(f"[check] fused_gru {'bf16' if bf16 else 'fp32'} B={GRU4REC['B']} L={L} H={H2}: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (tolerance {tol}); two runs bit-identical: {same}")
            if not all(bool(torch.isfinite(t.float()).all()) for t in got) \
                    or max(errs.values()) > tol or not same:
                raise AssertionError(f"fused_gru H={H2}: {errs}, bit-identical {same}")
            worst["fused_gru_fwd"] = max(worst["fused_gru_fwd"],
                                         float((got[0].float() - ref[0].float()).abs().max()))
            worst["fused_gru_bwd"] = max([worst["fused_gru_bwd"], *(
                float((a.float() - b.float()).abs().max()) for a, b in zip(got[1:], ref[1:]))])
    return worst


def attention_inputs(torch, B, L, H, hd, seed, empty_row=True):
    """q, k, v, a cotangent (B, L, H, hd) and key validity from random
    lengths; sequence 0 has no valid key when ``empty_row``."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, L, H, hd).astype(np.float32)).cuda()
                   for _ in range(4))
    lens = rng.randint(1, L + 1, B)
    if empty_row:
        lens[0] = 0
    valid = torch.from_numpy((np.arange(L)[None, :] < lens[:, None]).astype(np.int32)).cuda()
    return q, k, v, valid, do


def check_attention(torch):
    """fused_attention_fwd / _bwd against the plain version fed the masks the
    kernels draw (autograd of the plain forward for the gradients: so the
    backward kernel's regenerated masks are the forward's), causal and
    bidirectional, dropout 0 and 0.5, with a sequence that has no valid key,
    at SASRec's step, its ragged last train batch and an eval batch; the
    keep rates; two runs compared bit for bit."""
    from recbole_tpu_torch.ops import fused_attention as fa
    L, H = SASREC["L"], SASREC["H"]
    hd = SASREC["D"] // H
    worst = {"fused_attention_fwd": 0.0, "fused_attention_bwd": 0.0}
    cases = [("SASRec step", SASREC["B"], L, causal, rate)
             for causal in (True, False) for rate in (0.0, 0.5)]
    cases += [("last train batch", 1097, L, True, 0.5), ("eval batch", 4096, L, True, 0.0)]
    # 200 positions: seven key tiles, the online softmax across them
    cases += [("L 200 step", SASREC["B"], 200, causal, 0.5) for causal in (True, False)]
    for n, (label, B, L, causal, rate) in enumerate(cases):
        q, k, v, valid, do = attention_inputs(torch, B, L, H, hd, 300 + n)
        seed = torch.tensor([0x7654321 + 31 * n], dtype=torch.int64, device="cuda")
        kw = dict(causal=causal, rate=rate, layer=n % 2)

        def run():
            o, stats = fa.fused_attention_fwd_cuda(q, k, v, valid, seed, with_stats=True, **kw)
            out = (o, *fa.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o, stats=stats,
                                                   **kw))
            torch.cuda.synchronize()
            return out

        got, again = run(), run()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        masks, kept = None, ""
        if rate > 0.0:
            masks = fa.fused_attention_dropout_masks_cuda(seed, B, H, L, rate, layer=n % 2)
            kept = f" kept {check_keep_rate(masks, rate, f'attention {label} mask'):.4f}"
        tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
        ref = fa.fused_attention_torch(tq, tk, tv, valid, causal, rate, masks=masks)
        (ref * do).sum().backward()
        ref = (ref.detach(), tq.grad, tk.grad, tv.grad)
        errs = {name: rel_err(a, b) for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref)}
        log(f"[check] fused_attention ({label}) B={B} L={L} H={H} hd={hd} causal={causal} "
            f"dropout={rate} empty_row=True: " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tolerance {ATTN_TOL} of the tensor's largest value){kept}; two runs "
            f"bit-identical: {same}")
        if not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError(f"fused_attention {label}: non-finite output")
        if max(errs.values()) > ATTN_TOL:
            raise AssertionError(f"fused_attention {label}: beyond tolerance: {errs}")
        if not same:
            raise AssertionError(f"fused_attention {label}: two runs differ")
        worst["fused_attention_fwd"] = max(worst["fused_attention_fwd"],
                                           float((got[0] - ref[0]).abs().max()))
        worst["fused_attention_bwd"] = max([worst["fused_attention_bwd"], *(
            float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:]))])
    return worst


def rel_inputs(torch, N, D, NR, seed, skew=None, empty=None, outside=0):
    """v, rel (int32), R, dy on the card: relations uniform over [0, NR),
    ``skew`` of the rows moved to relation 0, relation ``empty`` left with no
    rows, ``outside`` rows given the id NR."""
    rng = np.random.RandomState(seed)
    rel = rng.randint(0, NR, N)
    if skew:
        rel[rng.random_sample(N) < skew] = 0
    if empty is not None:
        rel[rel == empty] = (empty + 1) % NR
    if outside:
        rel[rng.choice(N, outside, replace=False)] = NR
    v = rng.randn(N, D).astype(np.float32)
    R = (rng.randn(NR, D, D) * np.sqrt(2.0 / (NR + D * D))).astype(np.float32)
    dy = rng.randn(N, D).astype(np.float32)
    return (torch.from_numpy(v).cuda(), torch.from_numpy(rel.astype(np.int32)).cuda(),
            torch.from_numpy(R).cuda(), torch.from_numpy(dy).cuda())


def rel_cases():
    """(label, N, D, NR, extra): RippleNet's step at the ml-1m KG shape
    (4,096 rows x 2 hops x 16 memories, 53 relation ids), the same rows of
    one eval chunk's users, and the edges."""
    step = 2 * RIPPLENET["B"] * RIPPLENET["hops"] * RIPPLENET["M"]
    NR = ML1M_KG[2] + 2
    return [("step", step, RIPPLENET["D"], NR, {}),
            ("N not a multiple of the tile", 10_001, 64, NR, {"empty": 9}),
            ("one relation holds 90%", 65_536, 64, NR, {"skew": 0.9}),
            ("NR 1", 4_097, 64, 1, {}),
            ("NR 200, ids outside [0, NR)", 50_000, 64, 200, {"outside": 17}),
            ("D 128", 20_000, 128, 24, {})]


def check_rel_apply(torch):
    """rel_apply_fwd / rel_apply_bwd against the plain version on the card:
    y, dv and dR, both instances, at RippleNet's step and the edge shapes;
    two runs compared bit for bit."""
    from recbole_tpu_torch.ops import rel_apply as ra
    worst = {"rel_apply_fwd": 0.0, "rel_apply_bwd": 0.0}
    for n, (label, N, D, NR, extra) in enumerate(rel_cases()):
        v, rel, R, dy = rel_inputs(torch, N, D, NR, 400 + n, **extra)
        for bf16 in (False, True):
            def run():
                y = ra.rel_apply_fwd_cuda(v, rel, R, bf16=bf16)
                dv, dR = ra.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16)
                torch.cuda.synchronize()
                return y, dv, dR

            got, again = run(), run()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ref = (ra.rel_apply_torch(v, rel, R, bf16), *ra.rel_apply_torch_bwd(v, rel, R, dy, bf16))
            errs = {k: rel_err(a, b) for k, a, b in zip(("y", "dv", "dR"), got, ref)}
            tol = REL_TOL[bf16]
            log(f"[check] rel_apply {'bf16' if bf16 else 'fp32'} ({label}) N={N} D={D} NR={NR}: "
                + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                + f" (tolerance {tol} of the tensor's largest value); two runs bit-identical: "
                f"{same}")
            if not all(bool(torch.isfinite(t).all()) for t in got):
                raise AssertionError(f"rel_apply {label}: non-finite output")
            if max(errs.values()) > tol:
                raise AssertionError(f"rel_apply {label}: beyond tolerance {tol}: {errs}")
            if not same:
                raise AssertionError(f"rel_apply {label}: two runs differ")
            if "empty" in extra and float(got[2][extra["empty"]].abs().max()) != 0.0:
                raise AssertionError("rel_apply: a relation with no rows got a gradient")
            if "outside" in extra:
                bad = rel >= NR
                if float(got[0][bad].abs().max()) or float(got[1][bad].abs().max()):
                    raise AssertionError("rel_apply: a row outside [0, NR) is not 0")
            worst["rel_apply_fwd"] = max(worst["rel_apply_fwd"],
                                         float((got[0] - ref[0]).abs().max()))
            worst["rel_apply_bwd"] = max([worst["rel_apply_bwd"], *(
                float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:]))])
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
    from recbole_tpu_torch.ops import bit_kernels as bk
    from recbole_tpu_torch.ops import fused_attention as fa
    from recbole_tpu_torch.ops import fused_gru as fg
    from recbole_tpu_torch.ops import rel_apply as ra
    return {"masked_topk": masked_topk_cuda, "adam_leaf": adam_leaf_triton,
            "onehot_matmul_grad": eg.onehot_matmul_grad_cuda,
            "windowed_grad": eg.windowed_grad_cuda,
            "trm_layer_fwd": tl.trm_layer_fwd_cuda, "trm_layer_bwd": tl.trm_layer_bwd_cuda,
            "bit_rows_matmul": bk.bit_rows_matmul_cuda,
            "bit_cols_matmul": bk.bit_cols_matmul_cuda,
            "fused_gru_fwd": fg.fused_gru_fwd_cuda, "fused_gru_bwd": fg.fused_gru_bwd_cuda,
            "fused_attention_fwd": fa.fused_attention_fwd_cuda,
            "fused_attention_bwd": fa.fused_attention_bwd_cuda,
            "rel_apply_fwd": ra.rel_apply_fwd_cuda, "rel_apply_bwd": ra.rel_apply_bwd_cuda}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0
        for share in ("launches_fp32", "launches_bf16"):
            if hasattr(fn, share):
                setattr(fn, share, 0)


def read_launches(path, must_launch):
    """The wrappers' counts; the transformer wrappers count both instances,
    told apart here: trm_layer_* is the bf16 instance's share,
    fused_transformer_layer_* the fp32 instance's. fused_gru_* count both of
    theirs (one TPU kernel), and fused_gru_*_fp32 is the fp32 share;
    rel_apply_* count both of theirs, rel_apply_*_bf16 the bf16 share."""
    launches = {}
    for name, fn in kernel_wrappers().items():
        if name.startswith("trm_layer"):
            launches[name] = fn.launches - fn.launches_fp32
            launches[name.replace("trm_layer", "fused_transformer_layer")] = fn.launches_fp32
        else:
            launches[name] = fn.launches
            if hasattr(fn, "launches_fp32"):
                launches[f"{name}_fp32"] = fn.launches_fp32
            if hasattr(fn, "launches_bf16"):
                launches[f"{name}_bf16"] = fn.launches_bf16
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


def phase_lightgcn(torch, tmp):
    """LightGCN at its defaults on a file of the Yelp shape, RO_RS,full, cut
    to 1 epoch: the hybrid operator and the restricted step (2 row and 2
    column products of the packed bits a step); then 20 steady steps under
    the profiler."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    t0 = time.time()
    write_yelp_shape(os.path.join(tmp, "data", "yelp-shape", "yelp-shape.inter"))
    log(f"[lightgcn] wrote the Yelp-shaped .inter in {time.time() - t0:.1f}s")
    config = Config("LightGCN", "yelp-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "epochs": 1, "device": "cuda",
        "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False},
        _parse_cmd_line=False)
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    t0 = time.time()
    train, valid, test = data_preparation(config, create_dataset(config))
    log(f"[lightgcn] dataset, RO_RS splits and loaders in {time.time() - t0:.1f}s: train "
        f"{train.n} rows; valid {len(valid.users)} and test {len(test.users)} users, eval "
        f"batch {valid.batch_size}")
    t0 = time.time()
    model = get_model("LightGCN")(config, train.dataset)
    torch.cuda.synchronize()
    widths = {k: config[k] for k in ("embedding_size", "n_layers", "reg_weight",
                                     "train_batch_size", "learning_rate", "eval_setting")}
    log(f"[lightgcn] model built in {time.time() - t0:.1f}s: {model.n_users} users, "
        f"{model.n_items} items, widths {widths}; operator: dense {model.prop.dense}, hybrid "
        f"{model.prop.hybrid}, hub {model.prop.hub_size} items, build seconds "
        f"{model.prop.build_seconds}; restricted step {model.use_restricted}")
    if not (model.use_restricted and model.prop.hybrid) or model.prop.dense:
        raise AssertionError("LightGCN at the Yelp shape did not take the hybrid operator "
                             "and the restricted step")
    if (widths["embedding_size"], widths["n_layers"], widths["train_batch_size"]) != (64, 2, 2048):
        raise AssertionError("LightGCN was not built at its defaults")
    buffers = {n: (tuple(b.shape), str(b.dtype).replace("torch.", ""))
               for n, b in model.named_buffers()}
    log(f"[lightgcn] packed images build seconds {model.bitgraph.build_seconds}; buffers "
        f"{buffers}; {sum(b.numel() * b.element_size() for b in model.buffers())} bytes")
    trainer = get_trainer(config["MODEL_TYPE"], "LightGCN")(config, model)
    times, release = capture_epoch_times()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    best_score, best_valid = trainer.fit(train, valid, saved=False)
    test_result = trainer.evaluate(test, load_best_model=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches("lightgcn", ("bit_rows_matmul", "bit_cols_matmul", "windowed_grad",
                                          "adam_leaf"))
    release()
    steps = len(train)
    for name in ("bit_rows_matmul", "bit_cols_matmul"):
        if launches[name] != 2 * steps:
            raise AssertionError(f"{name} launched {launches[name]} times in {steps} steps, "
                                 "not 2 a step")
    result = {"best_valid_result": best_valid, "test_result": test_result}
    log(f"[lightgcn] fit (1 epoch, validation) + test: {wall:.2f}s wall")
    log(f"[lightgcn] result {json.dumps(result)}")
    check_result(result, JAX_ML100K)
    log(f"[lightgcn] {steps} steps; launches per step: " + ", ".join(
        f"{k} {launches[k] / steps:.2f}" for k in ("bit_rows_matmul", "bit_cols_matmul",
                                                   "windowed_grad", "adam_leaf")))
    log(f"[lightgcn] epoch seconds {times['train']} (includes the upload); train examples/s: "
        f"{train.n / times['train'][-1]:.1f}; ms/step: "
        f"{1e3 * times['train'][-1] / steps:.3f}")
    log(f"[lightgcn] full-sort valid pass seconds {times['eval']}")
    log(f"[lightgcn] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(torch, trainer, train, "lightgcn")
    return launches


def seq_phase(torch, tmp, tag, model_name, config_extra, epochs, widths_keys, must_launch,
              must_not):
    """One sequential model on the ml-1m-shaped file (written by phase_bpr)
    under TO_LS,full through Config -> data_preparation -> get_model ->
    get_trainer -> fit with validation -> evaluate(test), with every
    kernel's launch count set to 0 just before and read just after; then 20
    steady steps under the profiler. Returns (launches, model, config)."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    config = Config(model_name, "ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "epochs": epochs, "device": "cuda",
        "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False,
        **config_extra}, _parse_cmd_line=False)
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    t0 = time.time()
    train, valid, test = data_preparation(config, create_dataset(config))
    log(f"[{tag}] dataset, TO_LS splits and loaders in {time.time() - t0:.1f}s: train "
        f"{train.n} valid {valid.n} test {test.n} examples, eval batch {valid.batch_size}")
    model = get_model(model_name)(config, train.dataset)
    widths = {k: config[k] for k in widths_keys}
    log(f"[{tag}] widths {widths}; compute dtype {model.compute_dtype} (cdt {model.cdt}); "
        f"{sum(p.numel() for p in model.parameters())} parameters in "
        f"{len(list(model.parameters()))} leaves")
    trainer = get_trainer(config["MODEL_TYPE"], model_name)(config, model)
    times, release = capture_epoch_times()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    best_score, best_valid = trainer.fit(train, valid, saved=False)
    test_result = trainer.evaluate(test, load_best_model=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(tag, must_launch)
    release()
    ran = {k: launches[k] for k in must_not if launches[k]}
    if ran:
        raise AssertionError(f"kernels off the {tag} path were launched: {ran}")
    result = {"best_valid_result": best_valid, "test_result": test_result}
    log(f"[{tag}] fit ({epochs} epochs, validation each) + test: {wall:.2f}s wall")
    log(f"[{tag}] result {json.dumps(result)}")
    check_result(result, JAX_ML100K)
    steps = epochs * len(train)
    log(f"[{tag}] {steps} steps; launches per step: " + ", ".join(
        f"{k} {launches[k] / steps:.2f}" for k in must_launch) + "; forward kernels count "
        "the eval batches too")
    log(f"[{tag}] epoch seconds {times['train']} (epoch 0 includes the upload); "
        f"train examples/s (last epoch): {train.n / times['train'][-1]:.1f}; "
        f"ms/step (last epoch): {1e3 * times['train'][-1] / len(train):.3f}")
    log(f"[{tag}] full-sort valid pass seconds {times['eval']}")
    log(f"[{tag}] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(torch, trainer, train, tag)
    return launches, model, widths


def phase_gru4rec(torch, tmp):
    """GRU4Rec at its defaults, 2 epochs: the bf16 instance of the GRU
    kernels, the one-hot gradient, Adam and the masked top-k."""
    launches, model, widths = seq_phase(
        torch, tmp, "gru4rec", "GRU4Rec", {}, 2,
        ("embedding_size", "hidden_size", "num_layers", "dropout_prob", "loss_type",
         "MAX_ITEM_LIST_LENGTH", "train_batch_size"),
        ("fused_gru_fwd", "fused_gru_bwd", "onehot_matmul_grad", "adam_leaf", "masked_topk"),
        ("fused_gru_fwd_fp32", "fused_gru_bwd_fp32", "trm_layer_fwd", "windowed_grad"))
    if tuple(widths.values()) != (64, 128, 1, 0.3, "CE", 50, 2048) \
            or model.cdt != torch.bfloat16:
        raise AssertionError(f"GRU4Rec was not built at its defaults: {widths}, {model.cdt}")
    return launches


def phase_narm(torch, tmp):
    """NARM at its defaults, 1 epoch (cut): the fp32 instance of the GRU
    kernels; its full-sort eval is the non-fused route (no masked top-k)."""
    launches, model, widths = seq_phase(
        torch, tmp, "narm", "NARM", {}, 1,
        ("embedding_size", "hidden_size", "n_layers", "dropout_probs", "loss_type",
         "MAX_ITEM_LIST_LENGTH", "train_batch_size"),
        ("fused_gru_fwd_fp32", "fused_gru_bwd_fp32", "onehot_matmul_grad", "adam_leaf"),
        ("masked_topk", "trm_layer_fwd", "windowed_grad"))
    if (widths["embedding_size"], widths["hidden_size"], widths["n_layers"],
            list(widths["dropout_probs"]), widths["train_batch_size"]) != (64, 128, 1,
                                                                         [0.25, 0.5], 2048):
        raise AssertionError(f"NARM was not built at its defaults: {widths}")
    if launches["fused_gru_fwd"] != launches["fused_gru_fwd_fp32"]:
        raise AssertionError("NARM's GRU ran the bf16 instance")
    return launches


def phase_sasrec_attention(torch, tmp):
    """SASRec at its default widths with fused_attention True, 1 epoch: the
    attention-only kernels; the whole-layer kernels stay off."""
    launches, model, widths = seq_phase(
        torch, tmp, "sasrec_attention", "SASRec", {"fused_attention": True}, 1,
        ("n_layers", "n_heads", "hidden_size", "inner_size", "MAX_ITEM_LIST_LENGTH",
         "attn_dropout_prob", "fused_attention", "train_batch_size"),
        ("fused_attention_fwd", "fused_attention_bwd", "onehot_matmul_grad", "adam_leaf",
         "masked_topk"),
        ("trm_layer_fwd", "trm_layer_bwd", "fused_transformer_layer_fwd",
         "fused_transformer_layer_bwd", "windowed_grad"))
    if tuple(widths.values()) != (2, 2, 64, 256, 50, 0.5, True, 2048):
        raise AssertionError(f"SASRec was not built at its default widths: {widths}")
    return launches


def seq_loaders(torch, tmp, model_name, extra):
    """Config and TO_LS loaders of the ml-1m-shaped file for a sequential
    model (written by phase_bpr)."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    config = Config(model_name, "ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "epochs": 1, "device": "cuda",
        "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False,
        **extra}, _parse_cmd_line=False)
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    t0 = time.time()
    train, valid, _ = data_preparation(config, create_dataset(config))
    log(f"[wide] ml-1m-shape TO_LS loaders at {config['MAX_ITEM_LIST_LENGTH']} positions in "
        f"{time.time() - t0:.1f}s")
    return train, valid


def short_run(torch, tmp, tag, model_name, extra, loaders, steps, must_launch, must_not):
    """``steps`` train steps and a full-sort valid pass of a sequential
    model through get_model -> get_trainer -> the trainer's step and
    evaluate, on the given loaders, with the launch counts set to 0 just
    before and read just after."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    train, valid = loaders
    config = Config(model_name, "ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "device": "cuda",
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False,
        **extra}, _parse_cmd_line=False)
    reset_launches()
    t0 = time.time()
    model = get_model(model_name)(config, train.dataset)
    trainer = get_trainer(config["MODEL_TYPE"], model_name)(config, model)
    trainer.prepare(train)
    mode = trainer._build_mode(train)
    B = train.batch_size
    losses = [mode["step"](trainer._take_batch(mode["tables"], torch.arange(
        i * B, (i + 1) * B, device="cuda")), mode["consts"]) for i in range(steps)]
    result = trainer.evaluate(valid, load_best_model=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(tag, must_launch)
    ran = {k: launches[k] for k in must_not if launches[k]}
    if ran:
        raise AssertionError(f"kernels off the {tag} path were launched: {ran}")
    losses = [float(x) for x in losses]
    log(f"[{tag}] {model_name} {extra}: {steps} steps at batch {B}, losses "
        f"{[round(x, 4) for x in losses]}, valid {json.dumps(result)}; {wall:.1f}s with the "
        "valid pass")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    check_result({"best_valid_result": result, "test_result": result}, JAX_ML100K)
    return launches


def phase_wide(torch, tmp):
    """Widths the kernels took only after their limits were lifted, a few
    steps each on the ml-1m-shaped file: GRU4Rec at hidden 10 (padded) and
    256 (wh in device memory), SASRec at hidden 128 (50 positions) and at
    200 positions, each under the default fused_attention "layer2", which
    routes around the whole-layer kernel, and under True."""
    off_gru = ("trm_layer_fwd", "fused_attention_fwd", "rel_apply_fwd")
    routed = ("trm_layer_fwd", "trm_layer_bwd", "fused_transformer_layer_fwd",
              "fused_transformer_layer_bwd", "fused_gru_fwd")
    out = {}
    loaders = seq_loaders(torch, tmp, "GRU4Rec", {})
    for hidden in (10, 256):
        out[f"gru4rec_h{hidden}"] = short_run(
            torch, tmp, f"gru4rec_h{hidden}", "GRU4Rec", {"hidden_size": hidden}, loaders, 5,
            ("fused_gru_fwd", "fused_gru_bwd"), off_gru)
    for fused in ("layer2", True):
        out[f"sasrec_d128_{fused}"] = short_run(
            torch, tmp, f"sasrec_d128_{fused}", "SASRec",
            {"hidden_size": 128, "fused_attention": fused}, loaders, 5,
            ("fused_attention_fwd", "fused_attention_bwd"), routed)
    loaders = seq_loaders(torch, tmp, "SASRec", {"MAX_ITEM_LIST_LENGTH": 200})
    for fused in ("layer2", True):
        out[f"sasrec_l200_{fused}"] = short_run(
            torch, tmp, f"sasrec_l200_{fused}", "SASRec",
            {"MAX_ITEM_LIST_LENGTH": 200, "fused_attention": fused}, loaders, 5,
            ("fused_attention_fwd", "fused_attention_bwd"), routed)
    return out


def write_ml1m_kg(directory, name, seed=43):
    """.kg and .link atomic files of the reference's ml-1m KG shape, by the
    recipe of scripts/bench_models.py:106-121: heads, tails and relations
    drawn uniformly (79,388 entities, 385,923 triples, 51 relations), each
    item linked to a distinct random entity."""
    n_ent, n_trip, n_rel = ML1M_KG
    rng = np.random.RandomState(seed)
    heads = rng.randint(0, n_ent, n_trip)
    tails = rng.randint(0, n_ent, n_trip)
    rels = rng.randint(0, n_rel, n_trip)
    with open(os.path.join(directory, f"{name}.kg"), "w") as fh:
        fh.write("head_id:token\trelation_id:token\ttail_id:token\n")
        np.savetxt(fh, np.stack([heads, rels, tails], axis=1), fmt="e%d\tr%d\te%d")
    ent = rng.choice(n_ent, ML1M[1], replace=False)
    with open(os.path.join(directory, f"{name}.link"), "w") as fh:
        fh.write("item_id:token\tentity_id:token\n")
        fh.writelines(f"{i + 1}\te{ent[i]}\n" for i in range(ML1M[1]))


def phase_ripplenet(torch, tmp):
    """RippleNet at its defaults under KGTrainer (rskg every epoch) on the
    ml-1m-shaped file with a KG of the reference's ml-1m KG shape, RO_RS,
    valid full sort, cut to 1 epoch, through Config -> data_preparation ->
    get_model -> get_trainer -> fit with validation -> evaluate(test); then
    20 steady steps under the profiler."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import KGTrainer, get_trainer
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    t0 = time.time()
    write_ml1m_kg(os.path.join(tmp, "data", "ml-1m-shape"), "ml-1m-shape")
    log(f"[ripplenet] wrote the ml-1m KG-shaped .kg and .link in {time.time() - t0:.1f}s")
    config = Config("RippleNet", "ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "epochs": 1, "device": "cuda",
        "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False},
        _parse_cmd_line=False)
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    t0 = time.time()
    train, valid, test = data_preparation(config, create_dataset(config))
    t_data = time.time() - t0
    full = train.full_dataset
    log(f"[ripplenet] dataset, KG remap, RO_RS splits and loaders in {t_data:.1f}s: "
        f"{full.user_num - 1} users, {full.item_num - 1} items, {full.entity_num} entities, "
        f"{full.relation_num} relation ids, {full.kg_num} triples; train {train.n} valid "
        f"{valid.n_eval_users} test {test.n_eval_users} users, eval batch {valid.batch_size}")
    t0 = time.time()
    model = get_model("RippleNet")(config, train.dataset)
    torch.cuda.synchronize()
    t_model = time.time() - t0
    widths = {k: config[k] for k in ("embedding_size", "n_hop", "n_memory", "kg_weight",
                                     "reg_weight", "train_batch_size")}
    log(f"[ripplenet] model built (build_ripple_sets included) in {t_model:.1f}s; set-up "
        f"{t_data + t_model:.1f}s; widths {widths}; compute dtype {model.compute_dtype}; "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    if tuple(widths.values()) != (64, 2, 16, 0.01, 1e-7, 2048) or model.bf16:
        raise AssertionError(f"RippleNet was not built at its defaults: {widths}")
    trainer = get_trainer(config["MODEL_TYPE"], "RippleNet")(config, model)
    if not isinstance(trainer, KGTrainer) or trainer.default_train_mode != "rskg":
        raise AssertionError("RippleNet does not train under KGTrainer's rskg mode")
    times, release = capture_epoch_times()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    best_score, best_valid = trainer.fit(train, valid, saved=False)
    test_result = trainer.evaluate(test, load_best_model=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches("ripplenet", ("rel_apply_fwd", "rel_apply_bwd", "adam_leaf"))
    release()
    off = ("masked_topk", "rel_apply_fwd_bf16", "rel_apply_bwd_bf16", "onehot_matmul_grad",
           "windowed_grad", "trm_layer_fwd", "fused_gru_fwd", "fused_attention_fwd")
    ran = {k: launches[k] for k in off if launches[k]}
    if ran:
        raise AssertionError(f"kernels off the ripplenet path were launched: {ran}")
    result = {"best_valid_result": best_valid, "test_result": test_result}
    log(f"[ripplenet] fit (1 epoch, validation) + test: {wall:.2f}s wall")
    log(f"[ripplenet] result {json.dumps(result)}")
    check_result(result, JAX_ML100K)
    steps = len(train)
    chunks = -(-full.item_num // 2048)
    log(f"[ripplenet] {steps} steps; launches per step: rel_apply_bwd "
        f"{launches['rel_apply_bwd'] / steps:.2f}, adam_leaf {launches['adam_leaf'] / steps:.2f};"
        f" rel_apply_fwd {launches['rel_apply_fwd']} = 1 a step + {chunks} an eval batch "
        "(one per item chunk)")
    log(f"[ripplenet] epoch seconds {times['train']} (includes the upload); train examples/s: "
        f"{train.n / times['train'][-1]:.1f}; ms/step: "
        f"{1e3 * times['train'][-1] / steps:.3f}")
    log(f"[ripplenet] full-sort valid pass seconds {times['eval']}")
    log(f"[ripplenet] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(torch, trainer, train, "ripplenet")
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

    from recbole_tpu_torch.ops import bit_kernels as bk
    before = (bk.bit_rows_matmul_cuda.launches, bk.bit_cols_matmul_cuda.launches)
    t0 = time.time()
    result = run_recbole(model="LightGCN", dataset="ml-100k", config_dict={
        **ML100K_LIGHTGCN, "valid_full_to_uni1000": False, "device": "cuda",
        "checkpoint_dir": os.path.join(tmp, "saved100k"),
        "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING",
        "show_progress": False})
    test = result["test_result"]
    ran = (bk.bit_rows_matmul_cuda.launches - before[0],
           bk.bit_cols_matmul_cuda.launches - before[1])
    log(f"[quality] ml-100k LightGCN (30 epochs, restricted step forced, early stopping on "
        f"mrr@10) {time.time() - t0:.1f}s; bit kernel launches {ran}; best valid "
        f"{result['best_valid_result']}")
    log(f"[quality]   test {json.dumps(test)}   JAX package (PARITY.md:45): recall@10 0.1848, "
        "original RecBole 0.1887")
    check_result(result, JAX_ML100K)
    if min(ran) <= 0:
        raise AssertionError("the ml-100k LightGCN run did not go through the bit kernels")
    if test["recall@10"] < LIGHTGCN_RECALL_FLOOR:
        raise AssertionError(f"ml-100k LightGCN test recall@10 {test['recall@10']} < "
                             f"{LIGHTGCN_RECALL_FLOOR}")

    from recbole_tpu_torch.ops import fused_gru as fg
    for model, ref in (("GRU4Rec", "0.1251-0.1357 (0.1230 in fp32 on the CPU)"),
                       ("NARM", "0.1273-0.1357")):
        before = fg.fused_gru_bwd_cuda.launches
        t0 = time.time()
        result = run_recbole(model=model, dataset="ml-100k", config_dict={
            **ML100K_GRU, "valid_full_to_uni1000": False, "device": "cuda",
            "checkpoint_dir": os.path.join(tmp, "saved100k"),
            "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING",
            "show_progress": False})
        test = result["test_result"]
        ran = fg.fused_gru_bwd_cuda.launches - before
        log(f"[quality] ml-100k {model} (TO_LS full-sort, 25 epochs, early stopping on mrr@10) "
            f"{time.time() - t0:.1f}s; fused_gru_bwd launches {ran}; best valid "
            f"{result['best_valid_result']}")
        log(f"[quality]   test {json.dumps(test)}   JAX package on a TPU, 3 seeds "
            f"(PARITY.md:93-160): recall@10 {ref}")
        check_result(result, JAX_ML100K)
        if ran <= 0:
            raise AssertionError(f"the ml-100k {model} run did not go through the GRU kernels")
        if test["recall@10"] < GRU_RECALL_FLOOR:
            raise AssertionError(f"ml-100k {model} test recall@10 {test['recall@10']} < "
                                 f"{GRU_RECALL_FLOOR}")

    from recbole_tpu_torch.ops import rel_apply as ra
    before = ra.rel_apply_bwd_cuda.launches
    t0 = time.time()
    result = run_recbole(model="RippleNet", dataset="ml-100k", config_dict={
        **ML100K_RIPPLE, "valid_full_to_uni1000": False, "device": "cuda",
        "checkpoint_dir": os.path.join(tmp, "saved100k"),
        "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING", "show_progress": False})
    test = result["test_result"]
    ran = ra.rel_apply_bwd_cuda.launches - before
    log(f"[quality] ml-100k RippleNet (RO_RS full-sort, 40 epochs, early stopping on mrr@10) "
        f"{time.time() - t0:.1f}s; rel_apply_bwd launches {ran}; best valid "
        f"{result['best_valid_result']}")
    log(f"[quality]   test {json.dumps(test)}   JAX package on the CPU, 3 seeds, same "
        f"protocol: recall@10 {RIPPLE_JAX_SPREAD}")
    check_result(result, JAX_ML100K)
    if ran <= 0:
        raise AssertionError("the ml-100k RippleNet run did not go through the rel_apply kernels")
    if test["recall@10"] < RIPPLE_RECALL_FLOOR:
        raise AssertionError(f"ml-100k RippleNet test recall@10 {test['recall@10']} < "
                             f"{RIPPLE_RECALL_FLOOR}")


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
    out.update(time_bit_kernels(torch))
    out.update(time_gru(torch))
    out.update(time_attention(torch))
    out.update(time_rel_apply(torch))
    return out


def time_bit_kernels(torch):
    """Both packed-bit kernels at the Yelp shape's two sides as a train step
    calls them (rows 2,048 users into the user image; rows 4,096 items into
    the item image), beside the plain version, the library's unpack + bf16
    product with fp32 results, and the bound: the distinct picked rows'
    packed bytes, the ids, the rows of v that a set bit touches (columns:
    g) and the output, each moved once; one fp32 add per set bit and
    column."""
    from recbole_tpu_torch.ops import bit_kernels as bk
    images = yelp_bit_inputs(torch, seed=7)
    out = {}
    rng = np.random.RandomState(23)
    for side, key in (("user", "user_side"), ("item", "item_side")):
        bits, rows, n_cols = images[side]
        R, nbytes, D = rows.numel(), bits.shape[1], 64
        v = torch.from_numpy(rng.randn(n_cols, D).astype(np.float32) * 0.1).cuda().bfloat16()
        g = torch.from_numpy(rng.randn(R, D).astype(np.float32) * 1e-3).cuda().bfloat16()
        unpacked = bk.unpack_bits(bits[rows])
        set_bits = int(unpacked.sum())
        touched = int(unpacked.any(dim=0).sum())
        distinct = int(torch.unique(rows).numel())
        del unpacked
        v_pad = bk.pad_k(v, nbytes * 8)

        def lib_rows():
            return torch.mm(bk.unpack_bits(bits[rows]).bfloat16(), v_pad, out_dtype=torch.float32)

        def lib_cols():
            return torch.mm(bk.unpack_bits(bits[rows]).bfloat16().T, g, out_dtype=torch.float32)

        work = {"bit_rows_matmul": (v, lib_rows, touched * D * 2 + R * D * 4),
                "bit_cols_matmul": (g, lib_cols, R * D * 2 + nbytes * 8 * D * 4)}
        for name, (x, lib, io_bytes) in work.items():
            kernel, plain = getattr(bk, f"{name}_cuda"), getattr(bk, f"{name}_torch")
            t = {"ms": cuda_ms(torch, lambda: kernel(bits, rows, x), 50),
                 "plain_ms": cuda_ms(torch, lambda: plain(bits, rows, x), 10),
                 "library_ms": cuda_ms(torch, lib, 10)}
            t["bound_ms"], t["bound_by"] = bound(float(set_bits * D),
                                                 distinct * nbytes + R * 8 + io_bytes)
            log(f"[time] {name} {side} side R={R} nbytes={nbytes} D={D} ({distinct} distinct "
                f"rows, {set_bits} set bits, {touched} columns touched): {t}")
            if side == "user":
                out[name] = t
            else:
                out[name][key] = t
        if side == "item":
            # where the row kernel's time goes: the positives are drawn by
            # popularity (the top item's row holds ~15,600 set bits), the
            # negatives uniformly
            for half, sl in (("positives", slice(0, R // 2)), ("negatives", slice(R // 2, R))):
                sub = rows[sl].contiguous()
                ms = cuda_ms(torch, lambda: bk.bit_rows_matmul_cuda(bits, sub, v), 50)
                out["bit_rows_matmul"][f"item_side_{half}_ms"] = ms
                log(f"[time] bit_rows_matmul item side, the {R // 2} {half} alone: {ms:.4f} ms, "
                    f"{int(bk.unpack_bits(bits[sub]).sum())} set bits")
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


def time_gru(torch):
    """Both GRU kernels, both instances, at GRU4Rec's step (B 2,048, L 50,
    H 128), beside the plain version, the bound and torch.nn.GRU (cuDNN;
    batch_first, weight_ih = wi^T, weight_hh = wh^T, the same biases; it
    also computes the (B L, 64) x (64, 384) input projection that the
    kernels take in as xi): forward, and forward + backward beside the
    backward kernel. The bound counts the recurrent products (2 B L H 3H
    forward; the backward's recompute, dhh wh^T and h^T dhh, three times
    that) at the fp32 rate (fp32 instance) or the bf16 tensor-core rate
    (bf16 instance), and xi, out (dout, dxi) moved once in the instance's
    type."""
    from recbole_tpu_torch.ops import fused_gru as fg
    B, L, E = (GRU4REC[k] for k in ("B", "L", "E"))
    out = {}
    # GRU4Rec's hidden 128 in both instances (wh in shared memory), then
    # hidden 256 in the bf16 instance (wh in device memory), the "h256" entry
    for H, bf16 in ((GRU4REC["H"], True), (GRU4REC["H"], False), (256, True)):
        xi, hinit, wh, bh, dout = gru_inputs(torch, B, L, H, 41, bf16, False)
        y = fg.fused_gru_fwd_cuda(xi, hinit, wh, bh)
        dt = torch.bfloat16 if bf16 else torch.float32
        rng = np.random.RandomState(42)
        wi = torch.from_numpy(rng.uniform(-0.1, 0.1, (E, 3 * H)).astype(np.float32)).cuda()
        lib = torch.nn.GRU(E, H, batch_first=True, device="cuda")
        with torch.no_grad():
            lib.weight_ih_l0.copy_(wi.T)
            lib.weight_hh_l0.copy_(wh.T)
            lib.bias_ih_l0.zero_()
            lib.bias_hh_l0.copy_(bh)
        lib = lib.to(dt)
        x = torch.from_numpy(rng.randn(B, L, E).astype(np.float32)).cuda().to(dt)
        xg = x.clone().requires_grad_(True)

        def lib_fwd():
            with torch.no_grad():
                return lib(x)[0]

        def lib_fwd_bwd():
            for prm in lib.parameters():
                prm.grad = None
            xg.grad = None
            lib(xg)[0].backward(dout)

        try:
            library = {"fwd": cuda_ms(torch, lib_fwd, 20),
                       "bwd": cuda_ms(torch, lib_fwd_bwd, 20)}
        except RuntimeError as exc:     # the yardstick only: a library without this dtype
            log(f"[time] nn.GRU in {dt} did not run: {exc}")
            library = {"fwd": None, "bwd": None}
        calls = {"fwd": (lambda: fg.fused_gru_fwd_cuda(xi, hinit, wh, bh),
                         lambda: fg.fused_gru_torch_fwd(xi, hinit, wh, bh, bf16)),
                 "bwd": (lambda: fg.fused_gru_bwd_cuda(xi, hinit, wh, bh, y, dout),
                         lambda: fg.fused_gru_torch_bwd(xi, hinit, wh, bh, y, dout, bf16))}
        elt = 2 if bf16 else 4
        for way, (kernel, plain) in calls.items():
            flops = 2.0 * B * L * H * 3 * H * (3 if way == "bwd" else 1)
            nbytes = B * L * (3 * H + H) * elt * (2 if way == "bwd" else 1) + \
                4 * (B * H * (2 if way == "bwd" else 1) + H * 3 * H + 3 * H)
            t = {"ms": cuda_ms(torch, kernel, 20), "plain_ms": cuda_ms(torch, plain, 5),
                 "library_ms": library[way]}
            t["bound_ms"], t["bound_by"] = bound(flops, nbytes,
                                                 PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
            key = f"fused_gru_{way}"
            if H != GRU4REC["H"]:
                out[key][f"h{H}"] = t
            elif bf16:
                out[key] = t
            else:
                out[key]["fp32"] = t
            log(f"[time] {key} {'bf16' if bf16 else 'fp32'} B={B} L={L} H={H} "
                f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; library nn.GRU {E}->{H} "
                f"with its input projection): {t}")
    return out


def time_attention(torch):
    """Both attention kernels at SASRec's step (B 2,048, L 50, H 2, hd 32),
    causal, dropout 0.5, beside the plain version (forward, and forward +
    autograd backward beside the backward kernel), the bound and
    F.scaled_dot_product_attention with a boolean mask in fp32 on inputs
    already in its (B, H, L, hd) layout (the transposes not counted), no
    dropout: forward, and forward + backward. The bound: q, k, v, the key
    validity (dO) in and o (dq, dk, dv) out once; the products over the
    L (L + 1) / 2 causal pairs (two forward, five backward)."""
    out = {}
    for L in (SASREC["L"], 200):
        for way, t in time_attention_at(torch, L).items():
            key = f"fused_attention_{way}"
            if L == SASREC["L"]:
                out[key] = t
            else:
                out[key][f"L{L}"] = t
    return out


def time_attention_at(torch, L):
    """time_attention at L positions: {"fwd": {...}, "bwd": {...}}."""
    from torch.nn import functional as F
    from recbole_tpu_torch.ops import fused_attention as fa
    B, H = SASREC["B"], SASREC["H"]
    hd = SASREC["D"] // H
    q, k, v, valid, do = attention_inputs(torch, B, L, H, hd, 51, empty_row=False)
    seed = torch.tensor([51], dtype=torch.int64, device="cuda")
    masks = fa.fused_attention_dropout_masks_cuda(seed, B, H, L, 0.5)
    kw = dict(causal=True, rate=0.5)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    allowed = (valid[:, None, None, :] > 0) & torch.tril(
        torch.ones(L, L, dtype=torch.bool, device="cuda"))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (qt, kt, vt))
    pq, pk, pv = (t.clone().requires_grad_(True) for t in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)

    def lib_bwd():
        for t in (qg, kg, vg):
            t.grad = None
        F.scaled_dot_product_attention(qg, kg, vg, attn_mask=allowed).backward(dot)

    def plain_bwd():
        for t in (pq, pk, pv):
            t.grad = None
        fa.fused_attention_torch(pq, pk, pv, valid, True, 0.5, masks=masks).backward(do)

    o, stats = fa.fused_attention_fwd_cuda(q, k, v, valid, seed, with_stats=True, **kw)
    calls = {"fwd": (lambda: fa.fused_attention_fwd_cuda(q, k, v, valid, seed, **kw),
                     lambda: fa.fused_attention_torch(q, k, v, valid, True, 0.5, masks=masks),
                     lib_fwd),
             "bwd": (lambda: fa.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o,
                                                         stats=stats, **kw),
                     plain_bwd, lib_bwd)}
    pairs = L * (L + 1) // 2
    slab = B * L * H * hd * 4
    out = {}
    for way, (kernel, plain, lib) in calls.items():
        flops = 2.0 * B * H * pairs * hd * (5 if way == "bwd" else 2)
        nbytes = slab * (7 if way == "bwd" else 4) + B * L * 4
        t = {"ms": cuda_ms(torch, kernel, 50), "plain_ms": cuda_ms(torch, plain, 20),
             "library_ms": cuda_ms(torch, lib, 50)}
        t["bound_ms"], t["bound_by"] = bound(flops, nbytes)
        out[way] = t
        log(f"[time] fused_attention_{way} B={B} L={L} H={H} hd={hd} causal, dropout 0.5 "
            f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB): {t}")
    return out


def time_rel_apply(torch):
    """Both rel_apply kernels, both instances, at RippleNet's step (N 131,072
    rows, D 64, 53 relation ids, uniform), beside the plain version (one
    product per relation), the bound, and the library yardstick: R gathered
    by rel, then torch.bmm (forward; forward + autograd backward beside the
    backward kernel). The masked per-relation loop that RippleNet's XLA path
    runs (53 passes over all rows) is logged beside it. The bound: v, rel, R
    and y (backward: v, rel, R, dy, dv, dR) moved once, 2 N D^2 operations
    forward and 4 N D^2 backward at the fp32 rate (fp32 instance) or the
    bf16 tensor-core rate (bf16 instance)."""
    from recbole_tpu_torch.ops import rel_apply as ra
    N = 2 * RIPPLENET["B"] * RIPPLENET["hops"] * RIPPLENET["M"]
    D, NR = RIPPLENET["D"], ML1M_KG[2] + 2
    v, rel, R, dy = rel_inputs(torch, N, D, NR, 61)
    rel64 = rel.long()
    vg, Rg = v.clone().requires_grad_(True), R.clone().requires_grad_(True)

    def lib_fwd():
        return torch.bmm(R[rel64], v[:, :, None])[:, :, 0]

    def lib_bwd():
        vg.grad = Rg.grad = None
        torch.bmm(Rg[rel64], vg[:, :, None])[:, :, 0].backward(dy)

    def masked_loop():
        out = torch.zeros_like(v)
        for r in range(NR):
            out += ((rel64 == r).to(v.dtype)[:, None] * v) @ R[r].T
        return out

    out = {}
    loop_ms = cuda_ms(torch, masked_loop, 10)
    for bf16 in (False, True):
        calls = {"fwd": (lambda: ra.rel_apply_fwd_cuda(v, rel, R, bf16=bf16),
                         lambda: ra.rel_apply_torch(v, rel, R, bf16), lib_fwd),
                 "bwd": (lambda: ra.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16),
                         lambda: ra.rel_apply_torch_bwd(v, rel, R, dy, bf16), lib_bwd)}
        for way, (kernel, plain, lib) in calls.items():
            flops = 2.0 * N * D * D * (2 if way == "bwd" else 1)
            nbytes = 4 * (N * D * (3 if way == "bwd" else 2) + N
                          + NR * D * D * (2 if way == "bwd" else 1))
            t = {"ms": cuda_ms(torch, kernel, 50), "plain_ms": cuda_ms(torch, plain, 10),
                 "library_ms": cuda_ms(torch, lib, 20)}
            t["bound_ms"], t["bound_by"] = bound(flops, nbytes,
                                                 PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
            key = f"rel_apply_{way}"
            if bf16:
                out[key]["bf16"] = t
            else:
                out[key] = t
            log(f"[time] {key} {'bf16' if bf16 else 'fp32'} N={N} D={D} NR={NR} "
                f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; library: R[rel] gathered, "
                f"then torch.bmm): {t}")
    log(f"[time] rel_apply forward as RippleNet's XLA path computes it (53 masked passes over "
        f"all rows, fp32): {loop_ms:.4f} ms")
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
    "bit_rows_matmul": {"route": "cuda", "source": "recbole_tpu_torch/csrc/bit_kernels.cu",
                        "replaces": "recbole_tpu/ops/bit_kernels.py:56"},
    "bit_cols_matmul": {"route": "cuda", "source": "recbole_tpu_torch/csrc/bit_kernels.cu",
                        "replaces": "recbole_tpu/ops/bit_kernels.py:95"},
    # the GRU recurrence, both instances together (bf16: gru_apply's rounding
    # points; fp32: fused_gru's math); the timing's "fp32" entry is the fp32
    # instance's
    "fused_gru_fwd": {"route": "cuda", "source": "recbole_tpu_torch/csrc/fused_gru.cu",
                      "replaces": "recbole_tpu/ops/fused_gru.py:192"},
    "fused_gru_bwd": {"route": "cuda", "source": "recbole_tpu_torch/csrc/fused_gru.cu",
                      "replaces": "recbole_tpu/ops/fused_gru.py:192"},
    "fused_attention_fwd": {"route": "cuda",
                            "source": "recbole_tpu_torch/csrc/fused_attention.cu",
                            "replaces": "recbole_tpu/ops/fused_attention.py:204"},
    "fused_attention_bwd": {"route": "cuda",
                            "source": "recbole_tpu_torch/csrc/fused_attention.cu",
                            "replaces": "recbole_tpu/ops/fused_attention.py:204"},
    # the relation apply, both instances together (fp32: RippleNet's
    # default; bf16: the TPU kernel's rounding points); the timing's "bf16"
    # entry is the bf16 instance's
    "rel_apply_fwd": {"route": "cuda", "source": "recbole_tpu_torch/csrc/rel_apply.cu",
                      "replaces": "recbole_tpu/ops/rel_apply.py:113"},
    "rel_apply_bwd": {"route": "cuda", "source": "recbole_tpu_torch/csrc/rel_apply.cu",
                      "replaces": "recbole_tpu/ops/rel_apply.py:113"},
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
                            check_adam(torch, SASREC_LEAF_SHAPES, seed=16),
                            check_adam(torch, LIGHTGCN_LEAF_SHAPES, seed=18))}
    for kname, cases in embed_grad_cases(torch).items():
        err[kname] = check_embed_grad(torch, kname, cases)
    err.update(check_trm_layer(torch))
    err.update(check_bit_kernels(torch, yelp_bit_inputs(torch)))
    err.update(check_gru(torch))
    err.update(check_attention(torch))
    err.update(check_rel_apply(torch))
    torch.cuda.empty_cache()
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        by_path["bpr"] = phase_bpr(torch, tmp)
        by_path["deepfm"] = phase_deepfm(torch, tmp)
        by_path["sasrec"] = phase_sasrec(torch, tmp)
        by_path["sasrec_fp32"] = phase_sasrec_fp32(torch, tmp)
        by_path["lightgcn"] = phase_lightgcn(torch, tmp)
        by_path["gru4rec"] = phase_gru4rec(torch, tmp)
        by_path["narm"] = phase_narm(torch, tmp)
        by_path["sasrec_attention"] = phase_sasrec_attention(torch, tmp)
        by_path.update(phase_wide(torch, tmp))
        by_path["ripplenet"] = phase_ripplenet(torch, tmp)
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
