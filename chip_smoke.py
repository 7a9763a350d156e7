#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (recbole_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. device: the card's name, count, and nvidia-smi's name and power limit;
  2. build: nvcc builds the eight csrc/*.cu, one process per source, all at
     once (its -Xptxas -v report is printed);
  3. each kernel against its plain PyTorch version, on the card, at the main
     paths' shapes and at edge shapes, and twice on the same input to
     compare the two results bit for bit; Adam over each main path's whole
     leaf set at once (BPR's, DeepFM-Criteo's, SASRec's 36 with the [PAD]
     row's zero head, LightGCN's) and over unaligned leaves, a leaf without
     a gradient and a 0-d one, and with weight decay 1e-8 and 1e-2 over
     MFSimple's leaves at the ml-1m shape, BPR's and SASRec's and the edge
     leaves, and with the clip on both sides of max_norm and adamw's
     decoupled term over SASRec's and the edge leaves, each the plain
     version's bits; the masked top-k's bf16-operand instance at SASRec's,
     BPR's and ml-100k's fused passes, past one K chunk and through the
     dispatcher's padding; the whole-layer transformer
     kernels in both instances (bf16-rounded operands, and fp32 ones as
     3xTF32 products), forward and backward, with dropout off and on (the
     plain version is handed the masks the kernels draw), with the worst
     relative error per tensor, at SASRec's step beside the fp32 FMA
     kernels' last; the packed-bit row and column kernels on the
     Yelp shape's packed rows and on random bytes; the GRU recurrence
     kernels in both instances, forward and backward, at GRU4Rec's and
     NARM's step (the bf16 instance on the one-block tensor-core route, the
     fp32 one on the one-block 3xTF32 route), ragged train and eval batches, with zero and
     nonzero h0, and a two-layer stack, and at H 132, 256 and the cluster limit (the bf16
     instance's cluster kernels, the fp32 instance's wh in device memory),
     the limit + 4, H 704 (the global route at 8 sequences a block) and H 10
     (zero-padded; the one-block routes' dead units past H); the
     attention-only kernels on both routes (the whole
     sequence at L 50, the key tiles at L 200), causal and bidirectional,
     dropout off and on, with a sequence that has no valid key, and at head
     width 132 on each route; the rel_apply kernels in both
     instances, forward and backward, at RippleNet's step and at edge
     shapes, and the backward under autograd on the forward's buckets
     (the same bits, at most 3 and 2 kernels a call); and the widths the
     kernels refuse, through their dispatchers: the masked top-k at D 10
     and 6 (zero-padded), rel_apply at D 18 (padded) and 256 (square
     blocks of 128 composed), both instances, forward and backward, and
     both packed-bit kernels at D 65 (padded) and 256 (128-column slices)
     on the Yelp-shaped images;
  4. the main paths, each with every kernel's launch count set to 0 just
     before and read just after (each kernel of the path must be > 0, and
     the Adam kernel must launch exactly once a training step):
     a. run_recbole(model="BPR") for 1 epoch on an ml-1m-shaped dataset
        written from a seed;
     b. DeepFM at the full Criteo width (13 float + 26 token fields, a
        (2,565,692, 11) merged table, batch 2048, 2,292,530 rows from a
        seed) through Config -> data_preparation -> get_model ->
        get_trainer -> fit with validation -> evaluate(test), 1 epoch;
     c. run_recbole(model="SASRec") at its default widths (2 layers, 2
        heads, hidden 64, inner 256, 50 positions, dropout 0.5, CE) for 1
        epoch on the same ml-1m-shaped file under TO_LS,full, then 20
        steps under torch.profiler, and a valid pass of the trained model
        with bf16 scores (the masked top-k's bf16 instance) and one with
        GAUC (the non-fused step); and one epoch of the same model on
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
        1 epoch, then 20 steps under torch.profiler; every GRU launch on
        the one-block tensor-core route;
     f. NARM at its defaults (embedding 64, hidden 128, dropouts 0.25 and
        0.5, CE; its GRU in fp32) on the same file, 1 epoch; every GRU
        launch on the one-block 3xTF32 route;
     g. SASRec at its default widths with fused_attention True (the
        attention-only kernel) on the same file, 1 epoch;
     h. a few steps and a valid pass at widths the kernels took only after
        their limits were lifted: GRU4Rec at hidden 10 (the tensor-core
        route's dead units), 256 (the bf16
        instance's cluster kernels, which must launch) and 704 (the global
        route), SASRec at hidden 128 (the attention kernels' whole-sequence
        route) and at 200 positions (their key tiles) under the default
        fused_attention "layer2" (routed around the whole-layer kernel) and
        True, and SASRec at its defaults with fused_attention "layer" under
        bfloat16 (the attention path, as the JAX package takes it);
     i. RippleNet at its defaults (embedding 64, 2 hops, 16 memories,
        batch 2048) under KGTrainer on the ml-1m-shaped file with a KG of
        the reference's ml-1m KG shape (79,388 entities, 385,923 triples, 51
        relations, written from a seed), 1 epoch, then 20 steps under
        torch.profiler;
     j. CKE, CFKG, KGCN and KGNNLS (KGTrainer, rskg, 1 epoch each), KTUP
        (KGTrainer with train_rec_step and train_kg_step 1: an rs epoch,
        then a kg epoch) and MKR (MKRTrainer: epoch 0 runs rs_only_loss and
        kg) at their default_config widths on the same file and KG, then
        20 steps each under torch.profiler; no kernel but Adam may launch;
     k. the routed widths: BPR at embedding_size 10 (the masked top-k on
        padded columns) and at topk [200] (the non-fused step: the masked
        top-k must not launch), 1 epoch each, and 5 steps and a valid pass
        of RippleNet at embedding_size 18 and 256 and of LightGCN's
        restricted step at 65 and 256;
     l. KGAT at its default_config (embedding 64, one layer: the dense path,
        batch 2048) under KGATTrainer on the ml-1m-shaped file and KG: 1
        epoch (an rs pass, a kg pass, the attention update), a valid pass,
        20 profiled rs steps, the attention update's ms; then 5 steps and a
        valid pass at layers [64, 32, 16] (the ELL path); Adam only;
     m. the fork's protocols, 1 epoch each: BPR with valid_full_to_uni1000
        (a uniform-1,000 sampled valid pass; the masked top-k in the test
        pass alone), SASRec under TO_LS,uni100, and on a labeled copy of the
        file (a rating 1-5 from a seed, threshold {rating: 4}) MFSimple with
        dataset negatives both ways, MFSimple with the both-way sampler at
        k 3, and GMF, MLP and NCF at their defaults (weight decay 1e-8 in
        the Adam kernel), and a valid pass of NCF with bf16 scores (the
        chunked score_items on bf16-rounded parameters);
     n. the transformer users at their default_config widths on the
        ml-1m-shaped file with an ml-1m-shaped item file written from a
        seed (title words, release year, 1-6 of 18 genres), TO_LS,full, 1
        epoch each, then 20 steps each under torch.profiler: BERT4Rec (the
        fp32 whole-layer kernels' bidirectional instance at 51 positions),
        SASRecF and FDSA (item features; FDSA's two encoders), GCSAN, and
        S3Rec's pretraining epoch under S3RecTrainer and a finetuning epoch
        from its checkpoint;
     o. the GRU users GRU4RecF, RepeatNet, DIN, DIEN, GRU4RecKG and KSR,
        then STAMP and SRGNN, at their default_config widths on the same
        file (with an ml-1m-shaped user file and KG preload tables), 1
        epoch each and a test pass, then 20 steps each under
        torch.profiler (DIEN and KSR 5);
     p. the last nine sequential models (Caser, NextItNet, TransRec,
        FPMC, HGN, HRM, NPE, SHAN, FOSSIL) on one set of TO_LS full-sort
        loaders of the same file, and the five context models FFM, FwFM,
        FNN, WideDeep and xDeepFM on one set at the DeepFM-Criteo shape,
        each at its default_config: 200 train steps, a valid and a test
        pass, then 5 steps under torch.profiler; Adam on every path, the
        one-hot gradient on every sequential one but TransRec's and
        FPMC's, the masked top-k on the seven that keep the sequential
        base's scoring, the one-hot and windowed gradients on the context
        ones;
  5. quality on the bundled ml-100k under PARITY.md's protocols: BPR's,
     SASRec's, BERT4Rec's and FDSA's (5 epochs), LightGCN's, GRU4Rec's,
     NARM's, RippleNet's and the seven knowledge models' (10 epochs) test
     recall@10 and DeepFM's test AUC,
     and MFSimple's test recall@10 under the fork's labeled protocol,
     GRU4RecF's, RepeatNet's, KSR's, Caser's and FPMC's (5 epochs) test
     recall@10 and xDeepFM's (10 epochs) test AUC, each
     held to a floor; BPR's best valid recall@10 under the uniform-1,000
     validation beside the JAX package's;
  6. timing with CUDA events at the main paths' shapes: kernel, plain
     version, the one-call library yardstick, and the card's bound for the
     same work; Adam over each main path's leaf set and the embedding
     gradients also in a CUDA graph, Adam with the host's time a call; the
     embedding gradients with the
     kernels a call launches (the windowed path at DeepFM-Criteo's large
     fields and at a LightGCN step's two tables); the masked top-k, the
     relation apply and the packed-bit kernels also at the routed widths;
     Adam over MFSimple's leaves without and with weight decay, the library
     call with the same decay; the masked top-k's bf16 instance (row 1b)
     at row 1's shape and ml-100k's, against a bf16 matmul with fp32
     output, masked_fill and topk; Adam over SASRec's leaves with the clip
     (row 2f: the norm, the kernel, the clipped step), against
     clip_grad_norm_ and Adam(fused=True).

It prints a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero. It
imports nothing of JAX or of the JAX package recbole_tpu.
"""

import gc
import glob
import itertools
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
# cores, bf16 and TF32 in them (dense), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES = 3.35e12

# ml-1m's shape (users, items, interactions)
ML1M = (6040, 3706, 1_000_209)
# the epochs of BPR, DeepFM-Criteo, SASRec and GRU4Rec on the ml-1m-shaped
# files (cut from 2 to 1 for the run's time limit: their steady steps are
# measured under the profiler)
ML1M_EPOCHS = 1
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
# the leaves Adam sweeps in one FFM step at that shape (phase 4p): the
# context family's first four, then the (ids, fields, 10) field-aware token
# table (1,000,619,880 elements, 4.0 GB: past 2^32 bytes) and the float one
FFM_FIELDS = len(CRITEO["vocabs"]) + CRITEO["n_float"]
FFM_LEAF_SHAPES = DEEPFM_LEAF_SHAPES[:4] + [(sum(CRITEO["vocabs"]), FFM_FIELDS, 10),
                                            (CRITEO["n_float"], FFM_FIELDS, 10)]
# the 36 leaves Adam sweeps in one SASRec step at the ml-1m shape: item and
# position embeddings, the input LayerNorm, and per layer the four (64, 64)
# projections, their four biases, two LayerNorms, and the FFN's two matrices
# and biases
SASREC_LAYER_LEAF_SHAPES = [(64, 64)] * 4 + [(64,)] * 8 + [(64, 256), (256,), (256, 64), (64,)]
SASREC_LEAF_SHAPES = [(ML1M[1] + 1, 64), (50, 64), (64,), (64,)] + SASREC_LAYER_LEAF_SHAPES * 2
# BPR's two tables at the ml-1m shape ([PAD] included)
BPR_LEAF_SHAPES = [(ML1M[0] + 1, 64), (ML1M[1] + 1, 64)]
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
# BERT4Rec and FDSA on ml-100k under the same protocol, 5 epochs: test
# recall@10 of the JAX package on the CPU at seeds 2020 / 2021 / 2022
# (python run.py --model=<M> --dataset=ml-100k --epochs=5 --seed=<s>
# --eval_setting=TO_LS,full --training_neg_sample_num=0
# --valid_full_to_uni1000=False; FDSA with --load_col="{'inter': ['user_id',
# 'item_id', 'rating', 'timestamp'], 'item': '*'}"), and the floor, about
# 0.9x the lowest
ML100K_TRM_EPOCHS = 5
ML100K_TRM = {"BERT4Rec": ("0.0498 / 0.0530 / 0.0626", 0.045),
              "FDSA": ("0.0817 / 0.0806 / 0.0827", 0.072)}
# RecBole's atomic ml-1m .item: title words, release years, 18 genres
ML1M_TITLE_WORDS, ML1M_YEARS, ML1M_GENRES = 4000, (1919, 2000), 18

# the Yelp shape the reference times LightGCN on (users, items, interactions;
# asset/time_test_result/General_recommendation.md:123-140, the shape of
# scripts/bench_scale.py)
YELP = (102_046, 98_408, 2_905_370)
# the two embedding tables Adam sweeps in a LightGCN step at that shape
# ([PAD] included)
LIGHTGCN_LEAF_SHAPES = [(YELP[0] + 1, 64), (YELP[1] + 1, 64)]
# each main path's leaf set, with each leaf's zero head (the [PAD] row of a
# pad_zero_params table: SASRec's item_embedding)
ADAM_SETS = {"bpr": (BPR_LEAF_SHAPES, [0, 0]),
             "deepfm_criteo": (DEEPFM_LEAF_SHAPES, [0] * len(DEEPFM_LEAF_SHAPES)),
             "sasrec": (SASREC_LEAF_SHAPES, [64] + [0] * (len(SASREC_LEAF_SHAPES) - 1)),
             "lightgcn": (LIGHTGCN_LEAF_SHAPES, [0, 0])}
# MFSimple's five leaves at the ml-1m shape (embedding_dimension 128; user,
# item and global biases; [PAD] included), which train with weight_decay
# 1e-8, as GMF's, MLP's and NCF's do
MFSIMPLE_LEAF_SHAPES = [(ML1M[0] + 1, 128), (ML1M[1] + 1, 128), (ML1M[0] + 1,), (ML1M[1] + 1,),
                        (1,)]
# the leaf sets Adam's weight decay is checked on, and the decays: the four
# baselines' default 1e-8, and 1e-2, where the term moves every element
ADAM_WD_SETS = {"mfsimple": (MFSIMPLE_LEAF_SHAPES, [0] * 5), "bpr": ADAM_SETS["bpr"],
                "sasrec": ADAM_SETS["sasrec"]}
ADAM_WDS = (1e-8, 1e-2)
# the clip's norm by the norm kernels against global_grad_norm: the same
# fp32 squares summed in another order
NORM_RTOL = 1e-5
# an Adam timing takes copies of a smaller leaf set in turn, so that this
# many bytes, three times the H100's 50 MB L2, pass between two calls on one
# copy (adam_copies)
ADAM_ROTATE_BYTES = 150 << 20
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
# the GRU's routes by fused_gru_route's number (0, the fp32 FMA kernels, is
# no longer taken)
GRU_ROUTES = {1: "cluster", 2: "device memory", 3: "device memory, rows in device memory",
              4: "tensor cores, one block", 5: "3xTF32 tensor cores, one block"}
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

# DIEN's extractor GRU at the ml-1m-shaped item file: H = fields x
# embedding size = (the id, title, year, genre) x 10, on the pointwise train
# batch (2,048 rows and a negative each) and the eval pair block (4,096)
DIEN_GRU = dict(B=4096, L=50, H=40)
# RecBole's atomic ml-1m .user: ages, 21 occupations, zip codes (3,439 in
# ml-1m)
ML1M_AGES, ML1M_OCCUPATIONS, ML1M_ZIPS = (1, 18, 25, 35, 45, 50, 56), 21, 3439
# the pretrained KG tables that GRU4RecKG and KSR take as preload_weight,
# written from a seed at the ml-1m KG shape: an entity vector a KG entity,
# a relation vector a relation
KG_PRELOAD_DIM = 64
# the GRU users on ml-100k under the TO_LS full-sort protocol, 5 epochs:
# test recall@10 of the JAX package on the CPU at seeds 2020 / 2021 / 2022
# (python run.py --model=<M> --dataset=ml-100k --epochs=5 --seed=<s>
# --eval_setting=TO_LS,full --training_neg_sample_num=0
# --valid_full_to_uni1000=False; GRU4RecF with --load_col="{'inter':
# ['user_id', 'item_id', 'rating', 'timestamp'], 'item': '*'}"; KSR with the
# bundled .kg and .link and random entity and relation tables), and the
# floor, about 0.9x the lowest
ML100K_GRU_USERS_EPOCHS = 5
ML100K_GRU_USERS = {"GRU4RecF": ("0.1241 / 0.1188 / 0.1092", 0.098),
                    "RepeatNet": ("0.0880 / 0.0827 / 0.0954", 0.074),
                    "KSR": ("0.0806 / 0.0997 / 0.0689", 0.062)}

# the last nine sequential models and five context models (phase 4p): the
# train steps each takes at its default_config before a valid and a test
# pass (a cut: an ml-1m-shaped epoch is 480 steps, a Criteo-shaped one
# 896), and its profiled steady steps
REST_STEPS, REST_PROFILED = 200, 5
# the kernels a path of phase 4p must not launch unless it names them:
# no transformer, attention, GRU, relation or packed-bit kernel is on any
# of their paths
REST_KERNELS = ("masked_topk", "onehot_matmul_grad", "windowed_grad", "trm_layer_fwd",
                "fused_transformer_layer_fwd", "fused_attention_fwd", "fused_attention_whole_fwd",
                "fused_gru_fwd", "rel_apply_fwd", "bit_rows_matmul", "bit_cols_matmul")


def rest_off(must):
    """The kernels of REST_KERNELS a phase 4p path does not name."""
    return tuple(k for k in REST_KERNELS if k not in must)

# Caser and FPMC on ml-100k under the TO_LS full-sort protocol, 5 epochs,
# and xDeepFM under DeepFM's CTR protocol (ML100K_CTR), 10 epochs: test
# recall@10 and test AUC of the JAX package on the CPU at seeds 2020 /
# 2021 / 2022 (python run.py --model=<M> --dataset=ml-100k --epochs=5
# --seed=<s> --eval_setting=TO_LS,full --training_neg_sample_num=<0;
# FPMC 1, its pairwise default> --valid_full_to_uni1000=False; Caser with
# --scan_epochs=False, whose scanned epoch did not finish in 30 minutes
# on the CPU; xDeepFM --epochs=10 --threshold="{'rating': 4}" and
# ML100K_CTR's load_col), and the floor, about 0.9x the lowest
ML100K_REST = {"Caser": ("recall@10", 5, "0.0721 / 0.0764 / 0.0636", 0.057),
               "FPMC": ("recall@10", 5, "0.0806 / 0.0647 / 0.0795", 0.058),
               "xDeepFM": ("auc", 10, "0.7702 / 0.7745 / 0.7703", 0.693)}

# masked_topk: the kernel's fp32 sums run in another order than cuBLAS's
TOPK_RTOL, TOPK_ATOL = 1e-5, 1e-6
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


def kernel_name(key):
    """A profiler key without its return type, namespace and arguments."""
    key = key.removeprefix("void ").split("(anonymous namespace)::")[-1]
    return key.split("(")[0].split("<")[0]


def kernels_per_call(torch, fn, calls=20):
    """{kernel: [launches, device ms] per call of ``fn``} by torch.profiler:
    the kernels one wrapper call launches on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            name = kernel_name(e.key)
            n, ms = out.get(name, (0.0, 0.0))
            out[name] = [n + e.count / calls, ms + us / calls / 1e3]
    return out


def host_ms(torch, fn, calls=100):
    """Host milliseconds per call of ``fn`` (the enqueue, no wait for the
    card): what a host-bound step pays for it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def graph_ms(torch, fn, calls=20, replays=20):
    """Milliseconds per call of ``fn`` with ``calls`` calls captured in one
    CUDA graph, over ``replays`` replays after a warm-up: the device's time,
    without the host's launch rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


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


def lightgcn_grad_inputs(torch, seed=17):
    """A LightGCN step's dense gradients at the Yelp shape: the restricted
    backward's batch users (R 2,048, uniform) into the user table and its
    items (R 4,096, power-law) into the item table, with a (4,096, 64)
    cotangent (the users take its first 2,048 rows)."""
    rng = np.random.RandomState(seed)
    users = torch.from_numpy(rng.randint(1, YELP[0] + 1, 2048).astype(np.int64)).cuda()
    items = torch.from_numpy((1 + np.floor(YELP[1] * rng.random_sample(4096) ** 2.2))
                             .astype(np.int64)).cuda()
    g = torch.from_numpy(rng.randn(4096, 64).astype(np.float32) * 1e-3).cuda()
    return users, items, g


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


def write_rows(fh, cols):
    """Integer columns as tab-separated rows (pandas' writer: about 2.5x
    np.savetxt's speed at the Yelp shape's 2.9M rows)."""
    import pandas as pd
    pd.DataFrame({i: c for i, c in enumerate(cols)}).to_csv(fh, sep="\t", header=False,
                                                            index=False)


def write_ml1m_shape(path, seed=42, rating_seed=None):
    """An atomic .inter file of ml-1m's shape: uniform users, power-law
    items (the draw of bench.py's synth_ml1m). With ``rating_seed`` the same
    rows with a rating column, 1 to 5 drawn uniformly from that seed (a
    labeled copy, for the fork's threshold protocols)."""
    n_users, n_items, n_inter = ML1M
    rng = np.random.RandomState(seed)
    uids = rng.randint(1, n_users + 1, size=n_inter)
    iids = 1 + np.floor((n_items - 1) * rng.random_sample(n_inter) ** 2.2).astype(np.int64)
    ts = np.arange(n_inter)
    cols, head = [uids, iids, ts], "user_id:token\titem_id:token\ttimestamp:float"
    if rating_seed is not None:
        cols.insert(2, np.random.RandomState(rating_seed).randint(1, 6, n_inter))
        head = "user_id:token\titem_id:token\trating:float\ttimestamp:float"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(head + "\n")
        write_rows(fh, cols)


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
        write_rows(fh, [uids, iids, np.arange(len(uids))])


def yelp_bit_inputs(torch, seed=42):
    """The two packed images of the Yelp-shaped draw on the card (raw ids,
    [PAD] row 0 empty), each image's set bits a row (int32, as
    ``BitRestrictedGraph`` keeps them; counted on the card), and a train
    batch's rows: 2,048 users, and 4,096 items (2,048 positives drawn from
    the interactions, 2,048 uniform negatives)."""
    from recbole_tpu_torch.ops.bitgraph import _pack_side
    uids, iids = yelp_draw(seed)
    n_u, n_i = YELP[0] + 1, YELP[1] + 1
    user_bits = torch.from_numpy(_pack_side(uids, iids, n_u, n_i)).cuda()
    item_bits = torch.from_numpy(_pack_side(iids, uids, n_i, n_u)).cuda()
    user_counts, item_counts = row_popcounts(torch, user_bits), row_popcounts(torch, item_bits)
    rng = np.random.RandomState(seed + 1)
    pick = rng.randint(0, len(uids), 2048)
    rows_u = torch.from_numpy(uids[pick].astype(np.int64)).cuda()
    rows_i = torch.from_numpy(np.concatenate(
        [iids[pick], rng.randint(1, n_i, 2048)]).astype(np.int64)).cuda()
    return {"user": (user_bits, rows_u, n_i, user_counts),
            "item": (item_bits, rows_i, n_u, item_counts)}


def row_popcounts(torch, bits):
    """(n_major,) int32 set bits of each row of a packed image on the card,
    8,192 rows at a time."""
    table = torch.tensor([bin(b).count("1") for b in range(256)], dtype=torch.int32,
                         device=bits.device)
    return torch.cat([table[bits[i:i + 8192].int()].sum(1, dtype=torch.int32)
                      for i in range(0, bits.shape[0], 8192)])


def distinct_set_bits(torch, bits, rows):
    """(all picked rows' set bits, the distinct picked rows' set bits)."""
    from recbole_tpu_torch.ops import bit_kernels as bk
    return (int(bk.unpack_bits(bits[rows]).sum()),
            int(bk.unpack_bits(bits[torch.unique(rows)]).sum()))


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
    t0 = time.time()
    logs = cuda_build.build(["masked_topk", "fused_adam", "embed_grad", "trm_layer",
                             "bit_kernels", "fused_gru", "fused_attention", "rel_apply"])
    log(f"[build] nvcc {time.time() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            log(f"[build] {name}: {line.strip()}")


def check_topk(torch, B, N, D, k, seed, pad_only=False, dup=False, dispatch=False, bf16=False):
    """``bf16``: the bf16-operand instance (eval_score_dtype bfloat16), q
    and items rounded to bf16, against the plain version on the same
    operands. ``pad_only``: the mask a sequential full-sort pass gives, column 0
    ([PAD]) set and nothing else, in place of a user's history. ``dup``: row
    0's best item copied either side of every boundary between the kernel's
    slices of the item axis (ties across slices). ``dispatch``: through the
    dispatcher, which zero-pads a D the kernel refuses (not a multiple of 4)
    around one launch. Every case also holds the output in (value desc, id
    asc) order and two runs to the same bits."""
    from recbole_tpu_torch.ops.masked_topk import (masked_topk, masked_topk_cuda,
                                                   masked_topk_plan, masked_topk_torch)
    q, items, mask = topk_inputs(torch, B, N, D, seed)
    if bf16:
        q, items = q.to(torch.bfloat16), items.to(torch.bfloat16)
    if pad_only:
        mask.zero_()
        mask[:, 0] = 1
    if dup:
        best = int(torch.argmax(q[0].float() @ items.float().T))
        cuts = masked_topk_plan(B, N, D, k, torch.cuda.get_device_properties(0)
                                .multi_processor_count, q.element_size()).slice_items(N)
        if len(cuts) < 2:
            raise AssertionError(f"masked_topk: no slice boundary at B={B} N={N}")
        for lo, _ in cuts[1:]:
            items[lo - 1] = items[best]
            items[lo] = items[best]
    run = masked_topk if dispatch else masked_topk_cuda
    before = masked_topk_cuda.launches
    kv, ki = run(q, items, mask, k)
    kv2, ki2 = run(q, items, mask, k)
    torch.cuda.synchronize()
    if masked_topk_cuda.launches - before != 2:
        raise AssertionError(f"masked_topk: {masked_topk_cuda.launches - before} launches for "
                             "two calls")
    if not (torch.equal(kv.view(torch.int32), kv2.view(torch.int32)) and torch.equal(ki, ki2)):
        raise AssertionError(f"masked_topk: two runs differ at B={B} N={N} D={D}")
    pv, pi = masked_topk_torch(q, items, mask, k)
    scores = torch.where(mask > 0, torch.full((), -1e15, device="cuda"),
                         q.float() @ items.float().T)
    kv, ki, pv, pi = kv.cpu(), ki.cpu().long(), pv.cpu(), pi.cpu().long()
    scores = scores.cpu()
    if bool((ki < 0).any() or (ki >= N).any()):
        raise AssertionError("masked_topk returned an id outside the items")
    tol = TOPK_ATOL + TOPK_RTOL * pv.abs()
    if not bool(((kv - pv).abs() <= tol).all()):
        raise AssertionError(f"masked_topk values differ at B={B} N={N}: max "
                             f"{float((kv - pv).abs().max())}")
    # the order is (value desc, id asc)
    if not bool(((kv[:, :-1] > kv[:, 1:]) | ((kv[:, :-1] == kv[:, 1:])
                                              & (ki[:, :-1] < ki[:, 1:]))).all()):
        raise AssertionError("masked_topk output is not in (value desc, id asc) order")
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
    log(f"[check] masked_topk{' bf16 operands' if bf16 else ''} B={B} N={N} D={D} k={k}"
        f"{' only [PAD] masked' if pad_only else ''}"
        f"{' duplicates across slices' if dup else ''}"
        f"{' through the dispatcher (D zero-padded to a 16-byte multiple)' if dispatch else ''}: "
        f"max|err| {err:.3e}, "
        f"near-tie id swaps {swaps} of {B * k}, two runs bit-identical")
    return err


def check_adam(torch, label, shapes, heads, seed, none=(), offset=0, g_offset=None, wd=0.0,
               clip=None, dwd=0.0, card_draws=False):
    """Three steps of the kernel over a whole leaf set at once against
    adam_multi_torch on the same inputs: p, m and v must be the plain
    version's bits (the kernel rounds each operation once in the plain
    version's order). ``none``: leaves without a gradient; ``offset``: every
    p, m and v a view that many elements into its buffer (off the 16-byte
    path); ``g_offset`` (default ``offset``): the same for the gradients;
    ``wd``: the weight decay (a multiply and an add, each rounded, in both);
    ``clip``: "below" or "above", max_norm 10x below every step's global
    gradient norm (every gradient scaled by (g / norm) * max_norm, the norm
    read by the kernel from the device) or 10x above it (none), the norm
    the trainer's: the launcher's own, by the norm kernels over the leaf
    table (``grad_norm_cuda``, held to the plain ``global_grad_norm`` at
    NORM_RTOL), which the plain version is handed; ``dwd``: adamw's
    decoupled decay; ``card_draws``: p and each step's gradients drawn on
    the card from a torch.Generator seeded from ``seed`` (a step's drawn
    again for each side), for a leaf set too large to draw on the host;
    the last CHUNK elements of its largest leaf must then have moved, so
    that the kernel is seen to reach the end of a leaf past 2^32 bytes.
    A leaf's zero head starts at 0, as a [PAD] row does, and must stay 0 in
    p, m and v at every weight decay. Returns the largest |difference|."""
    from recbole_tpu_torch.ops.fused_adam import (CHUNK, AdamLeaves, adam_multi_cuda,
                                                  adam_multi_torch, global_grad_norm,
                                                  grad_norm_cuda)
    if card_draws:
        gen = torch.Generator(device="cuda")

        def draw(shape, scale, k):
            gen.manual_seed(seed * 1000 + k)
            return torch.randn(shape, generator=gen, device="cuda") * scale

        p0 = [draw(s, 0.1, i) for i, s in enumerate(shapes)]

        def step_grads(t):
            return [None if i in none else draw(s, 1e-3, 100 * t + i)
                    for i, s in enumerate(shapes)]
    else:
        rng = np.random.RandomState(seed)
        p0 = [np.asarray(rng.standard_normal(s) * 0.1, np.float32) for s in shapes]
        host = [[None if i in none else np.asarray(rng.standard_normal(s) * 1e-3, np.float32)
                 for i, s in enumerate(shapes)] for _ in range(3)]

        def step_grads(t):
            return host[t - 1]
    for a, h in zip(p0, heads):
        a.reshape(-1)[:h] = 0.0

    def on_card(a, at=offset):
        a = torch.as_tensor(a)
        buf = torch.empty(at + a.numel(), device="cuda")
        buf[at:] = a.reshape(-1)
        return buf[at:].view(a.shape)

    def zeros(shape):
        return torch.zeros(offset + int(np.prod(shape)), device="cuda")[offset:].view(shape)

    g_at = offset if g_offset is None else g_offset
    max_norm = None
    if clip is not None:
        norms = [float(global_grad_norm([None if a is None else torch.as_tensor(a)
                                         for a in step_grads(t)], heads)) for t in (1, 2, 3)]
        max_norm = 0.1 * min(norms) if clip == "below" else 10.0 * max(norms)
    state, step_norms, norm_err = {}, [], 0.0
    for kind, fn in (("kernel", adam_multi_cuda), ("plain", adam_multi_torch)):
        leaves = AdamLeaves([on_card(a) for a in p0], [zeros(a.shape) for a in p0],
                            [zeros(a.shape) for a in p0], heads)
        for t in (1, 2, 3):
            c1, c2 = 1.0 / (1.0 - 0.9 ** t), 1.0 / (1.0 - 0.999 ** t)
            tg = [None if a is None else on_card(a, g_at) for a in step_grads(t)]
            cl = None
            if kind == "kernel" and max_norm is not None:
                norm, ref = grad_norm_cuda(leaves, tg), global_grad_norm(tg, heads)
                norm_err = max(norm_err, abs(float(norm) / float(ref) - 1.0))
                if norm_err > NORM_RTOL:
                    raise AssertionError(f"the norm kernels' norm on {label} is {float(norm)}, "
                                         f"the plain version's {float(ref)}")
                step_norms.append(norm)
                cl = (None, max_norm)  # the trainer's route: the launcher takes the norm
            elif max_norm is not None:
                cl = (step_norms[t - 1], max_norm)
            fn(leaves, tg, c1, c2, b1=0.9, b2=0.999, lr=1e-3, eps=1e-8, wd=wd, clip=cl,
               dwd=dwd)
        torch.cuda.synchronize()
        state[kind] = leaves
    err = 0.0
    for i, shape in enumerate(shapes):
        k, p = state["kernel"], state["plain"]
        for a, b in ((k.p[i], p.p[i]), (k.m[i], p.m[i]), (k.v[i], p.v[i])):
            if not torch.equal(a, b):
                raise AssertionError(f"adam_multi is not the plain version's bits on {label} "
                                     f"leaf {i} {shape}: max {float((a - b).abs().max())}")
            err = max(err, float((a - b).abs().max()))
    # a zero head's gradient is zeroed, then decayed by wd * p (the JAX
    # chain's order), which is 0 on a [PAD] row
    kern = state["kernel"]
    if any(h and bool(t[i].reshape(-1)[:h].any())
           for i, h in enumerate(heads) for t in (kern.p, kern.m, kern.v)):
        raise AssertionError(f"adam_multi moved a zero head off 0 on {label}")
    if card_draws:
        big = max(range(len(shapes)), key=lambda i: int(np.prod(shapes[i])))
        tail = kern.p[big].reshape(-1)[-CHUNK:]
        if not bool((tail != p0[big].reshape(-1)[-CHUNK:]).all()):
            raise AssertionError(f"adam_multi left elements of the last chunk of {label}'s "
                                 f"leaf {big} {shapes[big]} where they were")
    log(f"[check] adam_multi {label}: {len(shapes)} leaves "
        f"({sum(int(np.prod(s)) for s in shapes)} elements) in one launch a step, x3 steps, "
        f"weight decay {wd}, clip {clip} (max_norm {max_norm}"
        + (f"; the norm kernels' norm within {norm_err:.2e} of the plain version's"
           if clip else "") + f"), adamw decay {dwd}: max|err| {err:.3e}, bit for bit"
        + ("; drawn on the card, the largest leaf's last chunk moved" if card_draws else ""))
    return err


def _grad_agrees(torch, out, ref, ids, g, n_rows, id_base, what):
    """max|out - ref|, held to GRAD_RTOL * sum|g| + GRAD_ATOL elementwise
    (the sum over the ids in [id_base, id_base + n_rows))."""
    local = ids.reshape(-1) - id_base
    keep = (local >= 0) & (local < n_rows)
    scale = torch.zeros_like(ref).index_add_(
        0, local[keep], g.reshape(-1, g.shape[-1])[keep].abs().float())
    diff = (out - ref).abs()
    if not bool((diff <= GRAD_RTOL * scale + GRAD_ATOL).all()):
        raise AssertionError(f"{what}: max|err| {float(diff.max())} beyond "
                             f"{GRAD_RTOL} * sum|g| + {GRAD_ATOL}")
    return float(diff.max())


def check_embed_grad(torch, name, cases):
    """One of the two embedding-gradient kernels against its plain version
    on each (label, ids, g, n_rows, id_base[, same_as]) case, and a second
    run of the kernel on the same input compared bit for bit; with
    ``same_as`` = (ids, g), the kernel on that contiguous copy gives the same
    bits too; with ``same_as`` = "row range", the kernel writes rows
    [id_base, id_base + n_rows) of a larger table filled with -1, whose
    other rows must stay -1."""
    from recbole_tpu_torch.ops import embed_grad as eg
    kernel = getattr(eg, f"{name}_cuda")
    plain = getattr(eg, f"{name}_torch")
    worst = 0.0
    for label, ids, g, n_rows, id_base, *same_as in cases:
        into = same_as == ["row range"]
        if into:
            table = torch.full((id_base + n_rows + 4096, g.shape[-1]), -1.0, device="cuda")
            out = kernel(ids, g, n_rows, out=table[id_base:id_base + n_rows], id_base=id_base)
            outside = torch.cat([table[:id_base], table[id_base + n_rows:]])
            if not bool((outside == -1).all()):
                raise AssertionError(f"{name} {label}: rows outside the range were written")
            same_as = []
        else:
            out = kernel(ids, g, n_rows, id_base=id_base)
        torch.cuda.synchronize()
        again = kernel(ids, g, n_rows, id_base=id_base)
        ref = plain(ids, g, n_rows, id_base=id_base)
        err = _grad_agrees(torch, out, ref, ids, g, n_rows, id_base, f"{name} {label}")
        same = bool(torch.equal(out, again))
        if same_as:
            same = same and bool(torch.equal(out, kernel(*same_as[0], n_rows, id_base=id_base)))
        log(f"[check] {name} {label}: R={ids.numel()} n_rows={n_rows} "
            f"D={g.shape[-1]} max|err| {err:.3e} (tolerance {GRAD_RTOL} * sum|g| + "
            f"{GRAD_ATOL}); {'three' if same_as else 'two'} runs bit-identical: {same}")
        if not same:
            raise AssertionError(f"{name} {label}: runs differ, the kernel "
                                 "is meant to be deterministic")
        worst = max(worst, err)
    return worst


def hot_window_ids(rng, R, V):
    """R ids of V rows (windows of 64 rows at V 98,409): a quarter of them
    in window 3, half of those on row 200, then windows 10-16 holding 5, 17,
    20, 32, 33, 60 and 100 ids, on both sides of a warp's 32 and of the
    windowed piece size (54 entries at D 300, 16 at D 1024, 4 at D 4096),
    the rest skewed over rows from 2,048 on."""
    ids = 2048 + np.floor((V - 2048) * rng.random_sample(R) ** 2.2).astype(np.int64)
    hot = R // 4
    ids[:hot] = 192 + rng.randint(0, 64, hot)
    ids[:hot // 2] = 200
    at = hot
    for w, n in zip(range(10, 17), (5, 17, 20, 32, 33, 60, 100)):
        ids[at:at + n] = 64 * w + rng.randint(0, 64, n)
        at += n
    return rng.permutation(ids)


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
    # the last Criteo field: 62 rows at cubic skew, its first rows the hot ones
    f62 = len(spec) - 1
    seq_ids, seq_g = seq_grad_inputs(torch, seed=14)
    seq_pad = torch.where(torch.rand(seq_ids.shape, generator=torch.Generator(
        device="cuda").manual_seed(15), device="cuda") < 0.6, 0, seq_ids)
    onehot = [
        ("criteo small fields, (B, 17) block in place", ids[:, n_large:], g[:, n_large:],
         small_rows, small_off),
        ("criteo small fields, block in place, same bits as its contiguous copy",
         ids[:, n_large:], g[:, n_large:], small_rows, small_off, (flat_ids, flat_g)),
        ("ml-100k fields, same bits as their contiguous copy", ml_ids, ml_g,
         sum(v for _, v in ml), 0, (ml_ids.reshape(-1), ml_g.reshape(-1, CRITEO_DIM))),
        ("criteo small fields, contiguous", flat_ids, flat_g, small_rows, small_off),
        ("ml-100k fields", ml_ids, ml_g, sum(v for _, v in ml), 0),
        ("criteo 62-row field, cubic skew", ids[:, f62:], g[:, f62:], spec[f62][1],
         spec[f62][0]),
        ("D=1", flat_ids, flat_g[:, :1].contiguous(), small_rows, small_off),
        ("R=1", flat_ids[:1], flat_g[:1], small_rows, small_off),
        ("every id equal", torch.full_like(flat_ids, small_off + 7), flat_g, small_rows,
         small_off),
        ("bf16 cotangent", flat_ids, flat_g.to(torch.bfloat16), small_rows, small_off),
        ("SASRec step", *seq_grad_inputs(torch, seed=12), ML1M[1] + 1, 0),
        ("SASRec step, [PAD] tile in many pieces (60% [PAD])", seq_pad, seq_g, ML1M[1] + 1, 0),
        ("SASRec step, every id [PAD]", torch.zeros(SASREC["B"] * SASREC["L"], dtype=torch.int64,
                                                     device="cuda"),
         seq_grad_inputs(torch, seed=13)[1], ML1M[1] + 1, 0),
    ]
    big_ids = ids[:, :n_large].reshape(-1).contiguous()
    big_g = g[:, :n_large].reshape(-1, CRITEO_DIM).contiguous()
    # a LightGCN step at the Yelp shape: the restricted backward's dense
    # gradient at the batch users (R 2,048) and items (R 4,096), and the ego
    # gathers of its L2 term (R 2,048 into the item table)
    lg_u, lg_i, lg_g = lightgcn_grad_inputs(torch)
    rng = np.random.RandomState(19)
    R = big_ids.numel()
    # 1,000,000 rows are windows of 512 rows: every id in the third window
    one_window = torch.from_numpy(1024 + np.floor(512 * rng.random_sample(R) ** 2.0)
                                  .astype(np.int64)).cuda()
    # ids below and past rows [1,000,000, 1,530,000)
    outside = torch.from_numpy(1_000_000 - 1000 + rng.randint(0, 532_000, R)
                               .astype(np.int64)).cuda()
    # a table that ends inside a window (100,003 rows; windows of 64)
    ragged = torch.from_numpy(100_002 - np.floor(100_003 * rng.random_sample(R) ** 3.0)
                              .astype(np.int64)).cuda()
    ten_m = torch.from_numpy(np.floor(10_000_000 * rng.random_sample(R) ** 3.0)
                             .astype(np.int64)).cuda()
    windowed = [
        ("LightGCN users R=2048 into the user table", lg_u, lg_g[:2048], YELP[0] + 1, 0),
        ("LightGCN items R=4096 into the item table", lg_i, lg_g, YELP[1] + 1, 0),
        ("LightGCN positives R=2048 into the item table", lg_i[:2048], lg_g[2048:], YELP[1] + 1,
         0),
        ("criteo large fields, (B, 9) block in place", ids[:, :n_large], g[:, :n_large],
         large_rows, 0),
        ("criteo large fields, block in place, same bits as its contiguous copy",
         ids[:, :n_large], g[:, :n_large], large_rows, 0, (big_ids, big_g)),
        ("criteo large fields, contiguous", big_ids, big_g, large_rows, 0),
        ("every id equal", torch.full_like(big_ids, 1_234_567), big_g, large_rows, 0),
        ("one window cut into many pieces", one_window, big_g, 1_000_000, 0),
        ("ids outside the range, into a row range of a larger table", outside, big_g, 530_000,
         1_000_000, "row range"),
        ("D=1", big_ids, big_g[:, :1].contiguous(), large_rows, 0),
        ("R=0", big_ids[:0], big_g[:0], large_rows, 0),
        ("R=1", big_ids[:1], big_g[:1], large_rows, 0),
        ("bf16 cotangent", big_ids, big_g.to(torch.bfloat16), large_rows, 0),
        ("n_rows not a multiple of the window", ragged, big_g, 100_003, 0),
        ("10,000,000 rows", ten_m, big_g, 10_000_000, 0),
    ]
    # rows wider than a block's 256 threads: several column slabs, and
    # pieces of fewer than 32 entries past D 512
    for D, R in ((300, 4096), (1024, 2048), (4096, 1024)):
        windowed.append((
            f"D={D}, a hot window and windows of 5-100 ids",
            torch.from_numpy(hot_window_ids(rng, R, YELP[1] + 1)).cuda(),
            torch.from_numpy((rng.randn(R, D) * 1e-2).astype(np.float32)).cuda(),
            YELP[1] + 1, 0))
    return {"onehot_matmul_grad": onehot, "windowed_grad": windowed}


def bit_cases(torch, images):
    """(label, bits, rows, n_cols, counts): both Yelp sides at a train
    batch's R, a ragged batch and R = 1, on the Yelp-shaped packed rows
    (about 28 set bits a row) and on random bytes of the same shapes; the
    item image's most popular row picked 10 times among the uniform
    negatives (each pick a copy of one walk, the row cut into pieces); and
    the user image's hot strip alone (its first 32 bytes: the most popular
    items' columns; at this draw 4,056 of the batch's 60,285 set bits, 1,557
    of them in one 4-byte word). counts: the image's set bits a row."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for kind in ("packed rows", "random bytes"):
        sides = {}
        for side in ("user", "item"):
            bits, rows, n_cols, counts = images[side]
            if kind == "random bytes":
                bits = torch.randint(0, 256, tuple(bits.shape), dtype=torch.uint8, device="cuda",
                                     generator=gen)
                counts = row_popcounts(torch, bits)
            sides[side] = (bits, rows, n_cols, counts)
            cases.append((f"{side} side, {kind}", bits, rows, n_cols, counts))
        bits, rows, n_cols, counts = sides["item"]
        cases.append((f"item side, {kind}, ragged R=1864", bits, rows[:1864].contiguous(),
                      n_cols, counts))
        bits, rows, n_cols, counts = sides["user"]
        cases.append((f"user side, {kind}, R=1", bits, rows[:1].contiguous(), n_cols, counts))
    bits, rows, n_cols, counts = images["item"]
    top = int(torch.argmax(counts))
    hot = rows[2048:].clone()
    hot[torch.arange(0, 2000, 200, device="cuda")] = top
    cases.append((f"item side, packed rows, the top row (id {top}, {int(counts[top])} set "
                  "bits) picked 10 times among the 2,048 negatives", bits, hot, n_cols, counts))
    bits, rows, _, _ = images["user"]
    strip = bits[:, :32].contiguous()
    cases.append(("user side, packed rows, the hot strip (bytes 0-31) alone", strip, rows, 256,
                  row_popcounts(torch, strip)))
    return cases


def check_bit_kernels(torch, images):
    """Both packed-bit kernels against their plain versions on each case:
    within GRAD_RTOL of the sum of the terms' magnitudes plus GRAD_ATOL, and
    a second run compared bit for bit; the row kernel's picks of one id give
    identical rows, and its calls launch 2 kernels each."""
    from recbole_tpu_torch.ops import bit_kernels as bk
    worst = {"bit_rows_matmul": 0.0, "bit_cols_matmul": 0.0}
    rng = np.random.RandomState(19)
    for label, bits, rows, n_cols, counts in bit_cases(torch, images):
        R = rows.numel()
        v = torch.from_numpy(rng.randn(n_cols, 64).astype(np.float32) * 0.1).cuda().bfloat16()
        g = torch.from_numpy(rng.randn(R, 64).astype(np.float32) * 1e-3).cuda().bfloat16()
        set_bits, distinct_bits = distinct_set_bits(torch, bits, rows)
        for name, x in (("bit_rows_matmul", v), ("bit_cols_matmul", g)):
            kernel, plain = getattr(bk, f"{name}_cuda"), getattr(bk, f"{name}_torch")
            extra = (counts,) if name == "bit_rows_matmul" else ()
            before = getattr(kernel, "kernel_launches", 0)
            out = kernel(bits, rows, x, *extra)
            torch.cuda.synchronize()
            same = bool(torch.equal(out, kernel(bits, rows, x, *extra)))
            ref = plain(bits, rows, x)
            scale = plain(bits, rows, x.abs())
            diff = (out - ref).abs()
            err = float(diff.max())
            more = ""
            if name == "bit_rows_matmul":
                # every pick of an id gets its walker's row, bit for bit
                ids, inv = torch.unique(rows, return_inverse=True)
                first = torch.full((ids.numel(),), R, device="cuda").scatter_reduce(
                    0, inv, torch.arange(R, device="cuda"), "amin")
                copies_same = bool(torch.equal(out, out[first[inv]]))
                plan = bk.rows_counters()
                more = (f"; {ids.numel()} distinct ids, picks of one id identical: "
                        f"{copies_same}; kernels a call {(kernel.kernel_launches - before) / 2}, "
                        f"walk grid {kernel.last_grid}, counters {plan}")
                if not copies_same or kernel.kernel_launches - before != 4:
                    raise AssertionError(f"{name} {label}: picks of one id differ, or not 2 "
                                         "kernels a call")
            log(f"[check] {name} {label}: R={R} nbytes={bits.shape[1]} D=64 max|err| {err:.3e} "
                f"(tolerance {GRAD_RTOL} * sum|terms| + {GRAD_ATOL}); set bits {set_bits}, "
                f"distinct rows' {distinct_bits}; two runs bit-identical: {same}{more}")
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
        # the bf16 instance's tile edges (16-row tiles, 8-column strips,
        # 16-deep k-steps, FFN chunks): one position, 7, 16, 57; D 16, 32,
        # 64 with 1, 2 and 4 heads (a head 4 wide); inner 32 and 260 (a
        # chunk's ragged end); a sequence with no valid key where not causal
        for label, shape, causal, rate in (
                ("L=1 D=16 H=4", dict(B=1, L=1, D=16, H=4, I=32), True, 0.0),
                ("L=7 D=16 H=1", dict(B=3, L=7, D=16, H=1, I=32), False, 0.5),
                ("L=16 D=32 H=2 I=260", dict(B=3, L=16, D=32, H=2, I=260), True, 0.5),
                ("L=57 D=64 H=4", dict(B=5, L=57, D=64, H=4, I=256), False, 0.5),
                ("L=50 D=32 H=4 I=32", dict(B=3, L=50, D=32, H=4, I=32), True, 0.0),
                # the tf32 tile edges (8-deep k-steps): L 13 and 33, heads 4
                # and 12 wide, inner chunks ending at 36 and 4, and D 20, where
                # bf16 dqkv's k and v columns start 8 bytes off a 16-byte line
                ("L=13 D=16 H=4 I=36", dict(B=4, L=13, D=16, H=4, I=36), True, 0.5),
                ("L=33 D=24 H=2 I=68", dict(B=3, L=33, D=24, H=2, I=68), False, 0.5),
                ("L=20 D=20 H=5 I=44", dict(B=2, L=20, D=20, H=5, I=44), False, 0.5)):
            cases.append((label, shape, causal, "gelu", bf16, rate, not causal))
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
    per_tensor = {"trm_layer": {}, "fused_transformer_layer": {}}
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
        for k, e in [("y", e_fwd), *errs.items()]:
            per_tensor[name][k] = max(per_tensor[name].get(k, 0.0), e)
    for name, errs in per_tensor.items():
        log(f"[check] {name}: worst relative error per tensor over the cases above: "
            f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
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


def gru_counts(fg):
    """The GRU wrappers' launches: all, the cluster route's, the one-block
    tensor-core route's (bf16), the one-block 3xTF32 route's (fp32),
    forward and backward each."""
    f, b = fg.fused_gru_fwd_cuda, fg.fused_gru_bwd_cuda
    return (f.launches, b.launches, f.launches_cluster, b.launches_cluster, f.launches_tc,
            b.launches_tc, f.launches_tf32, b.launches_tf32)


def check_gru(torch):
    """fused_gru_fwd / fused_gru_bwd against the plain version on the card:
    out, dxi, dh0, dwh, dbh, both instances (bf16 = GRU4Rec's default, fp32 =
    NARM's GRU and GRU4Rec under float32; at H 128 the one-block
    tensor-core route and the one-block 3xTF32 route, each asserted), at
    the step (2,048, h0 zero and not), the ragged last train batch of the
    ml-1m-shaped file (1,097), a full-sort batch (4,096) and its last
    (1,944); two runs compared bit for bit; then a two-layer GRU4Rec stack
    at full width through layers.gru_apply against the plain version,
    forward and gradients; then through fused_gru and autograd at 512
    sequences at H 132, 256 and the cluster limit (the bf16 instance's
    cluster kernels), the limit + 4, 704 and H 10 (padded), and at 5
    sequences H 7,268 (the global route with its rows in device memory);
    and the fp32 instance at DIEN's extractor width (DIEN_GRU)."""
    from recbole_tpu_torch.models.layers import GRU
    from recbole_tpu_torch.ops import fused_gru as fg
    L, E, H = GRU4REC["L"], GRU4REC["E"], GRU4REC["H"]
    worst = {"fused_gru_fwd": 0.0, "fused_gru_bwd": 0.0}
    for bf16 in (1, 0):
        log(f"[check] fused_gru {'bf16' if bf16 else 'fp32'} H={H}: wh in "
            f"{GRU_ROUTES[fg._lib().fused_gru_route(H, bf16)]}, shared memory a block: forward "
            f"{fg._lib().fused_gru_smem_bytes(H, 0, bf16)}, backward "
            f"{fg._lib().fused_gru_smem_bytes(H, 1, bf16)} bytes")
    n = 0
    # the step with h0 zero and not; the ragged last train batch, a full
    # eval batch and its ragged last with h0 zero, as the main path gives
    # them (the ragged batches' nonzero h0 is left out for the run's time
    # limit)
    for bf16 in (True, False):
        for label, B, h0 in (("step", GRU4REC["B"], False), ("step", GRU4REC["B"], True),
                             ("last train batch", 1097, False), ("eval batch", 4096, False),
                             ("last eval batch", 1944, False)):
            n += 1
            xi, hinit, wh, bh, dout = gru_inputs(torch, B, L, H, 200 + n, bf16, h0)

            def run():
                out = fg.fused_gru_fwd_cuda(xi, hinit, wh, bh)
                grads = fg.fused_gru_bwd_cuda(xi, hinit, wh, bh, out, dout)
                torch.cuda.synchronize()
                return (out, *grads)

            before = gru_counts(fg)
            got, again = run(), run()
            # H 128: bf16 on the one-block tensor-core kernels, fp32 on the 3xTF32 ones
            tc, tf = 2 * int(bf16), 2 * int(not bf16)
            if tuple(a - b for a, b in zip(gru_counts(fg), before)) != (2, 2, 0, 0, tc, tc,
                                                                       tf, tf):
                raise AssertionError(f"fused_gru ({label}) took another route than "
                                     f"{GRU_ROUTES[4 if bf16 else 5]}")
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
    # hidden sizes beyond the shared-memory route, through fused_gru and
    # autograd at 512 sequences (the step's 2,048 are cut for the run's time
    # limit): H 132, 256 and the cluster limit (the bf16 instance's cluster
    # kernels; the fp32 instance reads wh from device memory), the limit + 4
    # (device memory in both, 16 sequences a block), 704 (device memory, 8
    # sequences a block), and H 10 (zero-padded to 12 by the dispatcher);
    # then, at 5 sequences of 3 steps, H 7,268, past the last width whose
    # backward rows fit a block (one sequence a block, its rows in device
    # memory); and DIEN's extractor at its step and pair block (fp32 only,
    # the instance it runs: B 4,096, H 40 on the one-block 3xTF32 route)
    lib = fg._lib()
    limit = lib.fused_gru_max_cluster_hidden()
    widths = [(H2, 512, L, (True, False)) for H2 in (132, 256, limit, limit + 4, 704, 10)]
    widths.append((lib.fused_gru_max_hidden() + 4, 5, 3, (True, False)))
    widths.append((DIEN_GRU["H"], DIEN_GRU["B"], DIEN_GRU["L"], (False,)))
    for H2, B2, L2, instances in widths:
        Hp = fg.padded_hidden(H2)
        for bf16 in instances:
            route = GRU_ROUTES[lib.fused_gru_route(Hp, bf16)]
            plan = ""
            if route == "cluster":
                plan = "; plan forward {}, backward {}".format(
                    fg.fused_gru_cluster_plan(B2, Hp, False),
                    fg.fused_gru_cluster_plan(B2, Hp, True))
            log(f"[check] fused_gru {'bf16' if bf16 else 'fp32'} H={H2}: runs at H={Hp}, wh in "
                f"{route}, {lib.fused_gru_smem_bytes(Hp, 1, bf16)} bytes of shared memory a "
                f"block at most (backward){plan}")
            t_case = time.time()
            xi, hinit, wh, bh, dout = gru_inputs(torch, B2, L2, H2, 260 + H2 + bf16, bf16, True)

            def run(fn):
                args = [t.clone().requires_grad_(True) for t in (xi, hinit, wh, bh)]
                out = fn(*args)
                (out.float() * dout.float()).sum().backward()
                torch.cuda.synchronize()
                return [out.detach()] + [a.grad for a in args]

            before = gru_counts(fg)
            got = run(fg.fused_gru)
            cl, tc, tf = (int(route == GRU_ROUTES[n]) for n in (1, 4, 5))
            if tuple(a - b for a, b in zip(gru_counts(fg), before)) != (1, 1, cl, cl, tc, tc,
                                                                       tf, tf):
                raise AssertionError(f"fused_gru H={H2} did not launch the {route} kernels once "
                                     "each way")
            same = all(torch.equal(a, b) for a, b in zip(got, run(fg.fused_gru)))
            ref = run(lambda *a: fg.fused_gru_torch(*a, bf16=bf16))
            errs = {k: rel_err(a, b) for k, a, b in zip(("out", "dxi", "dh0", "dwh", "dbh"),
                                                        got, ref)}
            tol = GRU_TOL[bf16]
            log(f"[check] fused_gru {'bf16' if bf16 else 'fp32'} B={B2} L={L2} H={H2}: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (tolerance {tol}); two runs bit-identical: {same}; "
                f"{time.time() - t_case:.1f}s")
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
    on both routes: the whole sequence at SASRec's step, its ragged last
    train batch and an eval batch (L 50), the key tiles at 200 positions,
    and head width 132 on each (past the 128 a tile held before hd was cut
    into chunks); the route each call takes; the keep rates; two runs
    compared bit for bit. Returns the worst |difference| by kernel: the
    whole route's under fused_attention_whole_*, the tiled route's under
    fused_attention_*."""
    from recbole_tpu_torch.ops import fused_attention as fa
    L, H = SASREC["L"], SASREC["H"]
    hd = SASREC["D"] // H
    worst = {f"fused_attention{r}_{way}": 0.0 for r in ("", "_whole") for way in ("fwd", "bwd")}
    for way in (False, True):
        log(f"[check] fused_attention at L={L} hd={hd}: route {fa.fused_attention_route(L, hd)}, "
            f"{fa._lib().fused_attention_smem_bytes(L, hd, way)} bytes of shared memory and "
            f"{fa.fused_attention_blocks_per_sm(L, hd, True, way)} resident blocks an SM "
            f"({'backward' if way else 'forward'}); at L 200: "
            f"{fa.fused_attention_blocks_per_sm(200, hd, True, way)}")
    cases = [("SASRec step", SASREC["B"], L, H, hd, causal, rate)
             for causal in (True, False) for rate in (0.0, 0.5)]
    cases += [("last train batch", 1097, L, H, hd, True, 0.5),
              ("eval batch", 4096, L, H, hd, True, 0.0)]
    # 200 positions: seven key tiles, the online softmax across them
    cases += [("L 200 step", SASREC["B"], 200, H, hd, causal, 0.5) for causal in (True, False)]
    # head width 132 (hidden 264 over 2 heads) on each route; two chunks on the tiled one
    cases += [(f"hd 132 L {Lw}", 256, Lw, 2, 132, True, 0.5) for Lw in (L, 200)]
    for n, (label, B, L, H, hd, causal, rate) in enumerate(cases):
        q, k, v, valid, do = attention_inputs(torch, B, L, H, hd, 300 + n)
        seed = torch.tensor([0x7654321 + 31 * n], dtype=torch.int64, device="cuda")
        kw = dict(causal=causal, rate=rate, layer=n % 2)
        route = fa.fused_attention_route(L, hd)
        wrappers = (fa.fused_attention_fwd_cuda, fa.fused_attention_bwd_cuda)

        def run():
            o, stats = fa.fused_attention_fwd_cuda(q, k, v, valid, seed, with_stats=True, **kw)
            out = (o, *fa.fused_attention_bwd_cuda(q, k, v, valid, do, seed, o=o, stats=stats,
                                                   **kw))
            torch.cuda.synchronize()
            return out

        before = [getattr(fn, f"launches_{route}") for fn in wrappers]
        got, again = run(), run()
        if [getattr(fn, f"launches_{route}") for fn in wrappers] != [n0 + 2 for n0 in before]:
            raise AssertionError(f"fused_attention {label}: not launched on the {route} route")
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
        log(f"[check] fused_attention ({label}, {route} route) B={B} L={L} H={H} hd={hd} "
            f"causal={causal} dropout={rate} empty_row=True: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tolerance {ATTN_TOL} of the tensor's largest value){kept}; two runs "
            f"bit-identical: {same}")
        if not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError(f"fused_attention {label}: non-finite output")
        if max(errs.values()) > ATTN_TOL:
            raise AssertionError(f"fused_attention {label}: beyond tolerance: {errs}")
        if not same:
            raise AssertionError(f"fused_attention {label}: two runs differ")
        name = "fused_attention" + ("_whole" if route == "whole" else "")
        worst[f"{name}_fwd"] = max(worst[f"{name}_fwd"], float((got[0] - ref[0]).abs().max()))
        worst[f"{name}_bwd"] = max([worst[f"{name}_bwd"], *(
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
    one eval chunk's users, and the edges: D = 4 mod 8 (the kernels pad k
    with zeros), D 4, every row in one relation, the most relations with few
    rows."""
    step = 2 * RIPPLENET["B"] * RIPPLENET["hops"] * RIPPLENET["M"]
    NR = ML1M_KG[2] + 2
    return [("step", step, RIPPLENET["D"], NR, {}),
            ("N not a multiple of the tile", 10_001, 64, NR, {"empty": 9}),
            ("one relation holds 90%", 65_536, 64, NR, {"skew": 0.9}),
            ("NR 1", 4_097, 64, 1, {}),
            ("NR 200, ids outside [0, NR)", 50_000, 64, 200, {"outside": 17}),
            ("D 128", 20_000, 128, 24, {}),
            ("D 20, ids outside [0, NR)", 30_001, 20, NR, {"outside": 5}),
            ("D 36, a relation with no rows", 20_000, 36, NR, {"empty": 4}),
            ("D 4", 5_000, 4, 7, {}),
            ("every row in one relation", 40_000, 64, NR, {"skew": 1.0}),
            ("NR 16,383, few rows", 3_000, 16, 16_383, {"outside": 3})]


def check_rel_apply(torch):
    """rel_apply_fwd / rel_apply_bwd against the plain version on the card:
    y, dv and dR, both instances, at RippleNet's step and the edge shapes;
    two runs compared bit for bit; the kernels a call launches by the
    wrappers' counters (3 forward; 4 for a backward that buckets again, 2
    for one under autograd, which reuses the forward's buckets and must give
    the same bits)."""
    from recbole_tpu_torch.ops import rel_apply as ra
    fwd, bwd = ra.rel_apply_fwd_cuda, ra.rel_apply_bwd_cuda
    worst = {"rel_apply_fwd": 0.0, "rel_apply_bwd": 0.0}
    for n, (label, N, D, NR, extra) in enumerate(rel_cases()):
        v, rel, R, dy = rel_inputs(torch, N, D, NR, 400 + n, **extra)
        for bf16 in (False, True):
            def run():
                k0 = (fwd.kernel_launches, bwd.kernel_launches)
                y = ra.rel_apply_fwd_cuda(v, rel, R, bf16=bf16)
                dv, dR = ra.rel_apply_bwd_cuda(v, rel, R, dy, bf16=bf16)
                torch.cuda.synchronize()
                if (fwd.kernel_launches - k0[0], bwd.kernel_launches - k0[1]) != (3, 4):
                    raise AssertionError(f"rel_apply {label}: {fwd.kernel_launches - k0[0]} "
                                         f"kernels forward, {bwd.kernel_launches - k0[1]} "
                                         "backward; 3 and 4 expected")
                return y, dv, dR

            got, again = run(), run()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            # the backward under autograd, on the forward's buckets
            vg, Rg = v.clone().requires_grad_(True), R.clone().requires_grad_(True)
            k0 = (fwd.kernel_launches, bwd.kernel_launches)
            ra.rel_apply(vg, rel, Rg, bf16=bf16).backward(dy)
            torch.cuda.synchronize()
            k_auto = (fwd.kernel_launches - k0[0], bwd.kernel_launches - k0[1])
            reuse = torch.equal(vg.grad, got[1]) and torch.equal(Rg.grad, got[2])
            ref = (ra.rel_apply_torch(v, rel, R, bf16), *ra.rel_apply_torch_bwd(v, rel, R, dy, bf16))
            errs = {k: rel_err(a, b) for k, a, b in zip(("y", "dv", "dR"), got, ref)}
            tol = REL_TOL[bf16]
            log(f"[check] rel_apply {'bf16' if bf16 else 'fp32'} ({label}) N={N} D={D} NR={NR}: "
                + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                + f" (tolerance {tol} of the tensor's largest value); two runs bit-identical: "
                f"{same}; under autograd {k_auto[0]} + {k_auto[1]} kernels, the backward on "
                f"the forward's buckets bit-identical: {reuse}")
            if not all(bool(torch.isfinite(t).all()) for t in got):
                raise AssertionError(f"rel_apply {label}: non-finite output")
            if max(errs.values()) > tol:
                raise AssertionError(f"rel_apply {label}: beyond tolerance {tol}: {errs}")
            if not same:
                raise AssertionError(f"rel_apply {label}: two runs differ")
            if not reuse or k_auto[0] > 3 or k_auto[1] > 2:
                raise AssertionError(f"rel_apply {label}: under autograd {k_auto} kernels "
                                     f"(at most 3 and 2), bit-identical: {reuse}")
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


def check_rel_routes(torch):
    """Widths the rel_apply kernels refuse, through the dispatcher under
    autograd at RippleNet's step rows, both instances: D 18 zero-padded to
    20 (one forward and one backward call), D 256 as two square blocks of
    128 composed (four calls each way); y, dv and dR against the plain
    version at D, within REL_TOL of each tensor's largest value (the bf16
    instance rounds each block's y before the blocks add)."""
    from recbole_tpu_torch.ops import rel_apply as ra
    fwd, bwd = ra.rel_apply_fwd_cuda, ra.rel_apply_bwd_cuda
    worst = {"rel_apply_fwd": 0.0, "rel_apply_bwd": 0.0}
    N = 2 * RIPPLENET["B"] * RIPPLENET["hops"] * RIPPLENET["M"]
    for D in (18, 256):
        v, rel, R, dy = rel_inputs(torch, N, D, ML1M_KG[2] + 2, 430 + D, outside=7)
        for bf16 in (False, True):
            vg, Rg = v.clone().requires_grad_(True), R.clone().requires_grad_(True)
            before = (fwd.launches, bwd.launches)
            y = ra.rel_apply(vg, rel, Rg, bf16=bf16)
            y.backward(dy)
            torch.cuda.synchronize()
            calls = (fwd.launches - before[0], bwd.launches - before[1])
            ref = (ra.rel_apply_torch(v, rel, R, bf16), *ra.rel_apply_torch_bwd(v, rel, R, dy, bf16))
            got = (y.detach(), vg.grad, Rg.grad)
            errs = {k: rel_err(a, b) for k, a, b in zip(("y", "dv", "dR"), got, ref)}
            want = 1 if D <= 128 else 4
            log(f"[check] rel_apply {'bf16' if bf16 else 'fp32'} through the dispatcher N={N} "
                f"D={D}: " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                + f" (tolerance {REL_TOL[bf16]}); calls forward / backward {calls}")
            if calls != (want, want):
                raise AssertionError(f"rel_apply D={D}: {calls} calls, {want} each expected")
            if max(errs.values()) > REL_TOL[bf16] or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"rel_apply D={D}: beyond tolerance: {errs}")
            worst["rel_apply_fwd"] = max(worst["rel_apply_fwd"],
                                         float((got[0] - ref[0]).abs().max()))
            worst["rel_apply_bwd"] = max([worst["rel_apply_bwd"], *(
                float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:]))])
    return worst


def check_bit_widths(torch, images):
    """Widths the packed-bit kernels refuse, through the dispatchers on the
    Yelp shape's packed rows, both sides: D 65 (padded by a zero column; one
    call a product) and D 256 (two slices of 128; two calls); against the
    plain version at D within GRAD_RTOL of the sum of the terms' magnitudes
    plus GRAD_ATOL."""
    from recbole_tpu_torch.ops import bit_kernels as bk
    worst = {"bit_rows_matmul": 0.0, "bit_cols_matmul": 0.0}
    rng = np.random.RandomState(29)
    for side in ("user", "item"):
        bits, rows, n_cols, counts = images[side]
        R = rows.numel()
        for D in (65, 256):
            v = torch.from_numpy(rng.randn(n_cols, D).astype(np.float32) * 0.1).cuda().bfloat16()
            g = torch.from_numpy(rng.randn(R, D).astype(np.float32) * 1e-3).cuda().bfloat16()
            for name, x, extra in (("bit_rows_matmul", v, (counts,)),
                                   ("bit_cols_matmul", g, ())):
                kernel, plain = getattr(bk, f"{name}_cuda"), getattr(bk, f"{name}_torch")
                before = kernel.launches
                out = getattr(bk, name)(bits, rows, x, *extra)
                torch.cuda.synchronize()
                calls = kernel.launches - before
                ref = plain(bits, rows, x)
                diff = (out - ref).abs()
                err = float(diff.max())
                ok = bool((diff <= GRAD_RTOL * plain(bits, rows, x.abs()) + GRAD_ATOL).all())
                log(f"[check] {name} {side} side through the dispatcher R={R} D={D}: max|err| "
                    f"{err:.3e}, within tolerance: {ok}; kernel calls {calls}")
                if calls != (1 if D <= 128 else 2) or not ok or out.shape != ref.shape:
                    raise AssertionError(f"{name} {side} side D={D}: {calls} calls, within "
                                         f"tolerance {ok}, shape {tuple(out.shape)}")
                worst[name] = max(worst[name], err)
    return worst


def capture_epoch_times():
    """Collect the trainer's own epoch and evaluation timings from its log
    records (a logger filter survives init_logger's handler reset)."""
    times = {"train": [], "eval": []}

    class Grab(logging.Filter):
        def filter(self, record):
            msg = record.msg if isinstance(record.msg, str) else ""
            if msg.startswith("epoch %d training") or msg.startswith("pretrain epoch %d"):
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
    from recbole_tpu_torch.ops.fused_adam import adam_multi_cuda
    from recbole_tpu_torch.ops.masked_topk import masked_topk_cuda
    from recbole_tpu_torch.ops import bit_kernels as bk
    from recbole_tpu_torch.ops import fused_attention as fa
    from recbole_tpu_torch.ops import fused_gru as fg
    from recbole_tpu_torch.ops import rel_apply as ra
    return {"masked_topk": masked_topk_cuda, "adam_leaf": adam_multi_cuda,
            "onehot_matmul_grad": eg.onehot_matmul_grad_cuda,
            "windowed_grad": eg.windowed_grad_cuda,
            "trm_layer_fwd": tl.trm_layer_fwd_cuda, "trm_layer_bwd": tl.trm_layer_bwd_cuda,
            "bit_rows_matmul": bk.bit_rows_matmul_cuda,
            "bit_cols_matmul": bk.bit_cols_matmul_cuda,
            "fused_gru_fwd": fg.fused_gru_fwd_cuda, "fused_gru_bwd": fg.fused_gru_bwd_cuda,
            "fused_attention_fwd": fa.fused_attention_fwd_cuda,
            "fused_attention_bwd": fa.fused_attention_bwd_cuda,
            "rel_apply_fwd": ra.rel_apply_fwd_cuda, "rel_apply_bwd": ra.rel_apply_bwd_cuda}


# the trainer's Adam calls, one a training step (count_adam_steps)
ADAM_STEPS = {"n": 0}


def count_adam_steps():
    """Count the trainer's Adam calls, so that read_launches can hold the
    Adam kernel to one launch a training step."""
    from recbole_tpu_torch.trainer.trainer import Trainer
    apply = Trainer._fused_adam_apply

    def counted(self, grads):
        ADAM_STEPS["n"] += 1
        return apply(self, grads)

    Trainer._fused_adam_apply = counted


def reset_launches():
    ADAM_STEPS["n"] = 0
    for fn in kernel_wrappers().values():
        fn.launches = 0
        for share in ("launches_fp32", "launches_bf16", "launches_cluster", "launches_tc",
                      "launches_tf32", "launches_whole", "launches_tiled", "kernel_launches"):
            if hasattr(fn, share):
                setattr(fn, share, 0)


def read_launches(path, must_launch):
    """The wrappers' counts; the transformer wrappers count both instances,
    told apart here: trm_layer_* is the bf16 instance's share,
    fused_transformer_layer_* the fp32 instance's. fused_gru_* count both of
    theirs (one TPU kernel), fused_gru_*_fp32 is the fp32 share,
    fused_gru_*_cluster the cluster route's, fused_gru_*_tc the one-block
    tensor-core route's (bf16 up to H 128) and fused_gru_*_tf32 the one-block
    3xTF32 route's (fp32 up to H 128); rel_apply_* count both of
    theirs, rel_apply_*_bf16 the bf16 share; fused_attention_* count both
    routes' launches, told apart here: fused_attention_* is the key-tiled
    route's share, fused_attention_whole_* the whole-sequence route's;
    bit_rows_matmul counts calls, bit_rows_matmul_kernels the kernels they
    launched (2 a call)."""
    launches = {}
    for name, fn in kernel_wrappers().items():
        if name.startswith("trm_layer"):
            launches[name] = fn.launches - fn.launches_fp32
            launches[name.replace("trm_layer", "fused_transformer_layer")] = fn.launches_fp32
        elif name.startswith("fused_attention"):
            launches[name] = fn.launches_tiled
            launches[name.replace("fused_attention", "fused_attention_whole")] = fn.launches_whole
        else:
            launches[name] = fn.launches
            if hasattr(fn, "launches_fp32"):
                launches[f"{name}_fp32"] = fn.launches_fp32
            if hasattr(fn, "launches_bf16"):
                launches[f"{name}_bf16"] = fn.launches_bf16
            if hasattr(fn, "launches_cluster"):
                launches[f"{name}_cluster"] = fn.launches_cluster
            if hasattr(fn, "launches_tc"):
                launches[f"{name}_tc"] = fn.launches_tc
            if hasattr(fn, "launches_tf32"):
                launches[f"{name}_tf32"] = fn.launches_tf32
            if hasattr(fn, "kernel_launches"):
                launches[f"{name}_kernels"] = fn.kernel_launches
    log(f"[{path}] launches {launches}; {ADAM_STEPS['n']} training steps")
    never = [name for name in must_launch if launches[name] <= 0]
    if never:
        raise AssertionError(f"kernels of the {path} path never launched: {never}")
    if launches["adam_leaf"] != ADAM_STEPS["n"]:
        raise AssertionError(f"the {path} path made {launches['adam_leaf']} Adam launches in "
                             f"{ADAM_STEPS['n']} training steps: one a step expected")
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
        "data_path": os.path.join(tmp, "data"), "epochs": ML1M_EPOCHS,
        "valid_full_to_uni1000": False, "device": "cuda",
        "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO",
        "show_progress": False})
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches("bpr", ("masked_topk", "adam_leaf"))
    release()
    log(f"[bpr] run_recbole BPR ml-1m-shape {ML1M_EPOCHS} epoch(s): {wall:.2f}s wall")
    log(f"[bpr] result {json.dumps(result)}")
    check_result(result, JAX_ML100K)
    n_train = round(ML1M[2] * 0.8)
    log(f"[bpr] epoch seconds {times['train']} (epoch 0 includes the upload); "
        f"train examples/s (last epoch): {n_train / times['train'][-1]:.1f}")
    log(f"[bpr] full-sort valid eval seconds {times['eval']}")
    log(f"[bpr] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return launches


def phase_deepfm(torch, tmp):
    """DeepFM at the full Criteo width through the normal entry points, cut
    to ML1M_EPOCHS. The labels are random at this shape, so AUC is about 0.5
    and only its finiteness is checked."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    config = Config("DeepFM", "criteo-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "epochs": ML1M_EPOCHS, "device": "cuda",
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
    log(f"[deepfm] fit ({ML1M_EPOCHS} epoch(s), validation each) + test: {wall:.2f}s wall")
    log(f"[deepfm] result {json.dumps(result)}")
    check_result(result, ("auc", "logloss"))
    steps = ML1M_EPOCHS * len(train)
    log(f"[deepfm] {steps} steps; launches per step: adam_leaf "
        f"{launches['adam_leaf'] / steps:.2f}, onehot_matmul_grad "
        f"{launches['onehot_matmul_grad'] / steps:.2f}, windowed_grad "
        f"{launches['windowed_grad'] / steps:.2f}")
    log(f"[deepfm] epoch seconds {times['train']} (epoch 0 includes the upload); "
        f"train examples/s (last epoch): {train.n / times['train'][-1]:.1f}; "
        f"ms/step (last epoch): {1e3 * times['train'][-1] / len(train):.3f}")
    log(f"[deepfm] value-metric valid pass seconds {times['eval']}")
    log(f"[deepfm] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(torch, trainer, train, "deepfm")
    return launches


def phase_sasrec(torch, tmp):
    """SASRec at its default widths on the ml-1m-shaped file (written by
    phase_bpr, with timestamps), TO_LS,full, cut to ML1M_EPOCHS; then 20 steady
    steps under the profiler."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    config = Config("SASRec", "ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "epochs": ML1M_EPOCHS, "device": "cuda",
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
    log(f"[sasrec] fit ({ML1M_EPOCHS} epoch(s), validation each) + test: {wall:.2f}s wall")
    log(f"[sasrec] result {json.dumps(result)}")
    check_result(result, JAX_ML100K)
    steps = ML1M_EPOCHS * len(train)
    log(f"[sasrec] {steps} steps; launches per step: trm_layer_bwd "
        f"{launches['trm_layer_bwd'] / steps:.2f}, onehot_matmul_grad "
        f"{launches['onehot_matmul_grad'] / steps:.2f}, adam_leaf "
        f"{launches['adam_leaf'] / steps:.2f}; trm_layer_fwd {launches['trm_layer_fwd']} = "
        f"2 a step + 2 an eval batch")
    log(f"[sasrec] epoch seconds {times['train']} (epoch 0 includes the upload); "
        f"train examples/s (last epoch): {train.n / times['train'][-1]:.1f}; "
        f"ms/step (last epoch): {1e3 * times['train'][-1] / len(train):.3f}")
    log(f"[sasrec] full-sort valid pass seconds {times['eval']}")
    log(f"[sasrec] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(torch, trainer, train, "sasrec")
    # the trained model's valid pass with bf16 scores (the masked top-k's
    # bf16-operand instance) and with GAUC (the non-fused step)
    out = {"sasrec": launches}
    out["sasrec_bf16_scores"] = eval_pass(
        torch, "sasrec_bf16_scores", "SASRec", config, {"eval_score_dtype": "bfloat16"}, train,
        valid, ("masked_topk", "trm_layer_fwd"), ("fused_transformer_layer_fwd",), model=model)
    out["sasrec_gauc"] = eval_pass(
        torch, "sasrec_gauc", "SASRec", config,
        {"metrics": ["Recall", "MRR", "NDCG", "Hit", "Precision", "GAUC"]}, train, valid,
        ("trm_layer_fwd",), ("masked_topk",), model=model)
    return out


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
    if launches["bit_rows_matmul_kernels"] != 2 * launches["bit_rows_matmul"]:
        raise AssertionError(f"bit_rows_matmul's {launches['bit_rows_matmul']} calls launched "
                             f"{launches['bit_rows_matmul_kernels']} kernels, not 2 a call")
    result = {"best_valid_result": best_valid, "test_result": test_result}
    log(f"[lightgcn] fit (1 epoch, validation) + test: {wall:.2f}s wall")
    log(f"[lightgcn] result {json.dumps(result)}")
    check_result(result, JAX_ML100K)
    log(f"[lightgcn] {steps} steps; launches per step: " + ", ".join(
        f"{k} {launches[k] / steps:.2f}" for k in ("bit_rows_matmul", "bit_rows_matmul_kernels",
                                                   "bit_cols_matmul", "windowed_grad",
                                                   "adam_leaf")))
    log(f"[lightgcn] epoch seconds {times['train']} (includes the upload); train examples/s: "
        f"{train.n / times['train'][-1]:.1f}; ms/step: "
        f"{1e3 * times['train'][-1] / steps:.3f}")
    log(f"[lightgcn] full-sort valid pass seconds {times['eval']}")
    log(f"[lightgcn] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(torch, trainer, train, "lightgcn")
    return launches


def seq_phase(torch, tmp, tag, model_name, config_extra, epochs, widths_keys, must_launch,
              must_not, dataset="ml-1m-shape", saved=False, keep=None, profiled=20):
    """One sequential model on the ml-1m-shaped file (written by phase_bpr;
    ``dataset``: another name for it, beside an item file; ``keep``: a dict
    that gets the train loader) under TO_LS,full
    through Config -> data_preparation -> get_model -> get_trainer -> fit
    with validation (``saved``: writing its checkpoints) -> evaluate(test),
    with every kernel's launch count set to 0 just before and read just
    after; then ``profiled`` steady steps under the profiler. Returns
    (launches, model, widths)."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    config = Config(model_name, dataset, config_dict={
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
    if keep is not None:
        keep["train"] = train
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
    best_score, best_valid = trainer.fit(train, valid, saved=saved)
    test_result = trainer.evaluate(test, load_best_model=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(tag, must_launch)
    release()
    ran = {k: launches[k] for k in must_not if launches.get(k)}
    if ran:
        raise AssertionError(f"kernels off the {tag} path were launched: {ran}")
    # S3Rec's pretraining validates nothing: its test pass stands in
    result = {"best_valid_result": best_valid or test_result, "test_result": test_result}
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
    profile_steps(torch, trainer, train, tag, profiled)
    return launches, model, widths


def phase_gru4rec(torch, tmp):
    """GRU4Rec at its defaults, ML1M_EPOCHS: the bf16 instance of the GRU
    kernels (H 128: every launch on the one-block tensor-core route), the
    one-hot gradient, Adam and the masked top-k."""
    launches, model, widths = seq_phase(
        torch, tmp, "gru4rec", "GRU4Rec", {}, ML1M_EPOCHS,
        ("embedding_size", "hidden_size", "num_layers", "dropout_prob", "loss_type",
         "MAX_ITEM_LIST_LENGTH", "train_batch_size"),
        ("fused_gru_fwd", "fused_gru_bwd", "fused_gru_fwd_tc", "fused_gru_bwd_tc",
         "onehot_matmul_grad", "adam_leaf", "masked_topk"),
        ("fused_gru_fwd_fp32", "fused_gru_bwd_fp32", "fused_gru_fwd_cluster", "trm_layer_fwd",
         "windowed_grad"))
    if tuple(widths.values()) != (64, 128, 1, 0.3, "CE", 50, 2048) \
            or model.cdt != torch.bfloat16:
        raise AssertionError(f"GRU4Rec was not built at its defaults: {widths}, {model.cdt}")
    for way in ("fwd", "bwd"):
        if launches[f"fused_gru_{way}_tc"] != launches[f"fused_gru_{way}"]:
            raise AssertionError(f"GRU4Rec's GRU {way} ran off the tensor-core route: "
                                 f"{launches[f'fused_gru_{way}_tc']} of "
                                 f"{launches[f'fused_gru_{way}']} launches")
    return launches


def phase_narm(torch, tmp):
    """NARM at its defaults, 1 epoch (cut): the fp32 instance of the GRU
    kernels, every launch on the one-block 3xTF32 route (H 128); its
    full-sort eval is the non-fused route (no masked top-k)."""
    launches, model, widths = seq_phase(
        torch, tmp, "narm", "NARM", {}, 1,
        ("embedding_size", "hidden_size", "n_layers", "dropout_probs", "loss_type",
         "MAX_ITEM_LIST_LENGTH", "train_batch_size"),
        ("fused_gru_fwd_tf32", "fused_gru_bwd_tf32", "onehot_matmul_grad", "adam_leaf"),
        ("masked_topk", "trm_layer_fwd", "windowed_grad", "fused_gru_fwd_tc",
         "fused_gru_bwd_tc", "fused_gru_fwd_cluster", "fused_gru_bwd_cluster"))
    if (widths["embedding_size"], widths["hidden_size"], widths["n_layers"],
            list(widths["dropout_probs"]), widths["train_batch_size"]) != (64, 128, 1,
                                                                         [0.25, 0.5], 2048):
        raise AssertionError(f"NARM was not built at its defaults: {widths}")
    if launches["fused_gru_fwd"] != launches["fused_gru_fwd_fp32"]:
        raise AssertionError("NARM's GRU ran the bf16 instance")
    for way in ("fwd", "bwd"):
        if launches[f"fused_gru_{way}_tf32"] != launches[f"fused_gru_{way}"]:
            raise AssertionError(f"NARM's GRU {way} ran off the 3xTF32 route: "
                                 f"{launches[f'fused_gru_{way}_tf32']} of "
                                 f"{launches[f'fused_gru_{way}']} launches")
    return launches


def phase_sasrec_attention(torch, tmp):
    """SASRec at its default widths with fused_attention True, 1 epoch: the
    attention-only kernels on their whole-sequence route (L 50); the
    whole-layer kernels and the key-tiled route stay off."""
    launches, model, widths = seq_phase(
        torch, tmp, "sasrec_attention", "SASRec", {"fused_attention": True}, 1,
        ("n_layers", "n_heads", "hidden_size", "inner_size", "MAX_ITEM_LIST_LENGTH",
         "attn_dropout_prob", "fused_attention", "train_batch_size"),
        ("fused_attention_whole_fwd", "fused_attention_whole_bwd", "onehot_matmul_grad",
         "adam_leaf", "masked_topk"),
        ("trm_layer_fwd", "trm_layer_bwd", "fused_transformer_layer_fwd",
         "fused_transformer_layer_bwd", "windowed_grad", "fused_attention_fwd",
         "fused_attention_bwd"))
    if tuple(widths.values()) != (2, 2, 64, 256, 50, 0.5, True, 2048):
        raise AssertionError(f"SASRec was not built at its default widths: {widths}")
    return launches


def write_ml1m_items(path, seed=45):
    """An atomic .item file in the shape of RecBole's ml-1m .item for the
    ml-1m-shaped file's items: item_id:token, movie_title:token_seq (1 to 8
    words of a 4,000-word vocabulary, Zipf-like), release_year:token
    (1919-2000) and genre:token_seq (1 to 6 of 18 genres), from a seed."""
    rng = np.random.RandomState(seed)
    n = ML1M[1]
    words = np.minimum(rng.zipf(1.3, (n, 8)), ML1M_TITLE_WORDS)
    n_words = rng.randint(1, 9, n)
    years = rng.randint(ML1M_YEARS[0], ML1M_YEARS[1] + 1, n)
    n_genres = rng.randint(1, 7, n)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("item_id:token\tmovie_title:token_seq\trelease_year:token\tgenre:token_seq\n")
        for i in range(n):
            title = " ".join(f"w{w}" for w in words[i, :n_words[i]])
            genres = " ".join(f"g{g}" for g in rng.choice(ML1M_GENRES, n_genres[i],
                                                           replace=False))
            fh.write(f"{i + 1}\t{title}\t{years[i]}\t{genres}\n")


# the transformer users' paths: the fp32 instance of the whole-layer
# kernels (their encoders get no compute dtype), and what they must not
# launch
TRM_FP32 = ("fused_transformer_layer_fwd", "fused_transformer_layer_bwd")
TRM_USERS_OFF = ("trm_layer_fwd", "trm_layer_bwd", "windowed_grad", "fused_attention_fwd",
                 "fused_attention_whole_fwd", "fused_gru_fwd", "rel_apply_fwd",
                 "bit_rows_matmul", "bit_cols_matmul")
TRM_USERS_KEYS = ("n_layers", "n_heads", "hidden_size", "inner_size", "MAX_ITEM_LIST_LENGTH",
                  "hidden_dropout_prob", "hidden_act", "train_batch_size")
TRM_USERS_ITEMS = {"load_col": {"inter": ["user_id", "item_id", "timestamp"], "item": "*"}}


def phase_trm_users(torch, tmp):
    """The transformer users at their default_config widths on the
    ml-1m-shaped file with an ml-1m-shaped item file (write_ml1m_items),
    TO_LS,full, 1 epoch each (cut), then 20 steps each under the profiler:
    BERT4Rec (the bidirectional fp32 instance at 51 positions; the cloze
    loss), SASRecF and FDSA (the item features, all three fields; FDSA's
    two encoders a step), GCSAN (1 layer, 1 head, the session GNN before
    the encoder), and S3Rec (item_attribute genre): 1 pretraining epoch
    under S3RecTrainer (four bidirectional encodes a step), whose
    checkpoint a finetuning run then loads for 1 epoch (its full sort the
    non-fused step, as the JAX trainer's rule gives it)."""
    data = os.path.join(tmp, "data", "ml-1m-items")
    os.makedirs(data, exist_ok=True)
    os.symlink(os.path.join(tmp, "data", "ml-1m-shape", "ml-1m-shape.inter"),
               os.path.join(data, "ml-1m-items.inter"))
    t0 = time.time()
    write_ml1m_items(os.path.join(data, "ml-1m-items.item"))
    log(f"[trm_users] wrote the ml-1m-shaped .item ({ML1M[1]} items) in {time.time() - t0:.1f}s")
    out = {}
    base = ("adam_leaf",)
    runs = (("bert4rec", "BERT4Rec", {}, TRM_FP32 + base + ("onehot_matmul_grad", "masked_topk"),
             (2, 2, 64, 256, 50, 0.5, "gelu", 2048)),
            ("sasrecf", "SASRecF", TRM_USERS_ITEMS,
             TRM_FP32 + base + ("onehot_matmul_grad", "masked_topk"),
             (2, 2, 64, 256, 50, 0.5, "gelu", 2048)),
            ("fdsa", "FDSA", TRM_USERS_ITEMS,
             TRM_FP32 + base + ("onehot_matmul_grad", "masked_topk"),
             (2, 2, 64, 256, 50, 0.5, "gelu", 2048)),
            ("gcsan", "GCSAN", {}, TRM_FP32 + base + ("onehot_matmul_grad", "masked_topk"),
             (1, 1, 64, 256, 50, 0.2, "gelu", 2048)),
            ("s3rec_pretrain", "S3Rec", {**TRM_USERS_ITEMS, "item_attribute": "genre"},
             TRM_FP32 + base + ("onehot_matmul_grad",), (2, 2, 64, 256, 50, 0.5, "gelu", 2048)))
    for tag, model_name, extra, must, widths_want in runs:
        off = TRM_USERS_OFF + (("masked_topk",) if model_name == "S3Rec" else ())
        launches, model, widths = seq_phase(torch, tmp, tag, model_name, extra, 1,
                                            TRM_USERS_KEYS, must, off, dataset="ml-1m-items",
                                            saved=model_name == "S3Rec")
        if tuple(widths.values()) != widths_want or model.trm_cdt is not None:
            raise AssertionError(f"{model_name} was not built at its defaults: {widths}, "
                                 f"encoder dtype {model.trm_cdt}")
        if model_name == "BERT4Rec" and model.L != 51:
            raise AssertionError(f"BERT4Rec runs {model.L} positions, 51 expected")
        out[tag] = launches
        del model
        torch.cuda.empty_cache()
    ckpt = max(glob.glob(os.path.join(tmp, "saved", "S3Rec-*.ckpt")), key=os.path.getmtime)
    out["s3rec_finetune"] = seq_phase(
        torch, tmp, "s3rec_finetune", "S3Rec", {**TRM_USERS_ITEMS, "item_attribute": "genre",
                                                "train_stage": "finetune",
                                                "pre_model_path": ckpt}, 1,
        TRM_USERS_KEYS, TRM_FP32 + base + ("onehot_matmul_grad",),
        TRM_USERS_OFF + ("masked_topk",), dataset="ml-1m-items")[0]
    log(f"[trm_users] S3Rec finetuned from {os.path.basename(ckpt)}")
    return out


def eval_pass(torch, tag, model_name, config, extra, train, data, must_launch, must_not,
              model=None):
    """One evaluation of ``data`` by a trainer under ``config`` with
    ``extra`` (a model of ``model_name`` built on ``train``'s dataset, or
    ``model``), the launch counts set to 0 just before and read just after.
    Returns the launches."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    cfg = Config(model_name, config["dataset"], config_dict={**config.final, **extra},
                 _parse_cmd_line=False)
    if model is None:
        model = get_model(model_name)(cfg, train.dataset)
    trainer = get_trainer(cfg["MODEL_TYPE"], model_name)(cfg, model)
    reset_launches()
    t0 = time.time()
    result = trainer.evaluate(data, load_best_model=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(tag, must_launch)
    ran = {k: launches[k] for k in must_not if launches.get(k)}
    if ran:
        raise AssertionError(f"kernels off the {tag} pass were launched: {ran}")
    if not result or not all(np.isfinite(v) for v in result.values()):
        raise AssertionError(f"{tag}: bad result {result}")
    log(f"[{tag}] {model_name} {extra}: one valid pass {wall:.3f}s; {json.dumps(result)}")
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


def short_run(torch, tmp, tag, model_name, extra, loaders, steps, must_launch, must_not,
              dataset="ml-1m-shape", keys=(), leaves=None, profiled=0):
    """``steps`` train steps of a model through get_model -> get_trainer ->
    the trainer's step, then a valid pass and, when ``loaders`` holds a test
    loader after the valid one, a test pass, with every kernel's launch
    count set to 0 just before and read just after: ``must_launch`` must
    have launched, ``must_not`` must not. ``keys``: config keys that must
    hold the model's default_config (at batch 2,048 and 50 positions);
    ``leaves``: the parameter shapes the model must have; ``profiled``: that
    many steady steps under the profiler after the run. Returns the
    launches."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    train, valid, *test = loaders
    config = Config(model_name, dataset, config_dict={
        "data_path": os.path.join(tmp, "data"), "device": "cuda",
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False,
        **extra}, _parse_cmd_line=False)
    reset_launches()
    t_run = time.time()
    model = get_model(model_name)(config, train.dataset)
    widths = {k: config[k] for k in keys}
    if keys and (widths != {k: type(model).default_config[k] for k in keys}
                 or train.batch_size != 2048 or getattr(model, "max_seq_length", 50) != 50):
        raise AssertionError(f"{model_name} was not built at its defaults: {widths} "
                             f"(batch {train.batch_size})")
    shapes = [tuple(p.shape) for p in model.parameters()]
    if leaves is not None and shapes != [tuple(s) for s in leaves]:
        raise AssertionError(f"{model_name}'s leaves are {shapes}, not {leaves}")
    trainer = get_trainer(config["MODEL_TYPE"], model_name)(config, model)
    trainer.prepare(train)
    mode = trainer._build_mode(train)
    B = train.batch_size
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    losses = [mode["step"](trainer._take_batch(mode["tables"], torch.arange(
        i * B, (i + 1) * B, device="cuda")), mode["consts"]) for i in range(steps)]
    losses = [float(x.sum()) for x in losses]
    t_train = time.time() - t0
    train_peak = torch.cuda.max_memory_allocated()
    result = {"best_valid_result": trainer.evaluate(valid, load_best_model=False)}
    t_valid = time.time() - t0 - t_train
    result["test_result"] = (trainer.evaluate(test[0], load_best_model=False) if test
                             else result["best_valid_result"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(tag, must_launch)
    ran = {k: launches[k] for k in must_not if launches.get(k)}
    if ran:
        raise AssertionError(f"kernels off the {tag} path were launched: {ran}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    check_result(result, ("auc", "logloss") if dataset == "criteo-shape" else JAX_ML100K)
    log(f"[{tag}] {model_name} {widths if keys else extra}: "
        f"{sum(int(np.prod(s)) for s in shapes)} parameters in {len(shapes)} leaves; {steps} "
        f"steps {t_train:.2f}s ({1e3 * t_train / steps:.3f} ms/step, {steps * B / t_train:.1f} "
        f"examples/s), losses {[round(x, 4) for x in losses[:3]]} ... {losses[-1]:.4f}; valid "
        f"pass {t_valid:.3f}s, eval {wall - t_train:.3f}s; {json.dumps(result)}")
    log(f"[{tag}] launches per step: " + ", ".join(
        f"{k} {launches[k] / steps:.2f}" for k in must_launch)
        + "; forward kernels count the eval batches too")
    log(f"[{tag}] max_memory_allocated {train_peak} bytes in the steps, "
        f"{torch.cuda.max_memory_allocated()} with the eval passes "
        f"(batch {getattr(valid, 'batch_size', None)})")
    if profiled:
        profile_steps(torch, trainer, train, tag, profiled)
    log(f"[{tag}] the whole run {time.time() - t_run:.1f}s")
    # the step's closures hold the model in a cycle: collect it before the
    # next model's peak is read
    del trainer, model, mode
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the wide phases' train steps (cut from 5 to 3 for the run's time limit)
WIDE_STEPS = 3


def phase_wide(torch, tmp):
    """Widths the kernels took only after their limits were lifted, a few
    steps each on the ml-1m-shaped file: GRU4Rec at hidden 10 (padded), 256
    (the bf16 instance's cluster kernels: wh split over a thread-block
    cluster) and 704 (wh in device memory, 8 sequences a block), SASRec at
    hidden 128 (50 positions: the attention kernels' whole-sequence route)
    and at 200 positions (their key tiles), each under the default
    fused_attention "layer2", which routes around the whole-layer kernel,
    and under True; and SASRec at its defaults with fused_attention "layer"
    under its bfloat16 compute dtype, which takes the attention path (True)
    as the JAX package does."""
    off_gru = ("trm_layer_fwd", "fused_attention_fwd", "fused_attention_whole_fwd",
               "rel_apply_fwd")
    routed = ("trm_layer_fwd", "trm_layer_bwd", "fused_transformer_layer_fwd",
              "fused_transformer_layer_bwd", "fused_gru_fwd")
    whole = ("fused_attention_whole_fwd", "fused_attention_whole_bwd")
    tiled = ("fused_attention_fwd", "fused_attention_bwd")
    out = {}
    loaders = seq_loaders(torch, tmp, "GRU4Rec", {})
    cluster, tc = ("fused_gru_fwd_cluster", "fused_gru_bwd_cluster"), ("fused_gru_fwd_tc",
                                                                       "fused_gru_bwd_tc")
    for hidden in (10, 256, 704):
        on = tc if hidden <= 128 else cluster if hidden <= 384 else ()
        out[f"gru4rec_h{hidden}"] = short_run(
            torch, tmp, f"gru4rec_h{hidden}", "GRU4Rec", {"hidden_size": hidden}, loaders,
            WIDE_STEPS,
            ("fused_gru_fwd", "fused_gru_bwd") + on,
            off_gru + tuple(k for k in cluster + tc if k not in on))
    for fused in ("layer2", True):
        out[f"sasrec_d128_{fused}"] = short_run(
            torch, tmp, f"sasrec_d128_{fused}", "SASRec",
            {"hidden_size": 128, "fused_attention": fused}, loaders, WIDE_STEPS, whole,
            routed + tiled)
    out["sasrec_layer_bf16"] = short_run(
        torch, tmp, "sasrec_layer_bf16", "SASRec",
        {"fused_attention": "layer"}, loaders, WIDE_STEPS, whole,
        routed + tiled)
    loaders = seq_loaders(torch, tmp, "SASRec", {"MAX_ITEM_LIST_LENGTH": 200})
    for fused in ("layer2", True):
        out[f"sasrec_l200_{fused}"] = short_run(
            torch, tmp, f"sasrec_l200_{fused}", "SASRec",
            {"MAX_ITEM_LIST_LENGTH": 200, "fused_attention": fused}, loaders, WIDE_STEPS, tiled,
            routed + whole)
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
           "windowed_grad", "trm_layer_fwd", "fused_gru_fwd", "fused_attention_fwd",
           "fused_attention_whole_fwd")
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
    per_call = {k: launches[f"{k}_kernels"] / max(launches[k], 1)
                for k in ("rel_apply_fwd", "rel_apply_bwd")}
    log(f"[ripplenet] rel_apply kernels a call: forward {per_call['rel_apply_fwd']:.2f}, "
        f"backward {per_call['rel_apply_bwd']:.2f} (on the forward's buckets)")
    if per_call["rel_apply_fwd"] > 3 or per_call["rel_apply_bwd"] > 2:
        raise AssertionError(f"rel_apply launched more kernels a call than 3 and 2: {per_call}")
    log(f"[ripplenet] epoch seconds {times['train']} (includes the upload); train examples/s: "
        f"{train.n / times['train'][-1]:.1f}; ms/step: "
        f"{1e3 * times['train'][-1] / steps:.3f}")
    log(f"[ripplenet] full-sort valid pass seconds {times['eval']}")
    log(f"[ripplenet] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(torch, trainer, train, "ripplenet")
    return launches


# every kernel that the knowledge models' paths must not launch: they run
# plain gathers and products, and Adam (the JAX package's knowledge models
# reach no other Pallas kernel), and rank by full_sort_predict or chunked
# score_items, never the masked top-k
KG_OFF = ("masked_topk", "rel_apply_fwd", "rel_apply_bwd", "onehot_matmul_grad",
          "windowed_grad", "trm_layer_fwd", "trm_layer_bwd", "fused_transformer_layer_fwd",
          "fused_gru_fwd", "fused_gru_bwd", "fused_attention_fwd", "fused_attention_whole_fwd",
          "bit_rows_matmul", "bit_cols_matmul")
# the seven knowledge models at their default_config widths: the config a
# phase adds, its epochs, its trainer class and the modes of each epoch
KG_MODELS = {
    "CKE": ({}, 1, "KGTrainer", [("rskg",)]),
    "CFKG": ({}, 1, "KGTrainer", [("rskg",)]),
    # both modes in two epochs: train_rec_step and train_kg_step 1 (5 each
    # by default: a listed cut)
    "KTUP": ({"train_rec_step": 1, "train_kg_step": 1}, 2, "KGTrainer", [("rs",), ("kg",)]),
    "KGCN": ({}, 1, "KGTrainer", [("rskg",)]),
    "KGNNLS": ({}, 1, "KGTrainer", [("rskg",)]),
    "MKR": ({}, 1, "MKRTrainer", [("rs_only_loss", "kg")]),
    # an rs pass, a kg pass, then the attention update, each epoch; the
    # default's one layer takes the dense path
    "KGAT": ({}, 1, "KGATTrainer", [("rs", "kg")]),
}


def kg_config(torch, tmp, model, extra):
    from recbole_tpu_torch.config.configurator import Config
    return Config(model, "ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "device": "cuda",
        "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False, **extra},
        _parse_cmd_line=False)


def phase_kg_model(torch, tmp, model_name):
    """One knowledge model at its default_config widths on the ml-1m-shaped
    file with the ml-1m KG-shaped .kg and .link (phase_ripplenet writes
    them), RO_RS, valid full sort, through Config -> data_preparation ->
    get_model -> get_trainer -> fit with validation -> evaluate(test), cut
    to KG_MODELS' epochs; the trainer class and each epoch's modes held to
    KG_MODELS, Adam once a training step and no kernel of KG_OFF launched;
    then 20 steady steps of its first mode under the profiler."""
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer import trainer as trainer_mod
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    tag = model_name.lower()
    extra, epochs, trainer_name, modes = KG_MODELS[model_name]
    config = kg_config(torch, tmp, model_name, {"epochs": epochs, **extra})
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    t0 = time.time()
    train, valid, test = data_preparation(config, create_dataset(config))
    t_data = time.time() - t0
    t0 = time.time()
    model = get_model(model_name)(config, train.dataset)
    torch.cuda.synchronize()
    t_model = time.time() - t0
    widths = {k: config[k] for k in model.default_config}
    log(f"[{tag}] data {t_data:.1f}s, model {t_model:.1f}s; widths {widths}, train batch "
        f"{config['train_batch_size']}; {sum(p.numel() for p in model.parameters())} "
        f"parameters in {len(list(model.parameters()))} leaves; eval batch {valid.batch_size}")
    if any(config[k] != v for k, v in model.default_config.items() if k not in extra):
        raise AssertionError(f"{model_name} was not built at its default_config: {widths}")
    trainer = trainer_mod.get_trainer(config["MODEL_TYPE"], model_name)(config, model)
    if type(trainer).__name__ != trainer_name:
        raise AssertionError(f"{model_name} trains under {type(trainer).__name__}")
    ran_modes = []
    real_epoch = trainer_mod.Trainer._train_epoch

    def counted_epoch(self, data, epoch_idx, mode=None):
        steps0 = ADAM_STEPS["n"]
        out = real_epoch(self, data, epoch_idx, mode)
        ran_modes.append((epoch_idx, mode, ADAM_STEPS["n"] - steps0))
        return out

    trainer_mod.Trainer._train_epoch = counted_epoch
    times, release = capture_epoch_times()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    try:
        best_score, best_valid = trainer.fit(train, valid, saved=False)
        test_result = trainer.evaluate(test, load_best_model=False)
        torch.cuda.synchronize()
    finally:
        trainer_mod.Trainer._train_epoch = real_epoch
    wall = time.time() - t0
    launches = read_launches(tag, ("adam_leaf",))
    release()
    ran = {k: launches[k] for k in KG_OFF if launches[k]}
    if ran:
        raise AssertionError(f"kernels off the {tag} path were launched: {ran}")
    got = [tuple(m for e, m, _ in ran_modes if e == epoch) for epoch in range(epochs)]
    if got != modes:
        raise AssertionError(f"{model_name}'s epochs ran the modes {got}, {modes} expected")
    result = {"best_valid_result": best_valid, "test_result": test_result}
    log(f"[{tag}] fit ({epochs} epoch(s), validation) + test: {wall:.2f}s wall; modes by epoch "
        f"(epoch, mode, steps) {ran_modes}")
    log(f"[{tag}] result {json.dumps(result)}")
    check_result(result, JAX_ML100K)
    steps = ADAM_STEPS["n"]
    per_epoch = [sum(n for e, _, n in ran_modes if e == epoch) for epoch in range(epochs)]
    log(f"[{tag}] {steps} steps ({per_epoch} by epoch), adam_leaf launches "
        f"{launches['adam_leaf']} (1 a step); epoch seconds {times['train']} (the first "
        f"includes the upload); ms a step by epoch "
        f"{[round(1e3 * t / n, 3) for t, n in zip(times['train'], per_epoch)]}")
    log(f"[{tag}] full-sort valid pass seconds {times['eval']}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    profile_steps(torch, trainer, train, tag)
    return launches, (train, valid), trainer


def time_attention_update(torch, model, calls=5):
    """KGAT's update_attentive_A on the ml-1m-shaped CKG: ms a call by CUDA
    events, and the hand-written kernels it launches (none)."""
    reset_launches()
    ms = cuda_ms(torch, model.update_attentive_A, calls)
    ran = {k: v for k, v in read_launches("kgat_update", ()).items() if v}
    if ran:
        raise AssertionError(f"KGAT's attention update launched {ran}")
    log(f"[kgat] update_attentive_A: {ms:.3f} ms a call by events ({calls} calls after 3): "
        f"{model.n_edges} edges in {len(model._rel_slices)} relations, {model.n_pairs} "
        f"unique pairs over {model.n_nodes} nodes, dense blocks {tuple(model.att_ui_dense.shape)}"
        f" and {tuple(model.att_iu_dense.shape)}")
    return ms


def phase_kgat_ell(torch, tmp, loaders):
    """KGAT at the KGAT paper's three layers ([64, 32, 16]: the ELL path
    over the whole CKG) on the loaders of phase_kg_model's KGAT run: 5 rs
    steps and a valid pass, Adam once a step and no kernel of KG_OFF."""
    t0 = time.time()
    launches = short_run(torch, tmp, "kgat_ell", "KGAT",
                         {"load_col": {"inter": ["user_id", "item_id", "timestamp"]},
                          "layers": [64, 32, 16]}, loaders, 5, ("adam_leaf",), KG_OFF)
    log(f"[kgat_ell] model, 5 steps and the valid pass in {time.time() - t0:.1f}s")
    return launches


def general_config(torch, tmp, model, dataset, extra):
    from recbole_tpu_torch.config.configurator import Config
    return Config(model, dataset, config_dict={
        "data_path": os.path.join(tmp, "data"), "device": "cuda", "epochs": 1,
        "valid_full_to_uni1000": False, "checkpoint_dir": os.path.join(tmp, "saved"),
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False, **extra},
        _parse_cmd_line=False)


# the kernels a general model's path must not launch (its fit and eval run
# Adam, and the masked top-k only where named)
GENERAL_OFF = ("rel_apply_fwd", "rel_apply_bwd", "onehot_matmul_grad", "windowed_grad",
               "trm_layer_fwd", "trm_layer_bwd", "fused_transformer_layer_fwd", "fused_gru_fwd",
               "fused_gru_bwd", "fused_attention_fwd", "fused_attention_whole_fwd",
               "bit_rows_matmul", "bit_cols_matmul")


def protocol_fit(torch, tmp, tag, model_name, config, loaders, loader_types, must_launch,
                 must_not, weight_decay):
    """One epoch of ``model_name`` on ``loaders`` (built under another
    config of the same data) through get_model -> get_trainer -> fit with
    validation -> evaluate(test); the valid and test loaders held to
    ``loader_types``, the optimizer to ``weight_decay``, Adam to one launch
    a step, and the masked top-k, where it is in ``must_launch``, to the
    test pass alone (a sampled or labeled valid pass ranks candidates)."""
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    train, valid, test = loaders
    got_types = (type(valid).__name__, type(test).__name__)
    if got_types != loader_types:
        raise AssertionError(f"{tag}: loaders {got_types}, {loader_types} expected")
    model = get_model(model_name)(config, train.dataset)
    trainer = get_trainer(config["MODEL_TYPE"], model_name)(config, model)
    if trainer.optimizer["weight_decay"] != weight_decay:
        raise AssertionError(f"{tag}: weight decay {trainer.optimizer['weight_decay']}")
    times, release = capture_epoch_times()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    best_score, best_valid = trainer.fit(train, valid, saved=False)
    torch.cuda.synchronize()
    topk_in_fit = kernel_wrappers()["masked_topk"].launches
    test_result = trainer.evaluate(test, load_best_model=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(tag, must_launch)
    release()
    ran = {k: launches[k] for k in must_not if launches.get(k)}
    if ran or ("masked_topk" in must_launch and topk_in_fit):
        raise AssertionError(f"kernels off the {tag} path were launched: {ran}, masked top-k "
                             f"{topk_in_fit} times in fit")
    result = {"best_valid_result": best_valid, "test_result": test_result}
    log(f"[{tag}] {model_name} {got_types}: fit (1 epoch, validation) + test {wall:.2f}s wall; "
        f"{ADAM_STEPS['n']} steps, {launches['adam_leaf']} Adam launches (weight decay "
        f"{weight_decay}); epoch seconds {times['train']} (with the upload); ms a step "
        f"{1e3 * times['train'][-1] / max(ADAM_STEPS['n'], 1):.3f}; valid pass seconds "
        f"{times['eval']}; max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    log(f"[{tag}] result {json.dumps(result)}")
    check_result(result, JAX_ML100K)
    return launches


def phase_protocols(torch, tmp):
    """The fork's protocols on the ml-1m-shaped file (written by phase_bpr)
    and on a labeled copy of it (a rating 1-5 from a seed, threshold
    {rating: 4}), 1 epoch each: BPR with valid_full_to_uni1000 (a uniform-
    1,000 sampled valid pass, the masked top-k in the full-sort test),
    SASRec under TO_LS,uni100 (its whole-layer kernels; sampled valid and
    test), then MFSimple with dataset negatives both ways, MFSimple with the
    both-way sampler at k 3, and GMF, MLP and NCF at their defaults
    (weight decay 1e-8 in the Adam kernel)."""
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    out = {}
    t0 = time.time()
    config = general_config(torch, tmp, "BPR", "ml-1m-shape", {"valid_full_to_uni1000": True})
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    loaders = data_preparation(config, create_dataset(config))
    log(f"[bpr_uni1000] loaders in {time.time() - t0:.1f}s; valid: {loaders[1].neg_k} "
        f"negatives a positive, up to {loaders[1].max_pos} positives a user, "
        f"{loaders[1].num_candidates} candidates, batch {loaders[1].batch_size}")
    out["bpr_uni1000"] = protocol_fit(
        torch, tmp, "bpr_uni1000", "BPR", config, loaders,
        ("SampledEvalLoader", "FullSortEvalLoader"), ("adam_leaf", "masked_topk"), GENERAL_OFF,
        0.0)
    del loaders
    out["sasrec_uni100"] = seq_phase(
        torch, tmp, "sasrec_uni100", "SASRec", {"eval_setting": "TO_LS,uni100"}, 1,
        ("n_layers", "hidden_size", "MAX_ITEM_LIST_LENGTH", "train_batch_size", "eval_setting"),
        ("trm_layer_fwd", "trm_layer_bwd", "onehot_matmul_grad", "adam_leaf"),
        ("masked_topk", "windowed_grad", "fused_transformer_layer_fwd"))[0]
    t0 = time.time()
    write_ml1m_shape(os.path.join(tmp, "data", "ml-1m-labeled", "ml-1m-labeled.inter"),
                     rating_seed=44)
    labeled = {"load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"]},
               "threshold": {"rating": 4}}
    log(f"[labeled] wrote the labeled ml-1m-shaped .inter in {time.time() - t0:.1f}s")
    runs = {"dataset_negatives": [
                ("mfsimple_dn", "MFSimple", {"train_use_dataset_negatives": True})],
            "full": [("mfsimple_bothway", "MFSimple", {"train_use_bothway_sampler": True,
                                                       "training_neg_sample_num": 3}),
                     ("gmf", "GMF", {}), ("mlp", "MLP", {}), ("ncf", "NCF", {})]}
    for protocol, models in runs.items():
        extra = {**labeled, "eval_use_dataset_negatives": protocol == "dataset_negatives"}
        t0 = time.time()
        config = general_config(torch, tmp, "MFSimple", "ml-1m-labeled", extra)
        init_seed(config["seed"], config["reproducibility"])
        loaders = data_preparation(config, create_dataset(config))
        types = (("DatasetNegEvalLoader",) * 2 if protocol == "dataset_negatives"
                 else ("FullSortEvalLoader",) * 2)
        log(f"[labeled] {protocol} loaders in {time.time() - t0:.1f}s: train {loaders[0].n} "
            f"rows (label 1: {int(loaders[0].columns()['label'].sum())})")
        for tag, model_name, model_extra in models:
            out[tag] = protocol_fit(
                torch, tmp, tag, model_name,
                general_config(torch, tmp, model_name, "ml-1m-labeled", {**extra, **model_extra}),
                loaders, types, ("adam_leaf",), GENERAL_OFF + ("masked_topk",), 1e-8)
        if protocol == "full":
            # NCF's chunked score_items full sort with every parameter
            # rounded to bf16 (eval_score_dtype bfloat16): no kernel
            out["ncf_bf16_scores"] = eval_pass(
                torch, "ncf_bf16_scores", "NCF",
                general_config(torch, tmp, "NCF", "ml-1m-labeled", extra),
                {"eval_score_dtype": "bfloat16"}, loaders[0], loaders[1], (),
                GENERAL_OFF + ("masked_topk", "adam_leaf"))
        del loaders
    return out


def write_ml1m_users(path, seed=46):
    """An atomic .user file in the shape of RecBole's ml-1m .user for the
    ml-1m-shaped file's users: user_id:token, age:token (ml-1m's seven age
    groups), gender:token, occupation:token (21) and zip_code:token (3,439
    codes), from a seed."""
    rng = np.random.RandomState(seed)
    n = ML1M[0]
    ages = rng.choice(ML1M_AGES, n)
    genders = rng.choice(("M", "F"), n)
    jobs = rng.randint(0, ML1M_OCCUPATIONS, n)
    zips = rng.randint(0, ML1M_ZIPS, n)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("user_id:token\tage:token\tgender:token\toccupation:token\tzip_code:token\n")
        fh.writelines(f"{u + 1}\t{ages[u]}\t{genders[u]}\t{jobs[u]}\tz{zips[u]}\n"
                      for u in range(n))


def write_kg_preload(directory, name, seed=47):
    """The pretrained KG tables of the ml-1m KG shape (write_ml1m_kg's
    entity and relation tokens) as additional feature files: <name>.ent, a
    KG_PRELOAD_DIM-float vector an entity (79,388 rows), and <name>.rel, one
    a relation (51 rows), N(0, 0.1) from a seed."""
    n_ent, _, n_rel = ML1M_KG
    rng = np.random.RandomState(seed)
    for suffix, field, n, tok in (("ent", "ent", n_ent, "e"), ("rel", "rel", n_rel, "r")):
        vecs = (0.1 * rng.randn(n, KG_PRELOAD_DIM)).astype(np.float32)
        with open(os.path.join(directory, f"{name}.{suffix}"), "w") as fh:
            fh.write(f"{field}_id:token\t{field}_vec:float_seq\n")
            np.savetxt(fh, np.concatenate([np.arange(n)[:, None], vecs], axis=1),
                       fmt=tok + "%d\t" + " ".join(["%.6f"] * KG_PRELOAD_DIM))


# the GRU users' paths: every GRU launch the fp32 instance on the one-block
# 3xTF32 route (H 64, 128, DIEN's 40), and what they must not launch
GRU_FP32 = ("fused_gru_fwd_tf32", "fused_gru_bwd_tf32")
GRU_USERS_OFF = ("trm_layer_fwd", "fused_transformer_layer_fwd", "windowed_grad",
                 "fused_attention_fwd", "fused_attention_whole_fwd", "rel_apply_fwd",
                 "bit_rows_matmul", "bit_cols_matmul", "fused_gru_fwd_tc", "fused_gru_bwd_tc",
                 "fused_gru_fwd_cluster", "fused_gru_bwd_cluster")
SEQ_INTER = ["user_id", "item_id", "timestamp"]


def phase_gru_users(torch, tmp):
    """The GRU users, then STAMP and SRGNN, at their default_config widths
    on the ml-1m-shaped file, 1 epoch each (cut), a valid and a test pass,
    then 20 steps each under the profiler (DIEN and KSR 5), with every
    kernel's launch count set to 0 just before and read just after each
    run:
    GRU4RecF (the item file's three features; two fp32 GRUs, H 128),
    RepeatNet (H 64; its own full sort), DIN and DIEN under TO_LS,uni100
    (their pair scoring: a full sort at this shape is 6,040 x 3,707 pairs
    through a 50-step attention MLP, and DIEN's two recurrences, each pass;
    DIN launches Adam alone: its id table is frozen; DIEN's extractor GRU at
    H 40 and the user file's four features), GRU4RecKG and KSR on the
    ml-1m KG shape with its pretrained entity table (and KSR's relation
    table) as preload_weight (the KGSeqDataset; GRU4RecKG's entity table
    frozen, KSR's relation table never trained: both checked unchanged
    after the epoch), STAMP (its own full sort) and SRGNN (the session
    GNN; the masked top-k)."""
    data = os.path.join(tmp, "data")
    inter = os.path.join(data, "ml-1m-shape", "ml-1m-shape.inter")
    t0 = time.time()
    users = os.path.join(data, "ml-1m-users")
    os.makedirs(users, exist_ok=True)
    os.symlink(inter, os.path.join(users, "ml-1m-users.inter"))
    os.symlink(os.path.join(data, "ml-1m-items", "ml-1m-items.item"),
               os.path.join(users, "ml-1m-users.item"))
    write_ml1m_users(os.path.join(users, "ml-1m-users.user"))
    kgseq = os.path.join(data, "ml-1m-kgseq")
    os.makedirs(kgseq, exist_ok=True)
    for suffix in ("inter", "kg", "link"):
        os.symlink(os.path.join(data, "ml-1m-shape", f"ml-1m-shape.{suffix}"),
                   os.path.join(kgseq, f"ml-1m-kgseq.{suffix}"))
    write_kg_preload(kgseq, "ml-1m-kgseq")
    log(f"[gru_users] wrote the ml-1m-shaped .user ({ML1M[0]} users) and the KG preload "
        f"tables ({ML1M_KG[0]} entities and {ML1M_KG[2]} relations x {KG_PRELOAD_DIM}) in "
        f"{time.time() - t0:.1f}s")
    items = {"load_col": {"inter": SEQ_INTER, "item": "*"}}
    both = {"load_col": {"inter": SEQ_INTER, "item": "*", "user": "*"}}
    ent = {"additional_feat_suffix": ["ent"], "preload_weight": {"ent_id": "ent_vec"},
           "load_col": {"inter": SEQ_INTER, "ent": ["ent_id", "ent_vec"]}}
    ent_rel = {"additional_feat_suffix": ["ent", "rel"],
               "preload_weight": {"ent_id": "ent_vec", "rel_id": "rel_vec"},
               "load_col": {"inter": SEQ_INTER, "ent": ["ent_id", "ent_vec"],
                            "rel": ["rel_id", "rel_vec"]}}
    uni100 = {"eval_setting": "TO_LS,uni100"}
    gru = ("fused_gru_fwd", "fused_gru_bwd") + GRU_FP32
    base = ("adam_leaf",)
    onehot, topk = ("onehot_matmul_grad",), ("masked_topk",)
    seq_keys = ("embedding_size", "hidden_size", "dropout_prob", "train_batch_size")
    ctr_keys = ("embedding_size", "mlp_hidden_size", "dropout_prob", "pooling_mode",
                "training_neg_sample_num", "train_batch_size")
    runs = (
        ("gru4recf", "GRU4RecF", "ml-1m-items", items, gru + onehot + base + topk, (),
         seq_keys + ("num_layers", "pooling_mode"), (64, 128, 0.3, 2048, 1, "sum")),
        ("repeatnet", "RepeatNet", "ml-1m-shape", {}, gru + onehot + base, topk,
         ("embedding_size", "hidden_size", "joint_train", "train_batch_size"),
         (64, 64, False, 2048)),
        ("din", "DIN", "ml-1m-items", {**items, **uni100}, base,
         topk + onehot + ("fused_gru_fwd",), ctr_keys,
         (10, [256, 256, 256], 0.0, "mean", 1, 2048)),
        ("dien", "DIEN", "ml-1m-users", {**both, **uni100}, gru + base, topk + onehot,
         ctr_keys + ("alpha", "neg_seq_resample_rounds"),
         (10, [256, 256, 256], 0.0, "mean", 1, 2048, 1.0, 4)),
        ("gru4reckg", "GRU4RecKG", "ml-1m-kgseq", ent, gru + onehot + base + topk, (),
         seq_keys + ("freeze_kg",), (64, 128, 0.1, 2048, True)),
        ("ksr", "KSR", "ml-1m-kgseq", ent_rel, gru + onehot + base, topk,
         seq_keys + ("freeze_kg", "gamma"), (64, 128, 0.1, 2048, False, 10)),
        ("stamp", "STAMP", "ml-1m-shape", {}, onehot + base, topk + ("fused_gru_fwd",),
         ("embedding_size", "loss_type", "train_batch_size"), (64, "CE", 2048)),
        ("srgnn", "SRGNN", "ml-1m-shape", {}, onehot + base + topk, ("fused_gru_fwd",),
         ("embedding_size", "step", "train_batch_size"), (64, 1, 2048)))
    out = {}
    for tag, model_name, dataset, extra, must, off, keys, want in runs:
        t_run = time.time()
        kept_data = {}
        # DIEN's and KSR's loops make 1,700-2,700 launches a step, and the
        # profiler's trace of 20 of them took 25-30 s each: 5 steps (a cut)
        launches, model, widths = seq_phase(torch, tmp, tag, model_name, extra, 1, keys, must,
                                            GRU_USERS_OFF + off, dataset=dataset,
                                            keep=kept_data,
                                            profiled=5 if model_name in ("DIEN", "KSR") else 20)
        if list(widths.values()) != list(want):
            raise AssertionError(f"{model_name} was not built at its defaults: {widths}")
        for way in ("fwd", "bwd"):
            if launches[f"fused_gru_{way}_tf32"] != launches[f"fused_gru_{way}"]:
                raise AssertionError(f"{model_name}'s GRU {way} ran off the fp32 3xTF32 route")
        if model_name == "DIEN" and model.feat_dim != DIEN_GRU["H"]:
            raise AssertionError(f"DIEN's extractor runs at H {model.feat_dim}, "
                                 f"{DIEN_GRU['H']} expected")
        if model_name in ("GRU4RecKG", "KSR"):
            # the preloaded tables that do not train stay as loaded
            pre = {"entity_embedding": "ent_id", "relation_embedding": "rel_id"}
            kept = ["relation_embedding"] if model_name == "KSR" else ["entity_embedding"]
            for leaf in kept:
                table = getattr(model, leaf).detach().cpu().numpy()
                loaded = np.zeros_like(table)
                w = kept_data["train"].dataset.get_preload_weight(pre[leaf])
                n = min(len(table), len(w))
                loaded[:n] = w[:n]
                if leaf == "entity_embedding":
                    loaded[0] = 0.0
                if not np.array_equal(table, loaded):
                    raise AssertionError(f"{model_name}'s {leaf} moved in training")
            log(f"[{tag}] {', '.join(kept)} unchanged after the epoch, bit for bit")
        log(f"[{tag}] the whole run {time.time() - t_run:.1f}s")
        out[tag] = launches
        del model
        torch.cuda.empty_cache()
    return out


def phase_rest(torch, tmp):
    """Phase 4p: the last nine sequential models and five context models,
    each at its default_config, REST_STEPS train steps, a valid and a test
    pass and REST_PROFILED profiled steps (short_run). The sequential nine
    share one set of TO_LS full-sort loaders of the ml-1m-shaped file
    (their input types differ only in the trainer's negatives: TransRec,
    FPMC and HGN pairwise with one, the rest CE): the seven that keep the
    sequential base's scoring take the masked top-k, TransRec and FPMC
    (their own full_sort_predict) the non-fused step; every one but
    TransRec and FPMC (plain gathers, as in the JAX package) takes the
    one-hot gradient in embed_seq. The five context models share one set of
    loaders at the DeepFM-Criteo shape (synth_ctr_dataset, as phase_deepfm
    builds it): the field-grouped gradient's one-hot and windowed kernels;
    FFM's (2,565,692, 39, 10) field-aware table takes a plain gather, as in
    the JAX package, and Adam sweeps its 1.0 B elements each step."""
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.utils.logger import init_logger
    from recbole_tpu_torch.utils.utils import init_seed
    t0 = time.time()
    config = Config("Caser", "ml-1m-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "device": "cuda",
        "load_col": {"inter": SEQ_INTER}, "valid_full_to_uni1000": False,
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False},
        _parse_cmd_line=False)
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    loaders = data_preparation(config, create_dataset(config))
    log(f"[rest] ml-1m-shape TO_LS loaders in {time.time() - t0:.1f}s: train {loaders[0].n} "
        f"valid {loaders[1].n} test {loaders[2].n}")
    base, onehot, topk = ("adam_leaf",), ("onehot_matmul_grad",), ("masked_topk",)
    seq = ("embedding_size", "loss_type")
    runs = (("caser", "Caser", seq + ("nv", "nh", "dropout_prob"), base + onehot + topk),
            ("nextitnet", "NextItNet", seq + ("block_num", "dilations", "kernel_size"),
             base + onehot + topk),
            ("transrec", "TransRec", ("embedding_size", "training_neg_sample_num"), base),
            ("fpmc", "FPMC", ("embedding_size", "training_neg_sample_num"), base),
            ("hgn", "HGN", seq + ("pooling_type", "training_neg_sample_num"),
             base + onehot + topk),
            ("hrm", "HRM", seq + ("high_order", "dropout_prob"), base + onehot + topk),
            ("npe", "NPE", seq + ("dropout_prob",), base + onehot + topk),
            ("shan", "SHAN", seq + ("short_item_length",), base + onehot + topk),
            ("fossil", "FOSSIL", seq + ("order_len", "alpha"), base + onehot + topk))
    out = {}
    for tag, model_name, keys, must in runs:
        out[tag] = short_run(torch, tmp, tag, model_name, {"load_col": {"inter": SEQ_INTER}},
                             loaders, REST_STEPS, must, rest_off(must), keys=keys,
                             profiled=REST_PROFILED)
    del loaders
    t0 = time.time()
    config = Config("FFM", "criteo-shape", config_dict={
        "data_path": os.path.join(tmp, "data"), "device": "cuda",
        "USER_ID_FIELD": None, "ITEM_ID_FIELD": None, "LABEL_FIELD": "label",
        "TIME_FIELD": None, "train_batch_size": CRITEO_BATCH,
        "log_dir": os.path.join(tmp, "log"), "state": "INFO", "show_progress": False},
        _parse_cmd_line=False)
    init_seed(config["seed"], config["reproducibility"])
    loaders = data_preparation(config, synth_ctr_dataset(config, CRITEO))
    log(f"[rest] criteo-shaped dataset and splits in {time.time() - t0:.1f}s: train "
        f"{loaders[0].n} valid {loaders[1].n} test {loaders[2].n}")
    ctr = {"USER_ID_FIELD": None, "ITEM_ID_FIELD": None, "LABEL_FIELD": "label",
           "TIME_FIELD": None, "train_batch_size": CRITEO_BATCH}
    grads = ("adam_leaf", "onehot_matmul_grad", "windowed_grad")
    for tag, model_name, keys, leaves in (
            ("ffm", "FFM", ("embedding_size",), FFM_LEAF_SHAPES),
            ("fwfm", "FwFM", ("embedding_size", "dropout_prob"), None),
            ("fnn", "FNN", ("embedding_size", "mlp_hidden_size", "dropout_prob"), None),
            ("widedeep", "WideDeep", ("embedding_size", "mlp_hidden_size", "dropout_prob"), None),
            ("xdeepfm", "xDeepFM", ("embedding_size", "mlp_hidden_size", "cin_layer_size",
                                    "direct", "reg_weight", "train_cin_weights"), None)):
        out[tag] = short_run(torch, tmp, tag, model_name, ctr, loaders, REST_STEPS, grads,
                             rest_off(grads), dataset="criteo-shape", keys=keys, leaves=leaves,
                             profiled=REST_PROFILED)
    return out


def phase_routes(torch, tmp):
    """Shapes the kernels refused until routed before launch, on the
    ml-1m-shaped file: BPR at embedding_size 10 (the masked top-k,
    zero-padded; it must launch) and at topk [200] (the non-fused step: the
    masked top-k must not launch), 1 epoch each through run_recbole; then
    5 steps and a valid pass of RippleNet at embedding_size 18 and 256 (the
    relation apply padded, and composed of 128-column blocks) and of
    LightGCN's restricted step at 65 and 256 (the bit kernels padded, and by
    128-column slices)."""
    from recbole_tpu_torch import run_recbole
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    out = {}
    for tag, extra, must, off in (
            ("bpr_d10", {"embedding_size": 10}, ("masked_topk",), ()),
            ("bpr_k200", {"topk": [200], "valid_metric": "MRR@200"}, (), ("masked_topk",))):
        reset_launches()
        t0 = time.time()
        result = run_recbole(model="BPR", dataset="ml-1m-shape", config_dict={
            "data_path": os.path.join(tmp, "data"), "epochs": 1, "valid_full_to_uni1000": False,
            "device": "cuda", "checkpoint_dir": os.path.join(tmp, "saved"),
            "log_dir": os.path.join(tmp, "log"), "state": "WARNING", "show_progress": False,
            **extra})
        torch.cuda.synchronize()
        launches = read_launches(tag, ("adam_leaf",) + must)
        if any(launches[k] for k in off):
            raise AssertionError(f"{tag}: the masked top-k launched on the non-fused route")
        log(f"[{tag}] BPR {extra}, 1 epoch: {time.time() - t0:.1f}s; test "
            f"{json.dumps(result['test_result'])}")
        if not result["test_result"] or not all(
                0.0 <= x <= 1.0 for x in result["test_result"].values()):
            raise AssertionError(f"{tag}: bad result {result}")
        out[tag] = launches
    for model_name, key, widths, must in (
            ("RippleNet", "embedding_size", (18, 256), ("rel_apply_fwd", "rel_apply_bwd")),
            ("LightGCN", "embedding_size", (65, 256), ("bit_rows_matmul", "bit_cols_matmul"))):
        extra = {"use_restricted_step": True} if model_name == "LightGCN" else {}
        config = kg_config(torch, tmp, model_name, extra)
        train, valid, _ = data_preparation(config, create_dataset(config))
        for width in widths:
            tag = f"{model_name.lower()}_d{width}"
            out[tag] = short_run(torch, tmp, tag, model_name,
                                 {"load_col": {"inter": ["user_id", "item_id", "timestamp"]},
                                  key: width, **extra}, (train, valid), 5,
                                 ("adam_leaf",) + must, ("masked_topk",))
    return out


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

    from recbole_tpu_torch.ops import trm_layer as tl
    for model, (ref, floor) in ML100K_TRM.items():
        before = tl.trm_layer_bwd_cuda.launches_fp32
        t0 = time.time()
        items = ({"load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"],
                               "item": "*"}} if model == "FDSA" else {})
        result = run_recbole(model=model, dataset="ml-100k", config_dict={
            **ML100K_SEQ, **items, "epochs": ML100K_TRM_EPOCHS, "valid_full_to_uni1000": False,
            "device": "cuda", "checkpoint_dir": os.path.join(tmp, "saved100k"),
            "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING",
            "show_progress": False})
        test = result["test_result"]
        ran = tl.trm_layer_bwd_cuda.launches_fp32 - before
        log(f"[quality] ml-100k {model} (TO_LS full-sort, {ML100K_TRM_EPOCHS} epochs, early "
            f"stopping on mrr@10) {time.time() - t0:.1f}s; fp32 whole-layer backward launches "
            f"{ran}; best valid {result['best_valid_result']}")
        log(f"[quality]   test {json.dumps(test)}   JAX package on the CPU, seeds 2020 / 2021 "
            f"/ 2022, same protocol: recall@10 {ref}")
        check_result(result, JAX_ML100K)
        if ran <= 0:
            raise AssertionError(f"the ml-100k {model} run did not go through the fp32 "
                                 "whole-layer kernels")
        if test["recall@10"] < floor:
            raise AssertionError(f"ml-100k {model} test recall@10 {test['recall@10']} < {floor}")

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


# the knowledge models on ml-100k under PARITY.md's CKE protocol
# (PARITY.md:57-66: RO_RS full sort, 10 epochs); CKE's test recall@10 of the
# JAX package 0.1582 / 0.1640 / 0.1634 and of the reference 0.1728 / 0.1530
# / 0.1816 over seeds 2020-2022
ML100K_KG_RUN = {"epochs": 10}
CKE_RECALL_FLOOR = 0.145
# the other six knowledge models on ml-100k under the same protocol at 10
# epochs (KTUP: 5 rs then 5 kg epochs, its default alternation): test
# recall@10 of the JAX package on the CPU, seeds 2020 / 2021 / 2022
# (python run.py --model=<M> --dataset=ml-100k --epochs=10 --seed=<s>
# --valid_full_to_uni1000=False), and the floor, about 0.9x the lowest
ML100K_KG = {"CFKG": ("0.1098 / 0.1112 / 0.1165", 0.095),
             "KTUP": ("0.0842 / 0.0959 / 0.0765", 0.065),
             "KGCN": ("0.1303 / 0.1461 / 0.1654", 0.115),
             "KGNNLS": ("0.1302 / 0.1461 / 0.1654", 0.115),
             "MKR": ("0.1024 / 0.1041 / 0.1049", 0.085),
             "KGAT": ("0.0966 / 0.1180 / 0.1054", 0.087)}


def phase_quality_kg(torch, tmp):
    """ml-100k test recall@10 of the seven knowledge models at their
    defaults, 10 epochs (RO_RS full sort, early stopping on mrr@10), each
    held to its floor (CKE_RECALL_FLOOR, ML100K_KG). Adam must launch in
    each run, and the masked top-k never."""
    from recbole_tpu_torch import run_recbole
    from recbole_tpu_torch.ops.fused_adam import adam_multi_cuda
    from recbole_tpu_torch.ops.masked_topk import masked_topk_cuda
    out = {}
    spreads = {"CKE": ("JAX package, seeds 2020-2022 (PARITY.md:57-66): 0.1582 / 0.1640 / "
                       "0.1634; reference 0.1728 / 0.1530 / 0.1816", CKE_RECALL_FLOOR),
               **{m: (f"JAX package on the CPU, seeds 2020-2022: {spread}", floor)
                  for m, (spread, floor) in ML100K_KG.items()}}
    for model, (ref, floor) in spreads.items():
        before = (adam_multi_cuda.launches, masked_topk_cuda.launches)
        t0 = time.time()
        result = run_recbole(model=model, dataset="ml-100k", config_dict={
            **ML100K_KG_RUN, "valid_full_to_uni1000": False, "device": "cuda",
            "checkpoint_dir": os.path.join(tmp, "saved100k"),
            "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING", "show_progress": False})
        test = result["test_result"]
        ran = (adam_multi_cuda.launches - before[0], masked_topk_cuda.launches - before[1])
        log(f"[quality] ml-100k {model} (RO_RS full sort, 10 epochs, early stopping on mrr@10) "
            f"{time.time() - t0:.1f}s; Adam launches {ran[0]}, masked top-k {ran[1]}; best "
            f"valid {result['best_valid_result']}")
        log(f"[quality]   test {json.dumps(test)}   recall@10 of the {ref}; floor {floor}")
        check_result(result, JAX_ML100K)
        if ran[0] <= 0 or ran[1]:
            raise AssertionError(f"the ml-100k {model} run made {ran} Adam / masked top-k "
                                 "launches")
        if test["recall@10"] < floor:
            raise AssertionError(f"ml-100k {model} test recall@10 {test['recall@10']} < {floor}")
        out[model] = test["recall@10"]
    return out


# MFSimple on ml-100k under the fork's labeled protocol (threshold {rating:
# 3}, dataset negatives in training and in evaluation; tests/test_aux.py:
# 138-161), 10 epochs: test recall@10 of the JAX package on the CPU, seeds
# 2020 / 2021 / 2022 (python run.py --model=MFSimple --dataset=ml-100k
# --epochs=10 --seed=<s> with those keys), and the floor, about 0.9x the lowest
ML100K_LABELED = {"threshold": {"rating": 3}, "train_use_dataset_negatives": True,
                  "eval_use_dataset_negatives": True, "epochs": 10}
MFSIMPLE_LABELED = ("0.8640 / 0.8638 / 0.8638", 0.775)
# BPR on ml-100k with the fork's uniform-1000 validation, 20 epochs: the JAX
# package's best valid recall@10 on the CPU, seed 2020 (python run.py
# --model=BPR --dataset=ml-100k --epochs=20 --valid_full_to_uni1000=True
# --eval_batch_size=16: its sampler's all-pairs comparison does not fit in
# memory at the default batch); printed beside the port's, with no floor
# (the two draw other negatives)
ML100K_UNI1000 = {"valid_full_to_uni1000": True, "epochs": 20}
BPR_UNI1000_JAX = 0.1056


def phase_quality_protocols(torch, tmp):
    """ml-100k: MFSimple's test recall@10 under the labeled protocol, held
    to its floor (the Adam kernel with weight decay 1e-8 in every step, the
    masked top-k never); BPR's best valid recall@10 under the uniform-1000
    validation beside the JAX package's."""
    from recbole_tpu_torch import run_recbole
    from recbole_tpu_torch.ops.fused_adam import adam_multi_cuda
    from recbole_tpu_torch.ops.masked_topk import masked_topk_cuda
    common = {"device": "cuda", "checkpoint_dir": os.path.join(tmp, "saved100k"),
              "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING",
              "show_progress": False}
    before = (adam_multi_cuda.launches, masked_topk_cuda.launches)
    t0 = time.time()
    result = run_recbole(model="MFSimple", dataset="ml-100k",
                         config_dict={**ML100K_LABELED, **common})
    ran = (adam_multi_cuda.launches - before[0], masked_topk_cuda.launches - before[1])
    test = result["test_result"]
    ref, floor = MFSIMPLE_LABELED
    log(f"[quality] ml-100k MFSimple (labeled: threshold rating 3, dataset negatives both "
        f"ways, 10 epochs) {time.time() - t0:.1f}s; Adam launches {ran[0]}, masked top-k "
        f"{ran[1]}; best valid {result['best_valid_result']}")
    log(f"[quality]   test {json.dumps(test)}   recall@10 of the JAX package on the CPU, "
        f"seeds 2020-2022: {ref}; floor {floor}")
    check_result(result, JAX_ML100K)
    if ran[0] <= 0 or ran[1]:
        raise AssertionError(f"the ml-100k MFSimple run made {ran} Adam / masked top-k launches")
    if test["recall@10"] < floor:
        raise AssertionError(f"ml-100k MFSimple test recall@10 {test['recall@10']} < {floor}")
    t0 = time.time()
    result = run_recbole(model="BPR", dataset="ml-100k", config_dict={**ML100K_UNI1000, **common})
    check_result(result, JAX_ML100K)
    log(f"[quality] ml-100k BPR, uniform-1000 validation, 20 epochs: {time.time() - t0:.1f}s; "
        f"best valid recall@10 {result['best_valid_result']['recall@10']} (JAX package on the "
        f"CPU, seed 2020: {BPR_UNI1000_JAX}); test {json.dumps(result['test_result'])}")


def phase_quality_gru_users(torch, tmp):
    """ml-100k test recall@10 of GRU4RecF (the bundled item file's
    features), RepeatNet and KSR (the bundled .kg and .link, random entity
    and relation tables) under the TO_LS full-sort protocol, 5 epochs, each
    held to its floor (ML100K_GRU_USERS); each run must go through the fp32
    GRU kernels. DIN and DIEN have no floor: their pair scoring's full sort
    at ml-100k is 943 x 1,683 pairs a pass through the attention MLP, and
    under a sampled protocol the JAX package has no CPU reference to hold
    them to."""
    from recbole_tpu_torch import run_recbole
    from recbole_tpu_torch.ops import fused_gru as fg
    for model, (ref, floor) in ML100K_GRU_USERS.items():
        items = ({"load_col": {"inter": ["user_id", "item_id", "rating", "timestamp"],
                               "item": "*"}} if model == "GRU4RecF" else {})
        before = fg.fused_gru_bwd_cuda.launches_tf32
        t0 = time.time()
        result = run_recbole(model=model, dataset="ml-100k", config_dict={
            **ML100K_SEQ, **items, "epochs": ML100K_GRU_USERS_EPOCHS,
            "valid_full_to_uni1000": False, "device": "cuda",
            "checkpoint_dir": os.path.join(tmp, "saved100k"),
            "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING",
            "show_progress": False})
        test = result["test_result"]
        ran = fg.fused_gru_bwd_cuda.launches_tf32 - before
        log(f"[quality] ml-100k {model} (TO_LS full-sort, {ML100K_GRU_USERS_EPOCHS} epochs) "
            f"{time.time() - t0:.1f}s; fp32 GRU backward launches {ran}; best valid "
            f"{result['best_valid_result']}")
        log(f"[quality]   test {json.dumps(test)}   JAX package on the CPU, seeds 2020 / 2021 "
            f"/ 2022, same protocol: recall@10 {ref}; floor {floor}")
        check_result(result, JAX_ML100K)
        if ran <= 0:
            raise AssertionError(f"the ml-100k {model} run did not go through the fp32 GRU "
                                 "kernels")
        if test["recall@10"] < floor:
            raise AssertionError(f"ml-100k {model} test recall@10 {test['recall@10']} < {floor}")


def phase_quality_rest(torch, tmp):
    """ml-100k test recall@10 of Caser and FPMC under the TO_LS full-sort
    protocol, 5 epochs, and xDeepFM's test AUC under DeepFM's CTR protocol,
    10 epochs, each held to its floor (ML100K_REST)."""
    from recbole_tpu_torch import run_recbole
    for model, (metric, epochs, ref, floor) in ML100K_REST.items():
        if model == "xDeepFM":
            extra = {**ML100K_CTR, "epochs": epochs}
        else:
            extra = {**ML100K_SEQ, "epochs": epochs, "valid_full_to_uni1000": False,
                     "training_neg_sample_num": 1 if model == "FPMC" else 0}
        t0 = time.time()
        result = run_recbole(model=model, dataset="ml-100k", config_dict={
            **extra, "device": "cuda", "checkpoint_dir": os.path.join(tmp, "saved100k"),
            "log_dir": os.path.join(tmp, "log100k"), "state": "WARNING",
            "show_progress": False})
        test = result["test_result"]
        log(f"[quality] ml-100k {model} ({epochs} epochs) {time.time() - t0:.1f}s; best valid "
            f"{result['best_valid_result']}")
        log(f"[quality]   test {json.dumps(test)}   JAX package on the CPU, seeds 2020 / 2021 "
            f"/ 2022, same protocol: {metric} {ref}; floor {floor}")
        check_result(result, ("auc", "logloss") if metric == "auc" else JAX_ML100K)
        if test[metric] < floor:
            raise AssertionError(f"ml-100k {model} test {metric} {test[metric]} < {floor}")


def adam_copies(shapes):
    """How many copies of a leaf set an Adam timing takes in turn: enough
    that ADAM_ROTATE_BYTES pass between two calls on one copy, so that a
    call's leaves come from HBM and not from the 50 MB L2 (one copy for a
    set of that size or more)."""
    return -(-ADAM_ROTATE_BYTES // (28 * sum(int(np.prod(s)) for s in shapes)))


def rotating(calls):
    """One function that makes the next of ``calls`` each time, in turn."""
    turn = itertools.cycle(calls)
    return lambda: next(turn)()


def adam_library(torch, sets, **kw):
    """``Adam(fused=True).step`` over each (p, grads) of ``sets`` in turn,
    each optimizer stepped once so that its state exists before a timing."""
    steps = []
    for p, grads in sets:
        params = [torch.nn.Parameter(x.clone()) for x in p]
        for prm, g in zip(params, grads):
            prm.grad = g.clone()
        opt = torch.optim.Adam(params, lr=1e-3, fused=True, **kw)
        opt.step()
        steps.append(opt.step)
    return rotating(steps)


def time_adam(torch, shapes, heads, iters, wd=0.0, max_norm=None):
    """One Adam step over a main path's leaf set (every gradient present),
    at weight decay ``wd`` (the library call's ``weight_decay``, the same
    coupled L2):
    the kernel by CUDA events (``ms``) and in one CUDA graph (``graph_ms``),
    the host's ms to enqueue one call (``host_ms``), the plain version, and
    ``Adam(fused=True).step`` by events (``library_ms``) and, capturable, in a
    graph (``library_graph_ms``); the bound reads p, m, v and g and writes p,
    m and v once (g not read in a zero head). Each timing takes
    ``adam_copies`` copies of the leaves in turn, so that the bound holds.
    ``max_norm``: the clipped step as the trainer takes it, one launcher
    call that takes the global norm (the two norm kernels over the leaf
    table, on the gradient addresses it writes once) and then launches the
    kernel reading it (``ms``, ``graph_ms``, ``host_ms``; ``plain_ms`` with
    ``global_grad_norm``), beside the norm alone (``grad_norm_cuda``: ``norm_ms``,
    ``norm_graph_ms``, ``norm_host_ms``), the plain norm alone
    (``plain_norm_ms``: a fused per-tensor norm launch and one over their
    norms) and the kernel alone on a norm made beforehand (``kernel_ms``,
    ``kernel_graph_ms``); the library call is ``clip_grad_norm_`` then
    ``Adam(fused=True).step``. The bound is the kernel's; the norm reads g
    once more (``norm_bound_ms``)."""
    from recbole_tpu_torch.ops.fused_adam import (AdamLeaves, adam_multi_cuda, adam_multi_torch,
                                                  global_grad_norm, grad_norm_cuda)
    gen = torch.Generator(device="cuda").manual_seed(2)
    copies = adam_copies(shapes)
    sets = [([torch.randn(s, device="cuda", generator=gen) * 0.1 for s in shapes],
             [torch.randn(s, device="cuda", generator=gen) * 1e-3 for s in shapes])
            for _ in range(copies)]
    leaves = [AdamLeaves(p, [torch.zeros_like(x) for x in p], [torch.zeros_like(x) for x in p],
                         heads) for p, _ in sets]

    def step(fn, norms=None):
        def one(lv, g, norm):
            # norm None: the launcher takes it (the norm kernels, or the plain
            # version's global_grad_norm), as the trainer's step does
            clip = None if max_norm is None else (norm, max_norm)
            return fn(lv, g, 10.0, 1000.0, b1=0.9, b2=0.999, lr=1e-3, eps=1e-8, wd=wd,
                      clip=clip)
        return rotating([lambda lv=lv, g=g, nm=nm: one(lv, g, nm) for lv, (_, g), nm in zip(
            leaves, sets, norms or [None] * len(leaves))])

    n = sum(x.numel() for x in sets[0][0])
    calls = copies * -(-20 // copies)
    t = {"ms": cuda_ms(torch, step(adam_multi_cuda), iters),
         "graph_ms": graph_ms(torch, step(adam_multi_cuda), calls),
         "host_ms": host_ms(torch, step(adam_multi_cuda)),
         "plain_ms": cuda_ms(torch, step(adam_multi_torch), max(3, iters // 10)),
         "copies": copies, "weight_decay": wd}
    if max_norm is None:
        t["library_ms"] = cuda_ms(torch, adam_library(torch, sets, weight_decay=wd), iters)
        t["library_graph_ms"] = graph_ms(torch, adam_library(torch, sets, capturable=True,
                                                             weight_decay=wd), calls)
    else:
        norms = [grad_norm_cuda(lv, g) for lv, (_, g) in zip(leaves, sets)]
        t["max_norm"] = max_norm
        t["kernel_ms"] = cuda_ms(torch, step(adam_multi_cuda, norms), iters)
        t["kernel_graph_ms"] = graph_ms(torch, step(adam_multi_cuda, norms), calls)
        norm_call = rotating([lambda lv=lv, g=g: grad_norm_cuda(lv, g)
                              for lv, (_, g) in zip(leaves, sets)])
        t["norm_ms"] = cuda_ms(torch, norm_call, iters)
        t["norm_graph_ms"] = graph_ms(torch, norm_call, calls)
        t["norm_host_ms"] = host_ms(torch, norm_call)
        t["plain_norm_ms"] = cuda_ms(torch, rotating([lambda g=g: global_grad_norm(g, heads)
                                                      for _, g in sets]), iters)
        t["library_ms"] = cuda_ms(torch, clip_library(torch, sets, max_norm), iters)
        t["library_graph_ms"] = graph_ms(torch, clip_library(torch, sets, max_norm,
                                                             capturable=True), calls)
        t["norm_bound_ms"] = 4.0 * n / PEAK_BYTES * 1e3
    # the decay adds a multiply and an add an element, the clip a divide and
    # a multiply; the bytes stay 28
    flops = (14.0 + (2.0 if wd else 0.0) + (2.0 if max_norm is not None else 0.0)) * n
    t["bound_ms"], t["bound_by"] = bound(flops, 28 * n - 4 * sum(heads))
    return n, t


def clip_library(torch, sets, max_norm, **kw):
    """``clip_grad_norm_`` then ``Adam(fused=True).step`` over each (p,
    grads) of ``sets`` in turn (the library's clipped step; the gradients
    are scaled in place, so each call scales them again, which changes no
    timing)."""
    steps = []
    for p, grads in sets:
        params = [torch.nn.Parameter(x.clone()) for x in p]
        for prm, g in zip(params, grads):
            prm.grad = g.clone()
        opt = torch.optim.Adam(params, lr=1e-3, fused=True, **kw)
        opt.step()

        def call(params=params, opt=opt):
            torch.nn.utils.clip_grad_norm_(params, max_norm, foreach=True)
            opt.step()
        steps.append(call)
    return rotating(steps)


def time_topk(torch, kernel, B, N, D, k, seed, plain=True, bf16=False):
    """One masked top-k kernel (``kernel``, a tree's ``masked_topk_cuda``) at
    (B, N, D, k) on ``topk_inputs``: by events, in a CUDA graph, the host's
    enqueue a call, the plain version (``plain``), the library call (matmul,
    masked_fill, topk), and the bounds: q, items, the mask and the output
    moved once (``bound_bytes_ms``), 2 B N D operations at the fp32 rate
    (``bound_ms``) and at the 3xTF32 rate the kernel runs at, a third of
    dense TF32 (``bound_3xtf32_ms``). ``launches_a_call`` is the wrapper's
    own count over 20 calls, one kernel each. (torch.profiler is not asked
    here: this late in a long process it recorded a fraction of the
    launches; the card tests read it in a process of their own.) ``bf16``:
    the bf16-operand instance on q and items rounded to bf16; its bound at
    the bf16 tensor-core rate and 2-byte operands; the library call a bf16
    matmul with fp32 output (``torch.mm(..., out_dtype=float32)``; where
    this torch has no such argument, the bf16 product widened), then
    masked_fill and topk."""
    from recbole_tpu_torch.ops.masked_topk import masked_topk_cuda, masked_topk_torch
    q, items, mask = topk_inputs(torch, B, N, D, seed)
    if bf16:
        q, items = q.to(torch.bfloat16), items.to(torch.bfloat16)
    items_t = items.T

    def product():
        if not bf16:
            return q @ items_t
        try:
            return torch.mm(q, items_t, out_dtype=torch.float32)
        except TypeError:
            return (q @ items_t).float()

    def library():
        s = product().masked_fill_(mask > 0, -1e15)
        return torch.topk(s, k, dim=1)

    def call():
        return kernel(q, items, mask, k)

    t = {"ms": cuda_ms(torch, call, 50), "graph_ms": graph_ms(torch, call, calls=20, replays=10),
         "host_ms": host_ms(torch, call, 50),
         "plain_ms": cuda_ms(torch, lambda: masked_topk_torch(q, items, mask, k), 10)
         if plain else None,
         "library_ms": cuda_ms(torch, library, 20),
         "library_graph_ms": graph_ms(torch, library, calls=5, replays=4)}
    esize = q.element_size()
    flops, nbytes = 2.0 * B * N * D, esize * (B * D + N * D) + B * N + 8 * B * k
    if bf16:
        t["bound_ms"], t["bound_by"] = bound(flops, nbytes, PEAK_BF16_FLOPS)
        t["library_out_fp32"] = "out_dtype" if _mm_out_dtype(torch) else "widened"
    else:
        t["bound_ms"], t["bound_by"] = bound(flops, nbytes)
        t["bound_3xtf32_ms"], _ = bound(flops, nbytes, PEAK_TF32_FLOPS / 3)
    t["bound_bytes_ms"] = nbytes / PEAK_BYTES * 1e3
    # the dispatcher has no counter of its own: its kernel's counts
    counter = kernel if hasattr(kernel, "launches") else masked_topk_cuda
    before = counter.launches
    for _ in range(20):
        call()
    t["launches_a_call"] = (counter.launches - before) / 20
    log(f"[time] masked_topk{' bf16 operands' if bf16 else ''} B={B} N={N} D={D} k={k} "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; library: matmul + masked_fill + "
        f"topk): {t}")
    return t


def _mm_out_dtype(torch):
    """Whether torch.mm takes out_dtype (a bf16 product with fp32 output)."""
    a = torch.ones((2, 2), dtype=torch.bfloat16, device="cuda")
    try:
        return torch.mm(a, a, out_dtype=torch.float32).dtype == torch.float32
    except TypeError:
        return False


def phase_timing(torch):
    from recbole_tpu_torch.ops import embed_grad as eg
    from recbole_tpu_torch.ops.masked_topk import masked_topk_cuda
    out = {}
    out["masked_topk"] = time_topk(torch, masked_topk_cuda, 4096, ML1M[1] + 1, 64, 10, seed=1)
    out["masked_topk"]["ml100k"] = time_topk(torch, masked_topk_cuda, 943, 1683, 64, 10, seed=2)
    # row 1b: the bf16-operand instance at row 1's shape and at ml-100k's
    out["masked_topk"]["bf16"] = time_topk(torch, masked_topk_cuda, 4096, ML1M[1] + 1, 64, 10,
                                           seed=1, bf16=True)
    out["masked_topk"]["bf16_ml100k"] = time_topk(torch, masked_topk_cuda, 943, 1683, 64, 10,
                                                  seed=2, bf16=True)

    # Adam over each main path's leaf set, one launch a step; BPR's is the
    # row's own entry
    for label, (shapes, heads) in ADAM_SETS.items():
        n, t = time_adam(torch, shapes, heads, 20 if label == "deepfm_criteo" else 200)
        if label == "bpr":
            out["adam_leaf"] = t
        else:
            out["adam_leaf"][label] = t
        log(f"[time] adam_leaf one step over the {label} leaves ({len(shapes)} leaves, "
            f"{n} elements, one launch): {t}")
    # MFSimple's leaves at its default decay (row 2e), and without decay on
    # the same leaves in the same call
    for label, wd in (("mfsimple", 0.0), ("mfsimple_wd", 1e-8)):
        n, t = time_adam(torch, MFSIMPLE_LEAF_SHAPES, [0] * 5, 200, wd=wd)
        out["adam_leaf"][label] = t
        log(f"[time] adam_leaf one step over MFSimple's leaves ({len(MFSIMPLE_LEAF_SHAPES)} "
            f"leaves, {n} elements, one launch, weight decay {wd}): {t}")
    # row 2f: SASRec's leaves with clip_grad_norm (max_norm below the norm:
    # every gradient scaled), the norm and the kernel
    n, t = time_adam(torch, *ADAM_SETS["sasrec"], 200, max_norm=1e-3)
    out["adam_leaf"]["sasrec_clip"] = t
    log(f"[time] adam_leaf one step over SASRec's leaves with clip_grad_norm "
        f"({len(SASREC_LEAF_SHAPES)} leaves, {n} elements; the norm kernels "
        f"{t['norm_ms']:.4f} ms, two launches, the plain norm {t['plain_norm_ms']:.4f} ms; "
        f"the kernel alone {t['kernel_ms']:.4f} ms): {t}")

    # one step's backward at the Criteo shape: the 17 small fields through
    # the one-hot kernel, reading its column block in place (the 9 large
    # ones: time_windowed). index_add_ into zeros is the library call.
    spec = criteo_field_spec()
    n_large = sum(v > 16384 for _, v in spec)
    ids, g = grad_inputs(torch, CRITEO_BATCH, spec, CRITEO_DIM, seed=8)
    bids, bg, off = ids[:, n_large:], g[:, n_large:], spec[n_large][0]
    n_rows = sum(v for _, v in spec[n_large:])
    kernel, plain = eg.onehot_matmul_grad_cuda, eg.onehot_matmul_grad_torch
    dest = torch.empty((n_rows, CRITEO_DIM), device="cuda")
    local = (bids.reshape(-1) - off).contiguous()
    flat = bg.reshape(-1, CRITEO_DIM).contiguous()

    def library():
        return dest.zero_().index_add_(0, local, flat)

    t = {"ms": cuda_ms(torch, lambda: kernel(bids, bg, n_rows, out=dest, id_base=off), 200),
         "plain_ms": cuda_ms(torch, lambda: plain(bids, bg, n_rows, out=dest, id_base=off), 200),
         "library_ms": cuda_ms(torch, library, 200)}
    R = bids.numel()
    t["bound_ms"], t["bound_by"] = bound(
        float(R * CRITEO_DIM), R * 8 + R * CRITEO_DIM * 4 + n_rows * CRITEO_DIM * 4)
    # its four launches in one graph, and the library call's
    t["graph_ms"] = graph_ms(torch, lambda: kernel(bids, bg, n_rows, out=dest, id_base=off))
    t["library_graph_ms"] = graph_ms(torch, library)
    t["stage_launches"] = kernels_per_call(
        torch, lambda: kernel(bids, bg, n_rows, out=dest, id_base=off))
    out["onehot_matmul_grad"] = t
    log(f"[time] onehot_matmul_grad R={R} n_rows={n_rows} D={CRITEO_DIM}: {t}")
    out["onehot_matmul_grad"]["sasrec"] = time_onehot_sasrec(torch)
    out["windowed_grad"] = time_windowed(torch, eg)
    out.update(time_trm_layer(torch))
    out.update(time_bit_kernels(torch))
    out.update(time_gru(torch))
    out.update(time_attention(torch))
    out.update(time_rel_apply(torch))
    for kname, entries in time_routes(torch).items():
        out[kname].update(entries)
    return out


def time_routes(torch):
    """The kernels at the widths their dispatchers route (the padding and
    the slices or blocks included), beside their bounds: the masked top-k
    at D 10 (padded to 12) at BPR's eval shape; the relation apply at D 18
    (padded to 20) and at D 256 (two square blocks of 128: four calls a
    way) at RippleNet's step rows, forward without gradient and forward +
    backward under autograd, beside R[rel] + torch.bmm; both packed-bit
    kernels at D 65 (padded to 66) and D 256 (two slices) at the Yelp
    shape's two sides. Bounds as the row's own, for the work at D."""
    from recbole_tpu_torch.ops import bit_kernels as bk
    from recbole_tpu_torch.ops import rel_apply as ra
    from recbole_tpu_torch.ops.masked_topk import masked_topk
    out = {"masked_topk": {}, "rel_apply_fwd": {}, "rel_apply_bwd": {}, "bit_rows_matmul": {},
           "bit_cols_matmul": {}}
    out["masked_topk"]["d10"] = time_topk(torch, masked_topk, 4096, ML1M[1] + 1, 10, 10, seed=5)
    NR = ML1M_KG[2] + 2
    # RippleNet's step rows at D 18; at D 256 a batch of 256 users' (16,384
    # rows), where the library's gathered (N, D, D) copy of R and its
    # gradient take 8.6 GB (at the step's 131,072 rows, 68.7 GB)
    for D, N in ((18, 2 * RIPPLENET["B"] * RIPPLENET["hops"] * RIPPLENET["M"]), (256, 16384)):
        v, rel, R, dy = rel_inputs(torch, N, D, NR, 62 + D)
        rel64 = rel.long()
        vg, Rg = v.clone().requires_grad_(True), R.clone().requires_grad_(True)

        def fwd():
            with torch.no_grad():
                return ra.rel_apply(v, rel, R, bf16=False)

        def fwd_bwd():
            vg.grad = Rg.grad = None
            ra.rel_apply(vg, rel, Rg, bf16=False).backward(dy)

        def lib_fwd():
            return torch.bmm(R[rel64], v[:, :, None])[:, :, 0]

        def lib_fwd_bwd():
            vg.grad = Rg.grad = None
            torch.bmm(Rg[rel64], vg[:, :, None])[:, :, 0].backward(dy)

        for way, call, lib, plain, k in (
                ("fwd", fwd, lib_fwd, lambda: ra.rel_apply_torch(v, rel, R), 1),
                ("bwd", fwd_bwd, lib_fwd_bwd,
                 lambda: ra.rel_apply_torch_bwd(v, rel, R, dy), 3)):
            flops = 2.0 * N * D * D * k
            nbytes = 4 * (N * D * (2 if way == "fwd" else 5) + N
                          + NR * D * D * (1 if way == "fwd" else 3))
            t = {"ms": cuda_ms(torch, call, 20), "plain_ms": cuda_ms(torch, plain, 5),
                 "library_ms": cuda_ms(torch, lib, 10)}
            t["bound_ms"], t["bound_by"] = bound(flops, nbytes)
            t["bound_3xtf32_ms"], _ = bound(flops, nbytes, PEAK_TF32_FLOPS / 3)
            before = (ra.rel_apply_fwd_cuda.launches, ra.rel_apply_bwd_cuda.launches)
            call()
            t["calls"] = (ra.rel_apply_fwd_cuda.launches - before[0],
                          ra.rel_apply_bwd_cuda.launches - before[1])
            out[f"rel_apply_{way}"][f"d{D}"] = t
            log(f"[time] rel_apply {'forward' if way == 'fwd' else 'forward + backward under '}"
                f"{'' if way == 'fwd' else 'autograd'} fp32 through the dispatcher N={N} D={D} "
                f"NR={NR} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; library: R[rel] "
                f"gathered, then torch.bmm{'' if way == 'fwd' else ', its autograd backward'}; "
                f"plain: {'forward' if way == 'fwd' else 'the backward alone'}): {t}")
    images = yelp_bit_inputs(torch, seed=7)
    rng = np.random.RandomState(31)
    for side in ("user", "item"):
        bits, rows, n_cols, counts = images[side]
        R, nbytes = rows.numel(), bits.shape[1]
        unpacked = bk.unpack_bits(bits[rows])
        set_bits = int(unpacked.sum())
        touched = int(unpacked.any(dim=0).sum())
        del unpacked
        distinct = int(torch.unique(rows).numel())
        for D in (65, 256):
            v = torch.from_numpy(rng.randn(n_cols, D).astype(np.float32) * 0.1).cuda().bfloat16()
            g = torch.from_numpy(rng.randn(R, D).astype(np.float32) * 1e-3).cuda().bfloat16()
            work = {"bit_rows_matmul": (v, (counts,), touched * D * 2 + R * D * 4),
                    "bit_cols_matmul": (g, (), R * D * 2 + nbytes * 8 * D * 4)}
            for name, (x, extra, io_bytes) in work.items():
                fn, plain = getattr(bk, name), getattr(bk, f"{name}_torch")
                t = {"ms": cuda_ms(torch, lambda: fn(bits, rows, x, *extra), 20),
                     "plain_ms": cuda_ms(torch, lambda: plain(bits, rows, x), 5),
                     "graph_ms": graph_ms(torch, lambda: fn(bits, rows, x, *extra))}
                t["bound_ms"], t["bound_by"] = bound(float(set_bits * D),
                                                     distinct * nbytes + R * 8 + io_bytes)
                out[name][f"{side}_side_d{D}"] = t
                log(f"[time] {name} {side} side through the dispatcher R={R} D={D}: {t}")
    return out


def time_bit_kernels(torch):
    """Both packed-bit kernels at the Yelp shape's two sides as a train step
    calls them (rows 2,048 users into the user image; rows 4,096 items into
    the item image; the row kernel with the images' counts), beside the
    plain version, the library's unpack + bf16 product with fp32 results,
    and the bound: the distinct picked rows' packed bytes, the ids, the rows
    of v that a set bit touches (columns: g) and the output, each moved once;
    one fp32 add per set bit and column. Each kernel's time in a CUDA graph,
    the host's enqueue a call, its calls and kernel launches over 20 calls by
    the wrapper's counters, and the grid (and, for the row kernel, the
    counters) its last call reports."""
    from recbole_tpu_torch.ops import bit_kernels as bk
    images = yelp_bit_inputs(torch, seed=7)
    out = {}
    rng = np.random.RandomState(23)
    for side, key in (("user", "user_side"), ("item", "item_side")):
        bits, rows, n_cols, counts = images[side]
        R, nbytes, D = rows.numel(), bits.shape[1], 64
        v = torch.from_numpy(rng.randn(n_cols, D).astype(np.float32) * 0.1).cuda().bfloat16()
        g = torch.from_numpy(rng.randn(R, D).astype(np.float32) * 1e-3).cuda().bfloat16()
        unpacked = bk.unpack_bits(bits[rows])
        set_bits = int(unpacked.sum())
        touched = int(unpacked.any(dim=0).sum())
        distinct = int(torch.unique(rows).numel())
        del unpacked
        _, distinct_bits = distinct_set_bits(torch, bits, rows)
        v_pad = bk.pad_k(v, nbytes * 8)

        def lib_rows():
            return torch.mm(bk.unpack_bits(bits[rows]).bfloat16(), v_pad, out_dtype=torch.float32)

        def lib_cols():
            return torch.mm(bk.unpack_bits(bits[rows]).bfloat16().T, g, out_dtype=torch.float32)

        work = {"bit_rows_matmul": (v, (counts,), lib_rows, touched * D * 2 + R * D * 4),
                "bit_cols_matmul": (g, (), lib_cols, R * D * 2 + nbytes * 8 * D * 4)}
        for name, (x, extra, lib, io_bytes) in work.items():
            kernel, plain = getattr(bk, f"{name}_cuda"), getattr(bk, f"{name}_torch")
            t = {"ms": cuda_ms(torch, lambda: kernel(bits, rows, x, *extra), 50),
                 "plain_ms": cuda_ms(torch, lambda: plain(bits, rows, x), 10),
                 "library_ms": cuda_ms(torch, lib, 10)}
            t["bound_ms"], t["bound_by"] = bound(float(set_bits * D),
                                                 distinct * nbytes + R * 8 + io_bytes)
            # the device's time without the host's launch rate; the calls and
            # kernel launches of 20 calls by the wrapper's counts; the grid the
            # last call launched
            t["graph_ms"] = graph_ms(torch, lambda: kernel(bits, rows, x, *extra))
            t["host_ms"] = host_ms(torch, lambda: kernel(bits, rows, x, *extra))
            before = (kernel.launches, getattr(kernel, "kernel_launches", 0))
            for _ in range(20):
                kernel(bits, rows, x, *extra)
            torch.cuda.synchronize()
            t["launches_a_call"] = (kernel.launches - before[0]) / 20
            more = ""
            if name == "bit_cols_matmul":
                # the blocks the card holds at once (the runtime's occupancy:
                # SMs x blocks an SM)
                sms, per_sm, _ = bk.cols_occupancy(x.device, D)
                t["grid"] = {**kernel.last_grid, "slots": sms * per_sm}
                more = (f"; {-(-t['grid']['blocks'] // (sms * per_sm))} wave(s) of "
                        f"{sms * per_sm} blocks")
            else:
                t["kernels_a_call"] = (kernel.kernel_launches - before[1]) / 20
                t["grid"] = dict(kernel.last_grid)
                t["counters"] = bk.rows_counters()
            log(f"[time] {name} {side} side R={R} nbytes={nbytes} D={D} ({distinct} distinct "
                f"rows, {set_bits} set bits, {distinct_bits} of them in the distinct rows, "
                f"{touched} columns touched): {t}{more}")
            if side == "user":
                out[name] = t
            else:
                out[name][key] = t
        if side == "item":
            # where the row kernel's time goes: the positives are drawn by
            # popularity (the top item's row holds ~14,500 set bits), the
            # negatives uniformly
            for half, sl in (("positives", slice(0, R // 2)), ("negatives", slice(R // 2, R))):
                sub = rows[sl].contiguous()

                def call():
                    return bk.bit_rows_matmul_cuda(bits, sub, v, counts)

                ms, gms = cuda_ms(torch, call, 50), graph_ms(torch, call)
                out["bit_rows_matmul"][f"item_side_{half}_ms"] = ms
                out["bit_rows_matmul"][f"item_side_{half}_graph_ms"] = gms
                log(f"[time] bit_rows_matmul item side, the {R // 2} {half} alone: {ms:.4f} ms, "
                    f"graph {gms:.4f} ms; set bits, all and distinct rows': "
                    f"{distinct_set_bits(torch, bits, sub)}")
    return out


def time_windowed(torch, eg, plain=True):
    """``eg.windowed_grad_cuda`` (``eg`` an embed_grad module) at the main
    paths' shapes: DeepFM-Criteo's 9 large fields (R 18,432 into 2,530,000
    rows, D 11, its (B, 9) column block read in place), and a LightGCN
    step's users (R 2,048 into 102,047 rows) and items (R 4,096 into 98,409
    rows) at D 64. Each: CUDA events over back-to-back calls (``ms``), the
    same calls in one CUDA graph (``graph_ms``), ``index_add_`` into zeros
    both ways, the plain version, the host's enqueue time a call, the bound,
    and the kernels a call launches with their device ms (profiler). The
    Criteo entry, with ``lightgcn_users`` and ``lightgcn_items`` in it."""
    spec = criteo_field_spec()
    n_large = sum(v > 16384 for _, v in spec)
    ids, g = grad_inputs(torch, CRITEO_BATCH, spec, CRITEO_DIM, seed=8)
    users, items, lg = lightgcn_grad_inputs(torch)
    out = {}
    for label, bids, bg, n_rows in (("criteo", ids[:, :n_large], g[:, :n_large],
                                     spec[n_large][0]),
                                    ("lightgcn_users", users, lg[:2048], YELP[0] + 1),
                                    ("lightgcn_items", items, lg, YELP[1] + 1)):
        R, D = bids.numel(), bg.shape[-1]
        dest = torch.empty((n_rows, D), device="cuda")
        local = bids.reshape(-1).contiguous()
        flat = bg.reshape(-1, D).contiguous()

        def kernel():
            return eg.windowed_grad_cuda(bids, bg, n_rows, out=dest)

        def library():
            return dest.zero_().index_add_(0, local, flat)

        iters = 50 if label == "criteo" else 200
        t = {"ms": cuda_ms(torch, kernel, iters), "library_ms": cuda_ms(torch, library, iters),
             "graph_ms": graph_ms(torch, kernel), "library_graph_ms": graph_ms(torch, library),
             "host_ms": host_ms(torch, kernel)}
        if plain:
            t["plain_ms"] = cuda_ms(
                torch, lambda: eg.windowed_grad_torch(bids, bg, n_rows, out=dest), iters)
        t["bound_ms"], t["bound_by"] = bound(float(R * D), R * 8 + R * D * 4 + n_rows * D * 4)
        t["stage_launches"] = kernels_per_call(torch, kernel)
        log(f"[time] windowed_grad {label} R={R} n_rows={n_rows} D={D}: {t}")
        out[label] = t
    return {**out.pop("criteo"), **out}


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
    t["graph_ms"] = graph_ms(torch, lambda: eg.onehot_matmul_grad_cuda(ids, g, V, out=dest))
    t["library_graph_ms"] = graph_ms(torch, lambda: dest.zero_().index_add_(0, ids, g))
    t["stage_launches"] = kernels_per_call(
        torch, lambda: eg.onehot_matmul_grad_cuda(ids, g, V, out=dest))
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


# the relative error per tensor of the fp32 instance's register-tiled FMA
# kernels, which the 3xTF32 ones replaced, against the plain version at
# SASRec's step with trm_inputs(seed 21) and the masks of seed 21: the last
# values of that version (scripts/torch_trm_ab.py with a checkout of it as
# TREE, NVIDIA H100 80GB HBM3, 700.00 W)
FMA_TRM_ERRORS = {"y": 5.356e-07, "dx": 3.387e-07, "wq": 7.913e-07, "bq": 5.569e-07,
                  "wk": 6.477e-07, "bk": 1.409e-06, "wv": 6.562e-07, "bv": 2.917e-07,
                  "wo": 7.514e-07, "bo": 7.927e-07, "ln1_g": 2.872e-07, "ln1_b": 4.319e-07,
                  "ff1_w": 7.294e-07, "ff1_b": 4.362e-07, "ff2_w": 5.605e-07, "ff2_b": 4.229e-07,
                  "ln2_g": 3.948e-07, "ln2_b": 4.587e-07}


def trm_rel_errors(torch, tl, x, params, valid, dy, seed, H, causal, rate, bf16):
    """The kernels' y, dx and 16 gradients against the plain version fed
    the masks the kernels draw: the largest |difference| over the tensor's
    largest |value| (a gradient that is 0 but for rounding, bk, over a
    hundredth of the largest gradient), per tensor."""
    B, L, D = x.shape
    kw = dict(n_heads=H, causal=causal, act="gelu", dropout=rate, attn_dropout=rate, bf16=bf16)
    got = {"y": tl.trm_layer_fwd_cuda(x, params, valid, seed, **kw)}
    got["dx"], g = tl.trm_layer_bwd_cuda(x, params, valid, dy, seed, **kw)
    got.update(g)
    masks = tl.trm_dropout_masks_cuda(seed, B, H, L, D, rate, rate) if rate else None
    cfg = (H, causal, "gelu", 1e-12, bf16)
    ref = {"y": tl.trm_layer_torch_fwd(x, params, valid, masks, *cfg)}
    ref["dx"], ref_g = tl.trm_layer_torch_bwd(x, params, valid, masks, dy, *cfg)
    ref.update(ref_g)
    floor = 1e-2 * max(float(v.abs().max()) for v in ref_g.values())
    return {k: float((got[k] - ref[k]).abs().max())
            / max(float(ref[k].abs().max()), 1e-30 if k in ("y", "dx") else floor)
            for k in got}


def time_trm_layer(torch):
    """Both kernels, both instances, at SASRec's train shape with dropout
    0.5 (CUDA events, and in a CUDA graph), beside the plain version, the
    bound and the library's layer (nn.TransformerEncoderLayer without
    dropout: forward, and forward + backward beside the backward kernel,
    which recomputes the forward), in fp32 (library_ms) and under bf16
    autocast (library_bf16_ms). The fp32 instance's log line also gives the
    same work's time at the 3xTF32 rate (a third of dense TF32), a note
    beside its bound, and its errors per tensor on these inputs beside the
    FMA kernels' last."""
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

    def lib_fwd(dtype=None):
        with torch.no_grad(), torch.autocast("cuda", dtype=dtype, enabled=dtype is not None):
            return lib(x, src_mask=causal, src_key_padding_mask=pad)

    def lib_fwd_bwd(dtype=None):
        for p in lib.parameters():
            p.grad = None
        xg.grad = None
        with torch.autocast("cuda", dtype=dtype, enabled=dtype is not None):
            y = lib(xg, src_mask=causal, src_key_padding_mask=pad)
        y.float().backward(dy)

    library = {"fwd": cuda_ms(torch, lib_fwd, 10), "bwd": cuda_ms(torch, lib_fwd_bwd, 10)}
    bf16 = torch.bfloat16
    library_bf16 = {"fwd": cuda_ms(torch, lambda: lib_fwd(bf16), 10),
                    "bwd": cuda_ms(torch, lambda: lib_fwd_bwd(bf16), 10)}
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
                 "library_ms": library[way], "library_bf16_ms": library_bf16[way],
                 "graph_ms": graph_ms(torch, kernel, calls=10, replays=10)}
            flops, nbytes = trm_work(B, L, D, H, I, True, way == "bwd")
            t["bound_ms"], t["bound_by"] = bound(
                flops, nbytes, PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
            out[f"{name}_{way}"] = t
            at_3xtf32 = ("" if bf16 else "; at the 3xTF32 rate the bound would be "
                         f"{bound(flops, nbytes, PEAK_TF32_FLOPS / 3)[0]} ms")
            log(f"[time] {name}_{way} B={B} L={L} D={D} H={H} I={I} causal, dropout 0.5 "
                f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB): {t}{at_3xtf32}")
        errs = trm_rel_errors(torch, tl, x, params, valid, dy, seed, H, True, 0.5, bf16)
        worst = max(errs, key=errs.get)
        log(f"[check] {name} at SASRec's step, dropout 0.5, causal: worst relative error "
            f"{worst} {errs[worst]:.3e}; per tensor {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}"
            + ("" if bf16 else f"; the FMA kernels it replaced, on these inputs: worst "
               f"{max(FMA_TRM_ERRORS.values()):.3e}, per tensor {json.dumps(FMA_TRM_ERRORS)}"))
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
    type; the fp32 entry also gives it at the 3xTF32 rate its kernels run
    at, a third of dense TF32 (``bound_3xtf32_ms``). Every entry also
    gives the time in a CUDA graph, the kernels a call launches
    (torch.profiler) and, for the backward, the dwh product alone
    (``dwh_ms``, CUDA events); the "h256" entry also the
    cluster geometry (cluster size, rows a block, clusters and the clusters
    the card holds) and the per-step floor: the forward's L - 1 steps of
    the h exchange and the cluster barrier alone, and with the recurrent
    product. The "dien" entry is the fp32 instance at DIEN's extractor
    (DIEN_GRU: B 4,096, H 40; nn.GRU 40 -> 40)."""
    from recbole_tpu_torch.ops import fused_gru as fg
    L = GRU4REC["L"]
    out = {}
    # GRU4Rec's hidden 128 in both instances (wh in shared memory), then
    # hidden 256 in the bf16 instance (the cluster kernels), the "h256"
    # entry; then DIEN's extractor (row 8d, the "dien" entry): the fp32
    # instance at B 4,096 and H 40, nn.GRU over its 40-wide input
    for H, bf16, B, E, label in (
            (GRU4REC["H"], True, GRU4REC["B"], GRU4REC["E"], None),
            (GRU4REC["H"], False, GRU4REC["B"], GRU4REC["E"], "fp32"),
            (256, True, GRU4REC["B"], GRU4REC["E"], "h256"),
            (DIEN_GRU["H"], False, DIEN_GRU["B"], DIEN_GRU["H"], "dien")):
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
            if not bf16:
                t["bound_3xtf32_ms"], _ = bound(flops, nbytes, PEAK_TF32_FLOPS / 3)
            t["graph_ms"] = graph_ms(torch, kernel, calls=5, replays=10)
            t["kernels"] = kernels_per_call(torch, kernel)
            if way == "bwd":
                # the backward's last product alone, by events (the profiler
                # can drop launches late in a long process)
                dhh = torch.randn(B, L, 3 * H, device="cuda")
                t["dwh_ms"] = cuda_ms(torch, lambda: fg.fused_gru_dwh_cuda(y, hinit, dhh),
                                      20)
            if bf16 and fg.cluster_route(H, True):
                t["plan"] = fg.fused_gru_cluster_plan(B, H, way == "bwd")
                if way == "fwd":
                    for name, product in (("floor_ms", False), ("floor_product_ms", True)):
                        t[name] = cuda_ms(torch, lambda: fg.fused_gru_cluster_floor_cuda(
                            B, L, H, "cuda", product), 20)
            key = f"fused_gru_{way}"
            if label:
                out[key][label] = t
            else:
                out[key] = t
            log(f"[time] {key} {'bf16' if bf16 else 'fp32'} B={B} L={L} H={H} "
                f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; library nn.GRU {E}->{H} "
                f"with its input projection): {t}")
    return out


def time_attention(torch):
    """The attention kernels at SASRec's step (B 2,048, H 2, hd 32, causal,
    dropout 0.5): the whole-sequence route at L 50 (fused_attention_whole_*,
    the kernel table's row 7) and the key-tiled route at L 200
    (fused_attention_*, row 7b), beside the plain version (forward, and
    forward + autograd backward beside the backward kernel), the bound and
    F.scaled_dot_product_attention with a boolean mask in fp32 on inputs
    already in its (B, H, L, hd) layout (the transposes not counted), no
    dropout: forward, and forward + backward. The forward is also timed at
    dropout 0 (ms_rate0), like for like with the library; ms is the main
    path's rate 0.5. The bound: the function's own bytes, q, k, v and the
    key validity in and o out (forward), q, k, v, dO and the key validity in
    and dq, dk, dv out (backward: 6 slabs; what a design re-reads, such as
    the tiled route's o and row statistics, is not counted), and its
    products over the L (L + 1) / 2 causal pairs (two forward, five
    backward) at the fp32 rate."""
    out = {}
    for L, name in ((SASREC["L"], "fused_attention_whole"), (200, "fused_attention")):
        for way, t in time_attention_at(torch, L).items():
            out[f"{name}_{way}"] = t
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
        nbytes = slab * (6 if way == "bwd" else 4) + B * L * 4
        t = {"ms": cuda_ms(torch, kernel, 50), "plain_ms": cuda_ms(torch, plain, 20),
             "library_ms": cuda_ms(torch, lib, 50)}
        if way == "fwd":
            t["ms_rate0"] = cuda_ms(torch, lambda: fa.fused_attention_fwd_cuda(
                q, k, v, valid, causal=True), 50)
        t["bound_ms"], t["bound_by"] = bound(flops, nbytes)
        out[way] = t
        log(f"[time] fused_attention_{way} ({fa.fused_attention_route(L, hd)} route) B={B} "
            f"L={L} H={H} hd={hd} causal, dropout 0.5 ({flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB): {t}")
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
    bf16 tensor-core rate (bf16 instance); the fp32 entry also gives it at
    the 3xTF32 rate its kernels run at, a third of dense TF32
    (``bound_3xtf32_ms``). Every entry also gives the time in a CUDA graph
    (``graph_ms``)."""
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
                 "library_ms": cuda_ms(torch, lib, 20),
                 "graph_ms": graph_ms(torch, kernel, calls=20, replays=10)}
            t["bound_ms"], t["bound_by"] = bound(flops, nbytes,
                                                 PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
            if not bf16:
                t["bound_3xtf32_ms"], _ = bound(flops, nbytes, PEAK_TF32_FLOPS / 3)
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
    # every leaf of a step in one launch
    "adam_leaf": {"route": "cuda", "source": "recbole_tpu_torch/csrc/fused_adam.cu",
                  "replaces": "recbole_tpu/ops/fused_adam.py:75", "kernel": "adam_multi_kernel"},
    "onehot_matmul_grad": {"route": "cuda", "source": "recbole_tpu_torch/csrc/embed_grad.cu",
                           "replaces": "recbole_tpu/ops/embed_grad.py:78"},
    "windowed_grad": {"route": "cuda", "source": "recbole_tpu_torch/csrc/embed_grad.cu",
                      "replaces": "recbole_tpu/ops/embed_grad.py:170"},
    # the two whole-layer kernels, each in its bf16 instance (the JAX package's
    # trm_layer.py) and its fp32 instance (fused_transformer.py: 3xTF32)
    "trm_layer_fwd": {"route": "cuda", "source": "recbole_tpu_torch/csrc/trm_layer.cu",
                      "replaces": "recbole_tpu/ops/trm_layer.py:433",
                      "kernel": "trm_layer_bf16_fwd_kernel"},
    "trm_layer_bwd": {"route": "cuda", "source": "recbole_tpu_torch/csrc/trm_layer.cu",
                      "replaces": "recbole_tpu/ops/trm_layer.py:433",
                      "kernel": "trm_layer_bf16_bwd_kernel"},
    "fused_transformer_layer_fwd": {"route": "cuda",
                                    "source": "recbole_tpu_torch/csrc/trm_layer.cu",
                                    "replaces": "recbole_tpu/ops/fused_transformer.py:409",
                                    "kernel": "trm_layer_tf32x3_fwd_kernel"},
    "fused_transformer_layer_bwd": {"route": "cuda",
                                    "source": "recbole_tpu_torch/csrc/trm_layer.cu",
                                    "replaces": "recbole_tpu/ops/fused_transformer.py:409",
                                    "kernel": "trm_layer_tf32x3_bwd_kernel"},
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
    # the attention kernels by route: fused_attention_* the key-tiled kernels
    # (L > 64, timed at 200 positions), fused_attention_whole_* the
    # whole-sequence ones (L <= 64, timed at SASRec's 50)
    "fused_attention_fwd": {"route": "cuda",
                            "source": "recbole_tpu_torch/csrc/fused_attention.cu",
                            "replaces": "recbole_tpu/ops/fused_attention.py:204"},
    "fused_attention_bwd": {"route": "cuda",
                            "source": "recbole_tpu_torch/csrc/fused_attention.cu",
                            "replaces": "recbole_tpu/ops/fused_attention.py:204"},
    "fused_attention_whole_fwd": {"route": "cuda",
                                  "source": "recbole_tpu_torch/csrc/fused_attention.cu",
                                  "replaces": "recbole_tpu/ops/fused_attention.py:204"},
    "fused_attention_whole_bwd": {"route": "cuda",
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

    t_start = time.time()

    def clock(part):
        log(f"[clock] {part} done at {time.time() - t_start:.1f}s")

    name, count, smi = phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build(torch)
    clock("build")
    count_adam_steps()
    err = {"masked_topk": max(check_topk(torch, 4096, ML1M[1] + 1, 64, 10, seed=0),
                              check_topk(torch, 943, 1683, 64, 10, seed=3),
                              # SASRec's full-sort batches: 4,096, then the last 1,944
                              check_topk(torch, 4096, ML1M[1] + 1, 64, 10, seed=14, pad_only=True),
                              check_topk(torch, 1944, ML1M[1] + 1, 64, 10, seed=15, pad_only=True),
                              # D 4 mod 8 (zero-padded k-steps), D past one K chunk, one row
                              check_topk(torch, 943, 1683, 20, 10, seed=16),
                              check_topk(torch, 1944, ML1M[1] + 1, 128, 10, seed=17),
                              check_topk(torch, 1, ML1M[1] + 1, 64, 10, seed=18),
                              check_topk(torch, 1944, ML1M[1] + 1, 64, 10, seed=19, dup=True),
                              # widths the kernel refuses, padded by the dispatcher
                              check_topk(torch, 4096, ML1M[1] + 1, 10, 10, seed=20,
                                         dispatch=True),
                              check_topk(torch, 943, 1683, 6, 10, seed=21, dispatch=True),
                              # the bf16-operand instance: SASRec's and BPR's fused
                              # passes, D past one K chunk, and a width the dispatcher
                              # pads to a multiple of 8
                              check_topk(torch, 4096, ML1M[1] + 1, 64, 10, seed=22, bf16=True),
                              check_topk(torch, 943, 1683, 64, 10, seed=23, bf16=True),
                              check_topk(torch, 1944, ML1M[1] + 1, 128, 10, seed=24,
                                         dup=True, bf16=True),
                              check_topk(torch, 943, 1683, 20, 10, seed=25, dispatch=True,
                                         bf16=True)),
           "adam_leaf": max(
               *(check_adam(torch, label, shapes, heads, seed)
                 for seed, (label, (shapes, heads)) in enumerate(ADAM_SETS.items(), start=4)),
               *(check_adam(torch, f"edge leaves at offset {offset}, gradients at {g_offset}",
                            [(2053,), (3, 7), (), (4096,), (2047,), (37, 9)],
                            [6, 0, 0, 2, 0, 9], seed=9, none=(1,), offset=offset,
                            g_offset=g_offset)
                 for offset, g_offset in ((0, 0), (1, 1), (0, 1))),
               # weight decay: the four baselines' leaf set at ml-1m and BPR's
               # and SASRec's, at the baselines' 1e-8 and at 1e-2; and the
               # edge leaves (a missing gradient, zero heads) decayed
               *(check_adam(torch, f"{label} at weight decay {wd}", shapes, heads, seed, wd=wd)
                 for seed, ((label, (shapes, heads)), wd) in enumerate(
                     itertools.product(ADAM_WD_SETS.items(), ADAM_WDS), start=20)),
               check_adam(torch, "edge leaves at weight decay 0.01",
                          [(2053,), (3, 7), (), (4096,), (2047,), (37, 9)],
                          [6, 0, 0, 2, 0, 9], seed=30, none=(1,), offset=1, wd=1e-2),
               # the clip (the norm read from the device) on both sides of
               # max_norm, and adamw's decoupled term, over SASRec's leaves
               # (the [PAD] row a zero head) and the edge leaves
               *(check_adam(torch, f"sasrec, clip {clip}, adamw {dwd}", *ADAM_SETS["sasrec"],
                            seed=40 + i, clip=clip, dwd=dwd, wd=wd)
                 for i, (clip, dwd, wd) in enumerate((("below", 0.0, 0.0), ("above", 0.0, 0.0),
                                                      (None, 1e-4, 0.0),
                                                      ("below", 1e-4, 1e-2)))),
               check_adam(torch, "edge leaves, clip below, adamw",
                          [(2053,), (3, 7), (), (4096,), (2047,), (37, 9)],
                          [6, 0, 0, 2, 0, 9], seed=45, none=(1,), offset=1, clip="below",
                          dwd=1e-4))}
    # FFM's leaf set at the Criteo shape, as phase 4p's steps give it (no
    # pad_zero_params: no zero head): 1.03 B elements, a 4.0 GB leaf
    err["adam_leaf"] = max(err["adam_leaf"], check_adam(
        torch, "ffm_criteo", FFM_LEAF_SHAPES, [0] * len(FFM_LEAF_SHAPES), seed=46,
        card_draws=True))
    torch.cuda.empty_cache()
    clock("masked top-k and Adam checks")
    for kname, cases in embed_grad_cases(torch).items():
        err[kname] = check_embed_grad(torch, kname, cases)
    clock("embedding-gradient checks")
    images = yelp_bit_inputs(torch)
    err.update(check_trm_layer(torch))
    clock("whole-layer checks")
    err.update(check_bit_kernels(torch, images))
    for kname, e in check_bit_widths(torch, images).items():
        err[kname] = max(err[kname], e)
    del images
    clock("bit-kernel checks")
    err.update(check_gru(torch))
    clock("GRU checks")
    err.update(check_attention(torch))
    clock("attention checks")
    err.update(check_rel_apply(torch))
    for kname, e in check_rel_routes(torch).items():
        err[kname] = max(err[kname], e)
    torch.cuda.empty_cache()
    clock("build and checks")
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        for path, phase in (("bpr", phase_bpr), ("deepfm", phase_deepfm),
                            ("sasrec", phase_sasrec), ("sasrec_fp32", phase_sasrec_fp32),
                            ("lightgcn", phase_lightgcn), ("gru4rec", phase_gru4rec),
                            ("narm", phase_narm), ("sasrec_attention", phase_sasrec_attention),
                            ("trm_users", phase_trm_users)):
            got = phase(torch, tmp)
            # a phase of several paths returns them by name
            by_path.update(got if path in ("sasrec", "trm_users") else {path: got})
            clock(path)
        by_path.update(phase_wide(torch, tmp))
        clock("wide")
        by_path["ripplenet"] = phase_ripplenet(torch, tmp)
        clock("ripplenet")
        for model_name in KG_MODELS:
            by_path[model_name.lower()], loaders, trainer = phase_kg_model(torch, tmp, model_name)
            if model_name == "KGAT":
                time_attention_update(torch, trainer.model)
                by_path["kgat_ell"] = phase_kgat_ell(torch, tmp, loaders)
            del loaders, trainer
            torch.cuda.empty_cache()
            clock(model_name.lower())
        by_path.update(phase_routes(torch, tmp))
        clock("routes")
        by_path.update(phase_protocols(torch, tmp))
        clock("protocols")
        by_path.update(phase_gru_users(torch, tmp))
        clock("gru_users")
        by_path.update(phase_rest(torch, tmp))
        clock("rest")
        phase_quality(torch, tmp)
        clock("quality")
        phase_quality_kg(torch, tmp)
        clock("quality_kg")
        phase_quality_protocols(torch, tmp)
        clock("quality_protocols")
        phase_quality_gru_users(torch, tmp)
        clock("quality_gru_users")
        phase_quality_rest(torch, tmp)
        clock("quality_rest")
    timing = phase_timing(torch)
    clock("timing")
    kernels = [{"name": kname, **KERNEL_META[kname],
                "launches": sum(path[kname] for path in by_path.values()),
                "launches_by_path": {p: path[kname] for p, path in by_path.items()},
                "max_abs_err": err[kname], **timing[kname]} for kname in KERNEL_META]
    log(f"[clock] the whole run: {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": count}}))


if __name__ == "__main__":
    main()
