"""Trainer: train step, epoch loop, checkpoints, full-sort, sampled, labeled
and value-metric evaluation.

Port of recbole_tpu/trainer/trainer.py's base ``Trainer`` (parity target:
reference Trainer, recbole/trainer/trainer.py:62-452). The JAX trainer jits
one step and scans an epoch; here the same pieces run eagerly on the
model's device:

  * the training table is uploaded once, as one matrix per dtype, and
    shuffled batches are gathered on the device, one gather per matrix
    whatever the number of columns (the counterpart of the JAX trainer's
    ``_upload_columns`` under scan_epochs);
  * negatives are drawn on the device inside the step (``_make_rec_augment``:
    pairwise models get a negative column, pointwise ones their rows
    followed by k negative rows labelled 0; without exclusion for the
    sequential family, whose items may repeat; the fork's both-way sampler
    adds k negatives and round(k/3) pseudo-positives to every row, gated by
    ``_weight``); labeled rows (the CTR protocols, the fork's dataset
    negatives, listwise input, no sampling) pass through as they are; a
    loader's ``device_transform`` (the sequential family's padded-sequence
    gather) runs first;
  * a model may return its loss as a tuple of parts: the step sums them for
    the gradient and the epoch reports each part (parity: trainer.py:367);
  * train modes (``_build_mode``, parity: trainer.py:447-500): ``rs`` (rec
    batches, ``calculate_loss``), ``kg`` (KG triples with a negative tail
    each, ``calculate_kg_loss``), ``rskg`` (rec batches with random KG rows
    added, ``calculate_loss``) and ``rs_only_loss`` (``calculate_rs_loss``);
    ``KGTrainer`` picks one per epoch;
  * row 0 of every ``pad_zero_params`` gradient counts as zero in Adam (the
    kernel's ``zero_head``), so a [PAD] embedding row never trains;
  * the model is in train mode only inside the step, and draws its dropout
    masks from the trainer's generator;
  * Adam (and adamw) is the single-pass in-place sweep of ops/fused_adam.py
    over every float32 leaf at once, one launch a step
    (``_fused_adam_apply``), with the JAX chain's clip, coupled
    ``weight_decay`` and adamw's decoupled decay in it; sgd, adagrad,
    rmsprop and sparse_adam are plain torch (``_plain_learner_apply``),
    as optax computes them outside any kernel; the model's persistent
    buffers (state not trained, such as KGAT's attention) ride in the
    checkpoint beside the parameters;
  * ``eval_score_dtype: bfloat16`` rounds the fused step's query and
    table to bfloat16 (the kernel's bf16-operand instance: exact products,
    fp32 sums) and, in the non-fused ``score_items`` step, every float32
    parameter (not the dataset-derived buffers), as the JAX trainer does
    (trainer.py:936-1040); GAUC takes the non-fused step on every protocol,
    ranks from a stable descending sort with ties at their average rank
    (``evaluator.gauc_metric_sums``);
  * full-sort evaluation of a model that defines ``full_sort_query`` in
    its own class, or inherits the sequential base's whole dot-product stack
    (the JAX trainer's rule), goes through
    ops/masked_topk.py, masking [PAD] and, unless the loader says
    ``mask_history = False`` (sequential splits), the user's earlier-phase
    items; a model with its own ``full_sort_predict`` only (LightGCN, NARM)
    has its (B, n_items) float32 scores masked the same way and ranked by
    ``torch.topk``; a model with neither (RippleNet) is scored by its
    ``score_items`` over chunks of the item axis (2,048 items, or what
    ``eval_pair_bytes`` allows in 512 MB) and then ranked the same way;
    each batch reduces to per-metric partial sums on the device;
  * sampled evaluation (uni<k>/pop<k>, the fork's uni1000 validation) ranks
    each user's positives and P*k negatives drawn on the device, and the
    labeled evaluation (``eval_use_dataset_negatives``) the user's label-1
    then label-0 items, both by ``score_items``, equal scores in index order
    as ``jax.lax.top_k`` ranks them;
  * value-metric evaluation (``_evaluate_individual``) uploads the eval
    table once, predicts in device-sliced batches, and computes AUC/LogLoss
    on the device.

``get_trainer`` serves the general, context and sequential families with
``Trainer``, the knowledge family with ``KGTrainer``, MKR with
``MKRTrainer``, KGAT with ``KGATTrainer`` and S3Rec with ``S3RecTrainer``.
Still raising: the other trainer subclasses (ROADMAP Queue 1).
"""

import contextlib
import os
import time

import numpy as np
import torch

from ..models.base import AbstractRecommender, SequentialRecommender
from ..utils.enums import InputType, ModelType
from ..utils.logger import get_logger, get_local_time, set_color
from ..utils.utils import early_stopping, calculate_valid_score, dict2str, ensure_dir
from ..data.loaders import RowEvalLoader
from ..evaluator.evaluator import (topk_metric_sums, gauc_metric_sums, TopKCollector,
                                   ValueCollector)
from ..sampler.sampler import sample_negatives, sample_negatives_unchecked
from ..ops.fused_adam import AdamLeaves, adam_multi, clip_grad, global_grad_norm
from ..ops.masked_topk import masked_topk, masked_topk_fits
from .lazy_adam import lazy_adam_step

# the score of a masked item in the non-fused full-sort step (parity:
# trainer.py:36)
NEG_INF = -1e15


LEARNERS = ("adam", "sparse_adam", "adamw", "sgd", "adagrad", "rmsprop")
# the learners that run on the Adam kernel, and optax.adamw's decoupled decay
KERNEL_LEARNERS = ("adam", "adamw")
ADAMW_DECAY = 1e-4


def build_optimizer(config):
    """The optimizer settings (parity: build_optimizer, trainer.py:39-75),
    the JAX chain's order: ``clip_grad_norm`` (optax.clip_by_global_norm;
    a number, or a dict whose ``max_norm`` defaults to 5), then
    ``weight_decay`` coupled (optax.add_decayed_weights: ``wd * p`` joins
    the gradient; warned about and dropped for sparse_adam), then the
    learner. adam and adamw run on the Adam kernel with both terms in it;
    sgd, adagrad, rmsprop and sparse_adam are plain torch with optax's
    arithmetic (``_plain_learner_apply``). An unknown name logs a warning
    and trains with adam."""
    name = str(config["learner"]).lower()
    if name not in LEARNERS:
        get_logger().warning("Unknown learner %r, falling back to adam", name)
        name = "adam"
    clip = config["clip_grad_norm"]
    max_norm = None
    if clip:
        max_norm = float(clip.get("max_norm", 5.0) if isinstance(clip, dict) else clip)
    wd = float(config["weight_decay"] or 0.0)
    if wd and name == "sparse_adam":
        get_logger().warning("sparse_adam does not support weight_decay; ignoring it")
        wd = 0.0
    return {"learner": name, "lr": float(config["learning_rate"]), "weight_decay": wd,
            "max_norm": max_norm}


def invalid_item_mask(user_id, hist, hlen, n_items):
    """(B, n_items) int8, 1 for [PAD] and each user's earlier-phase items
    (parity: trainer.py:984-990). With ``hist`` None only [PAD] is masked."""
    B = user_id.shape[0]
    invalid = torch.zeros((B, n_items), dtype=torch.int8, device=user_id.device)
    if hist is None:
        invalid[:, 0] = 1
        return invalid
    uh = hist[user_id]
    hvalid = (torch.arange(uh.shape[1], device=uh.device)[None, :]
              < hlen[user_id][:, None])
    # the padding slots of a history row hold id 0 and write 0 there; the
    # [PAD] column is set after
    invalid.scatter_(1, uh, hvalid.to(torch.int8))
    invalid[:, 0] = 1
    return invalid


def history_masked_scores(scores, user_id, hist, hlen):
    """(B, n_items) float32 scores of the non-fused full-sort step: NEG_INF
    in the [PAD] column, then NEG_INF added at each valid history slot
    (twice for an item there twice), as the JAX step builds them (parity:
    trainer.py:1057-1064). With ``hist`` None only [PAD] is masked."""
    scores = scores.to(torch.float32).clone()
    scores[:, 0] = NEG_INF
    if hist is not None:
        uh = hist[user_id]
        hvalid = (torch.arange(uh.shape[1], device=uh.device)[None, :]
                  < hlen[user_id][:, None])
        scores.scatter_add_(1, uh.long(), torch.where(
            hvalid, NEG_INF, 0.0).to(torch.float32))
    return scores


def fused_full_sort(cls):
    """Whether full-sort evaluation of a model class takes the fused masked
    top-k: it defines ``full_sort_query`` in its own class, or it inherits
    the sequential base's ``full_sort_predict`` and ``full_sort_query``
    unchanged (parity: the ``opted_in or base_stack`` rule of the JAX
    trainer, trainer.py:938-951). A model that overrides
    ``full_sort_predict`` alone (NARM, LightGCN) takes the non-fused step."""
    base_stack = cls.full_sort_predict is SequentialRecommender.full_sort_predict
    return hasattr(cls, "full_sort_query") and ("full_sort_query" in cls.__dict__ or base_stack)


def pointwise_rows(batch, negs, iid_f, label_f):
    """A pointwise batch with sampled negatives (parity: trainer.py:
    271-287): the B original rows, labelled from the data (or by
    ``_weight``, or 1), then k blocks of B rows, block j holding every row's
    j-th negative item and label 0; every other column repeated."""
    B, k = negs.shape
    out = {}
    for f, v in batch.items():
        if f == iid_f:
            out[f] = torch.cat([v, negs.T.reshape(-1)])
        elif f == label_f:
            out[f] = torch.cat([v, torch.zeros(B * k, dtype=v.dtype, device=v.device)])
        else:
            out[f] = torch.cat([v] * (k + 1))
    if label_f not in batch:
        w = batch.get("_weight")
        pos = (torch.ones(B, dtype=torch.float32, device=negs.device) if w is None
               else w.to(torch.float32))
        out[label_f] = torch.cat([pos, torch.zeros(B * k, device=negs.device)])
    return out


def bothway_rows(batch, generator, consts, uid_f, iid_f, label_f, n_items, k, k3, rounds):
    """The both-ways sampler's batch (parity: trainer.py:222-248): the B rows
    as they are, then k blocks of B rows holding each row's j-th sampled
    negative, labelled 0, then k3 blocks holding its j-th sampled
    pseudo-positive, labelled 1, every other column repeated. Both
    expansions are emitted for every row: ``_weight`` keeps the negatives of
    label-1 rows and the pseudo-positives of label-0 rows (times the row's
    own weight). The negatives are drawn before the pseudo-positives, each
    excluding the user's train history."""
    users = batch[uid_f]
    B = users.shape[0]
    label = batch[label_f].to(torch.float32)
    w = batch.get("_weight")
    w = torch.ones(B, device=users.device) if w is None else w.to(torch.float32)
    negs = sample_negatives(generator, users, consts["hist"], consts["hlen"], n_items, k,
                            rounds=rounds)
    pseudo = sample_negatives(generator, users, consts["hist"], consts["hlen"], n_items, k3,
                              rounds=rounds)
    out = {f: torch.cat([v] * (1 + k + k3)) for f, v in batch.items()}
    out[iid_f] = torch.cat([batch[iid_f], negs.T.reshape(-1), pseudo.T.reshape(-1)])
    out[label_f] = torch.cat([label, label.new_zeros(B * k), label.new_ones(B * k3)])
    out["_weight"] = torch.cat([w, (w * label).repeat(k), (w * (1 - label)).repeat(k3)])
    return out


def draw_negatives(generator, user_id, consts, count, n_items, rounds, repeatable):
    """(B, count) negatives for a train batch or a sampled eval batch
    (parity: trainer.py:230-234, :1117-1123): without exclusion for the
    sequential family (``repeatable``: items may repeat in a history), else
    excluding ``consts``' history table; from ``consts["pop"]`` where the
    distribution is popularity. One function, so that a caller can hand the
    steps other draws."""
    if repeatable:
        return sample_negatives_unchecked(generator, (user_id.shape[0], count), n_items,
                                          pop_items=consts.get("pop"), device=user_id.device)
    return sample_negatives(generator, user_id, consts["hist"], consts["hlen"], n_items,
                            count, rounds=rounds, pop_items=consts.get("pop"))


def candidate_hits(scores, pos_len, max_k):
    """(B, max_k) int32 hit rows of a ranking of ``masked_candidate_scores``
    whose first ``pos_len`` candidates are the positives (parity:
    trainer.py:1131-1143): a ranked slot is a hit when its index is below
    ``pos_len``. Equal scores rank the lower index first, as
    ``jax.lax.top_k`` does (a stable sort; ``torch.topk`` leaves their order
    open): a sequential split's negatives may repeat its target, whose
    score they then equal."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :max_k]
    return (order < pos_len[:, None]).to(torch.int32)


def masked_candidate_scores(scores, cand_valid, max_k):
    """float32 candidate scores, NEG_INF at an invalid candidate, padded
    with NEG_INF to at least ``max_k`` columns (the fork's top-k padding
    fix, abstract_evaluator.py:71-74; parity: trainer.py:1132-1137)."""
    scores = scores.to(torch.float32).masked_fill(~cand_valid, NEG_INF)
    if scores.shape[1] < max_k:
        scores = torch.nn.functional.pad(scores, (0, max_k - scores.shape[1]), value=NEG_INF)
    return scores


def candidate_metric_sums(metrics, scores, cand_valid, pos_len, P, max_k, mask,
                          user_len=None):
    """The top-k metric sums of a candidate step whose first ``P`` slots
    hold each user's ``pos_len`` positives, and, where ``user_len`` (each
    user's valid candidates, float32) is given, GAUC's sums over the same
    masked scores (parity: trainer.py:1144-1151, :1189-1200)."""
    scores = masked_candidate_scores(scores, cand_valid, max_k)
    sums = topk_metric_sums(metrics, candidate_hits(scores, pos_len, max_k), pos_len, mask)
    if user_len is not None:
        slot = torch.arange(scores.shape[1], device=scores.device)[None, :]
        pos01 = ((slot < pos_len[:, None]) & (slot < P)).to(torch.int32)
        sums.update(gauc_metric_sums(scores, pos01, pos_len, user_len, mask))
    return sums


def eval_bf16(config):
    """Whether ``eval_score_dtype`` asks for bfloat16 scores."""
    dtype = str(config["eval_score_dtype"]).lower()
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"eval_score_dtype {dtype!r}: the port has float32 and bfloat16")
    return dtype == "bfloat16"


@contextlib.contextmanager
def bf16_parameters(model, on=True):
    """Inside: every float32 parameter of ``model`` holds its values rounded
    to bfloat16 (the JAX trainer casts every float32 leaf of the param tree
    but ``_const``, trainer.py:1028-1038; the port's buffers, its
    dataset-derived arrays and frozen tables, stay as they are). The
    rounded values stay in float32 storage: a product of two of them is
    exact in fp32 and the sums are fp32, as the JAX models' dots with
    ``preferred_element_type=float32`` sum them (a bfloat16 tensor would
    round every product's output to bf16 in torch). Restored on exit."""
    saved = []
    if on:
        for p in model.parameters():
            if p.dtype == torch.float32:
                saved.append((p, p.data))
                p.data = p.data.to(torch.bfloat16).to(torch.float32)
    try:
        yield
    finally:
        for p, data in saved:
            p.data = data


class Trainer:
    ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

    def __init__(self, config, model):
        self.config = config
        self.model = model
        self.device = model.device
        self.logger = get_logger()
        self.optimizer = build_optimizer(config)
        self.epochs = config["epochs"]
        self.eval_step = min(config["eval_step"], self.epochs) or 1
        self.stopping_step = config["stopping_step"]
        self.valid_metric = config["valid_metric"]
        self.valid_metric_bigger = config["valid_metric_bigger"]
        self.checkpoint_dir = config["checkpoint_dir"]
        self.saved_model_file = os.path.join(
            self.checkpoint_dir,
            f"{config['model']}-{get_local_time()}.ckpt")
        self.best_valid_score = None
        self.best_valid_result = None
        self.start_epoch = 0
        self.cur_step = 0
        self.opt_state = None
        # (mu, nu, AdamLeaves) of the optimizer state the leaves were built on
        self._adam_leaves = None
        self._pad_heads = None
        self.train_loss_dict = {}
        self._modes = {}
        self._eval_step_cache = {}
        # shuffling and negatives draw from their own stream, apart from the
        # model's init stream (seeded with ``seed``)
        seed = config["seed"] or 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    # ------------------------------------------------------------- train step

    # the train mode of every epoch (KGTrainer picks per epoch)
    default_train_mode = "rs"

    def _make_kg_augment(self, train_data, include_rec):
        """KG-stream batch shaping (parity: trainer.py:127-165): one negative
        tail per triple, drawn on the device and excluding the head's known
        tails (KGSampler, sampler.py:268-338). With ``include_rec`` random KG
        rows are ADDED onto a rec batch, one per row (the rskg mode: the
        reference zips a restarted shuffled KG stream, knowledge_dataloader.py:
        183-190; random rows give the same distribution over an epoch).
        Returns (augment, consts)."""
        cfg = self.config
        uid_f = cfg["USER_ID_FIELD"]
        head_f = cfg["HEAD_ENTITY_ID_FIELD"]
        neg_tail_f = cfg["NEG_PREFIX"] + cfg["TAIL_ENTITY_ID_FIELD"]
        rounds = cfg["neg_sampling_resample_rounds"]
        hist, hlen = train_data.kg_head_history
        consts = {
            "kg_cols": {f: torch.as_tensor(np.asarray(v, np.int64), device=self.device)
                        for f, v in train_data.kg_columns.items()},
            "kg_head_hist": torch.as_tensor(hist, device=self.device).long(),
            "kg_head_hlen": torch.as_tensor(hlen, device=self.device).long(),
        }
        n_entities = train_data.n_entities
        n_kg = len(train_data.kg_columns[head_f])

        def kg_augment(batch, generator, consts):
            out = dict(batch)
            if include_rec:
                B = batch[uid_f].shape[0]
                idx = torch.randint(0, n_kg, (B,), generator=generator, device=self.device)
                for f, col in consts["kg_cols"].items():
                    out[f] = col[idx]
            negs = sample_negatives(generator, out[head_f], consts["kg_head_hist"],
                                    consts["kg_head_hlen"], n_entities, 1, rounds=rounds)
            out[neg_tail_f] = negs[:, 0]
            return out

        return kg_augment, consts

    def _make_rec_augment(self, train_data):
        """Device-side batch shaping (parity: trainer.py:166-289): the
        loader's device transform first; then labeled rows pass through (the
        pure-feature protocol, ``train_use_dataset_negatives``, listwise
        input, and no sampling); ``train_use_bothway_sampler`` gives every
        row k sampled negatives labelled 0 and round(k/3) sampled
        pseudo-positives labelled 1, both expansions emitted for every row
        and gated by ``_weight`` (the fork's GeneralNegSampleBothWaysDataloader,
        custom_dataloaders.py:16-44); pairwise models get a sampled negative
        column; pointwise ones their rows (labelled from the data, or by
        ``_weight``, or 1) followed by k rows of sampled negatives labelled 0.
        Returns (augment, consts)."""
        model = self.model
        cfg = self.config
        uid_f = cfg["USER_ID_FIELD"]
        iid_f = cfg["ITEM_ID_FIELD"]
        neg_args = cfg["train_neg_sample_args"]
        k = int(neg_args.get("by") or 0) if neg_args["strategy"] == "by" else 0
        transform = getattr(train_data, "device_transform", None)
        if (uid_f is None or iid_f is None or cfg["train_use_dataset_negatives"]
                or model.input_type is InputType.LISTWISE
                or (k == 0 and model.input_type is not InputType.PAIRWISE)):
            # pure-feature CTR protocol (Criteo/Avazu: USER_ID_FIELD: ~), or
            # labeled rows used as they are (the fork's
            # GeneralNegFromDatasetDataLoader): nothing to sample
            if transform is None:
                return (lambda batch, generator, consts: batch), {}
            return ((lambda batch, generator, consts: transform(batch, consts)),
                    dict(transform.consts(self.device)))
        if k < 1:
            raise ValueError("pairwise training needs training_neg_sample_num >= 1")
        pointwise = model.input_type is InputType.POINTWISE
        rounds = cfg["neg_sampling_resample_rounds"]
        neg_f = cfg["NEG_PREFIX"] + iid_f
        label_f = cfg["LABEL_FIELD"]
        n_items = train_data.n_items
        # sequential models sample without used-id exclusion: items may repeat
        # in a history (parity: RepeatableSampler, sampler.py:341-420)
        repeatable = model.type is ModelType.SEQUENTIAL
        bothway = bool(cfg["train_use_bothway_sampler"])
        k3 = max(int(round(k / 3)), 1)
        consts = {}
        if not repeatable:
            train_data.phase_history.assert_sampleable("train")
        if not repeatable or bothway:
            hist, hlen = train_data.phase_history.device_tables("train", self.device)
            consts = {"hist": hist, "hlen": hlen}
        if transform is not None:
            consts.update(transform.consts(self.device))
        if neg_args.get("distribution") == "popularity":
            consts["pop"] = torch.as_tensor(
                train_data.phase_history.pop_items["train"], device=self.device)

        def augment(batch, generator, consts):
            if transform is not None:
                batch = transform(batch, consts)
            if bothway:
                return bothway_rows(batch, generator, consts, uid_f, iid_f, label_f,
                                    n_items, k, k3, rounds)
            negs = draw_negatives(generator, batch[uid_f], consts, k, n_items, rounds,
                                  repeatable)
            if pointwise:
                return pointwise_rows(batch, negs, iid_f, label_f)
            if k == 1:
                out = dict(batch)
                out[neg_f] = negs[:, 0]
                return out
            # each positive row repeated k times, one negative each
            out = {f: v.repeat_interleave(k, dim=0) for f, v in batch.items()}
            out[neg_f] = negs.reshape(-1)
            return out

        return augment, consts

    def _fused_adam_init(self):
        """The optimizer state: the step count and, by learner, the Adam
        moments ``mu`` and ``nu`` (adam, adamw, sparse_adam), adagrad's
        ``sum_of_squares`` (0.1 to start, optax's initial accumulator) or
        rmsprop's ``nu``; sgd keeps only the count."""
        params = dict(self.model.named_parameters())
        bad = [n for n, p in params.items() if p.dtype != torch.float32]
        if bad:
            raise NotImplementedError(f"non-float32 parameters {bad}: the port's "
                                      "optimizers take float32 leaves only")
        learner = self.optimizer["learner"]
        state = {"count": 0}
        if learner in ("adam", "adamw", "sparse_adam"):
            state["mu"] = {n: torch.zeros_like(p) for n, p in params.items()}
            state["nu"] = {n: torch.zeros_like(p) for n, p in params.items()}
        elif learner == "adagrad":
            state["sum_of_squares"] = {n: torch.full_like(p, 0.1) for n, p in params.items()}
        elif learner == "rmsprop":
            state["nu"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    def _apply_gradients(self, grads):
        """The step's update from ``grads`` (one a parameter, None for a
        leaf the loss does not reach): the Adam kernel for adam and adamw,
        else the plain learners. A gradient autograd leaves strided (the
        weight of a product whose input was a reshaped view) is made
        contiguous first: the kernel reads each leaf's elements in order."""
        grads = [g if g is None or g.is_contiguous() else g.contiguous() for g in grads]
        if self.optimizer["learner"] in KERNEL_LEARNERS:
            self._fused_adam_apply(grads)
        else:
            self._plain_learner_apply(grads)

    def _zero_heads(self):
        """Each parameter's [PAD] width: the first row of a
        ``pad_zero_params`` table, else 0 (the parameters are fixed once the
        model is built, so the list is made once)."""
        if self._pad_heads is None:
            pad_zero = getattr(self.model, "pad_zero_params", ())
            self._pad_heads = [p[0].numel() if n in pad_zero else 0
                               for n, p in self.model.named_parameters()]
        return self._pad_heads

    def _clip(self, grads):
        """(global norm, max_norm) of the step's gradients when
        ``clip_grad_norm`` is set, else None; the norm stays on the device.
        The plain learners' clip: adam and adamw hand the Adam launcher
        ``(None, max_norm)``, and it takes the norm on its own leaf table."""
        max_norm = self.optimizer["max_norm"]
        if max_norm is None:
            return None
        norm = global_grad_norm(grads, self._zero_heads())
        return None if norm is None else (norm, max_norm)

    def _plain_learner_apply(self, grads):
        """sgd, adagrad, rmsprop and sparse_adam in plain torch, optax's
        arithmetic (optax 0.2.6's sgd, adagrad, rmsprop; lazy_adam.py), on
        gradients made as the JAX chain makes them: None read as zeros, the
        [PAD] rows zeroed, clipped, then the coupled decay added."""
        opt, state = self.optimizer, self.opt_state
        lr, wd = opt["lr"], opt["weight_decay"]
        clip = self._clip(grads)
        names = [n for n, _ in self.model.named_parameters()]
        params = [p.data for _, p in self.model.named_parameters()]
        state["count"] += 1
        full = []
        with torch.no_grad():
            for p, g, head in zip(params, grads, self._zero_heads()):
                g = torch.zeros_like(p) if g is None else g.clone()
                if head:
                    g.view(-1)[:head] = 0.0
                if clip is not None:
                    g = clip_grad(g, *clip)
                if wd:
                    g = g + wd * p
                full.append(g)
            learner = opt["learner"]
            if learner == "sparse_adam":
                lazy_adam_step(params, full, [state["mu"][n] for n in names],
                               [state["nu"][n] for n in names], state["count"], lr=lr,
                               b1=self.ADAM_B1, b2=self.ADAM_B2, eps=self.ADAM_EPS)
                return
            for n, p, g in zip(names, params, full):
                if learner == "adagrad":
                    t = state["sum_of_squares"][n]
                    t.copy_(g * g + t)
                    g = torch.where(t > 0, torch.rsqrt(t + 1e-7),
                                    torch.zeros((), device=t.device)) * g
                elif learner == "rmsprop":
                    nu = state["nu"][n]
                    nu.copy_((1 - 0.9) * g ** 2 + 0.9 * nu)
                    g = torch.rsqrt(nu + 1e-8) * g
                p.add_(-lr * g)

    def _fused_adam_apply(self, grads):
        """One Adam step over every parameter, in place, in one launch on the
        card (parity: trainer.py:317-354, same defaults as optax.adam; with
        ``weight_decay``, ``clip_grad_norm`` or adamw, the optax chain of
        build_optimizer, trainer.py:39-75: the clip's norm is computed on the
        device and read by the kernel).
        ``grads`` holds one gradient a parameter in ``named_parameters()``
        order, None for a leaf the loss does not reach (a zero gradient, as
        jax.grad gives it). c1 and c2 come from the integer step count on the
        host, so nothing waits on the device."""
        b1, b2, eps = self.ADAM_B1, self.ADAM_B2, self.ADAM_EPS
        lr = self.optimizer["lr"]
        self.opt_state["count"] += 1
        t = self.opt_state["count"]
        c1 = 1.0 / (1.0 - b1 ** t)
        c2 = 1.0 / (1.0 - b2 ** t)
        dwd = ADAMW_DECAY if self.optimizer["learner"] == "adamw" else 0.0
        max_norm = self.optimizer["max_norm"]
        adam_multi(self._step_leaves(), grads, c1, c2, b1=b1, b2=b2, lr=lr, eps=eps,
                   wd=self.optimizer["weight_decay"],
                   clip=None if max_norm is None else (None, max_norm), dwd=dwd)

    def _step_leaves(self):
        """The AdamLeaves of the parameters and the optimizer state's moments,
        built again when those moments are replaced (``_fused_adam_init``,
        ``resume_checkpoint``). The reference's Embedding(padding_idx=0) never
        updates row 0: each ``pad_zero_params`` leaf's first row counts as a
        zero gradient, so the [PAD] row and its moments stay zero."""
        mu, nu = self.opt_state["mu"], self.opt_state["nu"]
        built = self._adam_leaves
        if built is None or built[0] is not mu or built[1] is not nu:
            params = dict(self.model.named_parameters())
            built = (mu, nu, AdamLeaves(
                [p.data for p in params.values()], [mu[n] for n in params],
                [nu[n] for n in params], self._zero_heads()))
            self._adam_leaves = built
        return built[2]

    def _make_step_core(self, augment, loss_method):
        """step_core(batch, consts) -> detached loss (a vector of its parts
        when the loss method returns a tuple): augment, loss, gradients and
        the fused Adam update, drawing randomness (negatives, dropout masks)
        from ``self.generator`` (parity: trainer.py:356-395). The model is in
        train mode for the loss only."""
        params = list(self.model.parameters())

        def step_core(batch, consts):
            batch = augment(batch, self.generator, consts)
            self.model.train()
            try:
                out = loss_method(batch, generator=self.generator)
            finally:
                self.model.eval()
            # a tuple of loss parts: their sum is the loss, each is reported
            loss = sum(out) if isinstance(out, tuple) else out
            # None for a leaf the loss does not reach (LR never reads the
            # embedding of a float field): Adam reads it as a zero gradient
            self._apply_gradients(torch.autograd.grad(loss, params, allow_unused=True))
            if isinstance(out, tuple):
                return torch.stack([part.detach() for part in out])
            return loss.detach()

        return step_core

    def _upload_table(self, cols):
        """A whole train or eval table on the device as one (n, k) matrix per
        dtype and row shape (ids int64, everything else float32), so that a
        batch costs one gather or slice per matrix, not one per column: the
        CTR protocols have tens of columns. Returns [(fields, matrix)]."""
        groups = {}
        for f, v in cols.items():
            kind = np.int64 if np.issubdtype(v.dtype, np.integer) else np.float32
            groups.setdefault((kind, v.shape[1:]), []).append(f)
        return [(fields, torch.as_tensor(
                    np.stack([cols[f].astype(kind, copy=False) for f in fields], axis=1),
                    device=self.device))
                for (kind, _), fields in groups.items()]

    @staticmethod
    def _take_batch(tables, idx):
        """Rows ``idx`` (an index tensor or a slice) of every matrix, as a dict
        of per-field column views."""
        batch = {}
        for fields, matrix in tables:
            rows = matrix[idx]
            for j, f in enumerate(fields):
                batch[f] = rows[:, j]
        return batch

    def _build_mode(self, train_data, mode=None):
        """The step, device constants, uploaded table and loader of one train
        mode (parity: trainer.py:447-500, KGDataLoaderState):
          rs           rec batches, ``calculate_loss``;
          kg           KG-triple batches with a negative tail each,
                       ``calculate_kg_loss``;
          rskg         rec batches with KG rows added, ``calculate_loss``;
          rs_only_loss rec batches, ``calculate_rs_loss``.
        Built once per mode and kept."""
        mode = mode or self.default_train_mode
        if mode in self._modes:
            return self._modes[mode]
        model = self.model
        loader = train_data
        if mode == "rs":
            augment, consts = self._make_rec_augment(train_data)
            loss_method = model.calculate_loss
        elif mode == "kg":
            from ..data.loaders import ArrayTrainLoader
            loader = ArrayTrainLoader(self.config, train_data.kg_columns)
            augment, consts = self._make_kg_augment(train_data, include_rec=False)
            loss_method = model.calculate_kg_loss
        elif mode == "rskg":
            rec_aug, rec_consts = self._make_rec_augment(train_data)
            kg_aug, kg_consts = self._make_kg_augment(train_data, include_rec=True)
            consts = {**rec_consts, **kg_consts}

            def augment(batch, generator, consts):
                return kg_aug(rec_aug(batch, generator, consts), generator, consts)
            loss_method = model.calculate_loss
        elif mode == "rs_only_loss":
            augment, consts = self._make_rec_augment(train_data)
            loss_method = model.calculate_rs_loss
        else:
            raise ValueError(f"unknown train mode {mode!r}")
        bundle = {"step": self._make_step_core(augment, loss_method), "consts": consts,
                  "tables": self._upload_table(loader.columns()), "loader": loader}
        self._modes[mode] = bundle
        return bundle

    def _train_epoch(self, train_data, epoch_idx, mode=None):
        """One epoch of shuffled batches sliced on the device. The loss stays
        on the device until the epoch ends; the NaN check (parity: reference
        trainer.py:234-236) runs once per epoch on the total. Returns the
        total, or a tuple of the parts' totals."""
        bundle = self._build_mode(train_data, mode)
        loader = bundle["loader"]
        n, B = loader.n, loader.batch_size
        if loader.shuffle:
            order = torch.randperm(n, generator=self.generator, device=self.device)
        else:
            order = torch.arange(n, device=self.device)
        total = None
        for start in range(0, n, B):
            idx = order[start:start + B]
            parts = bundle["step"](self._take_batch(bundle["tables"], idx), bundle["consts"])
            total = parts if total is None else total + parts
        if total is None:
            return 0.0
        total = np.atleast_1d(total.cpu().numpy()).astype(np.float64)
        if np.isnan(total).any():
            raise ValueError(f"Training loss is nan at epoch {epoch_idx}")
        return tuple(total.tolist()) if len(total) > 1 else float(total[0])

    def prepare(self, train_data):
        """Initialize the optimizer state and build the default train mode."""
        if self.opt_state is None:
            self.opt_state = self._fused_adam_init()
        self._modes = {}
        self._build_mode(train_data)

    # -------------------------------------------------------------------- fit

    def fit(self, train_data, valid_data=None, verbose=True, saved=True,
            show_progress=False, callback_fn=None):
        if saved:
            ensure_dir(self.checkpoint_dir)
        self.prepare(train_data)

        if saved and self.start_epoch >= self.epochs:
            self._save_checkpoint(-1)

        best_score, cur_step = self.best_valid_score, self.cur_step
        for epoch_idx in range(self.start_epoch, self.epochs):
            t0 = time.time()
            train_loss = self._train_epoch(train_data, epoch_idx)
            self.train_loss_dict[epoch_idx] = (
                sum(train_loss) if isinstance(train_loss, tuple) else train_loss)
            t1 = time.time()
            if verbose:
                loss_str = (", ".join(f"{part:.4f}" for part in train_loss)
                            if isinstance(train_loss, tuple) else f"{train_loss:.4f}")
                self.logger.info("epoch %d training [time: %.2fs, train loss: %s]",
                                 epoch_idx, t1 - t0, loss_str)

            if valid_data is None or (epoch_idx + 1) % self.eval_step != 0:
                if saved and valid_data is None:
                    self._save_checkpoint(epoch_idx)
                continue

            valid_result = self.evaluate(valid_data, load_best_model=False)
            valid_score = calculate_valid_score(valid_result, self.valid_metric)
            best_score, cur_step, stop_flag, update_flag = early_stopping(
                valid_score, best_score, cur_step, self.stopping_step,
                bigger=self.valid_metric_bigger)
            self.cur_step = cur_step
            t2 = time.time()
            if verbose:
                self.logger.info("epoch %d evaluating [time: %.2fs, valid_score: %f]",
                                 epoch_idx, t2 - t1, valid_score)
                self.logger.info("valid result: \n%s", dict2str(valid_result))
            if update_flag:
                self.best_valid_score = valid_score
                self.best_valid_result = valid_result
                if saved:
                    self._save_checkpoint(epoch_idx)
                    if verbose:
                        self.logger.info(set_color("Saving current best", "blue")
                                         + f": {self.saved_model_file}")
            if callback_fn:
                callback_fn(epoch_idx, valid_score)
            if stop_flag:
                if verbose:
                    self.logger.info("Finished training, best eval result in epoch %d",
                                     epoch_idx - cur_step * self.eval_step)
                break
        return self.best_valid_score, self.best_valid_result

    # ------------------------------------------------------------- checkpoint

    def _state_buffers(self):
        """The model's persistent buffers: state that is not trained but
        changes in training (KGAT's attention), which a checkpoint carries
        beside the parameters. Dataset-derived arrays, and what derives
        from that state (KGAT's dense blocks, rebuilt by the model's
        ``load_state_dict`` post-hook), are non-persistent."""
        params = {n for n, _ in self.model.named_parameters()}
        return {n: b for n, b in self.model.state_dict(keep_vars=True).items()
                if n not in params}

    def _save_checkpoint(self, epoch):
        """torch.save of the learned state, the model's persistent buffers,
        moments and generator state (parity: trainer.py:805-826; single
        device)."""
        state = {
            "config": dict(self.config.final),
            "epoch": epoch,
            "cur_step": self.cur_step,
            "train_loss_dict": dict(self.train_loss_dict),
            "best_valid_score": self.best_valid_score,
            "best_valid_result": self.best_valid_result,
            "params": {n: p.detach().cpu() for n, p in self.model.named_parameters()},
            "buffers": {n: b.detach().cpu() for n, b in self._state_buffers().items()},
            "opt_state": {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v)
                          for k, v in self.opt_state.items()},
            "rng": self.generator.get_state(),
        }
        torch.save(state, self.saved_model_file)

    def _load_state(self, path):
        # the file is one this trainer wrote: its config holds enums, which
        # torch.load's weights_only mode refuses
        return torch.load(path, map_location="cpu", weights_only=False)

    def _load_params(self, state):
        """The parameters and persistent buffers of a checkpoint's state,
        through ``load_state_dict`` so that the model's post-hooks run."""
        self.model.load_state_dict({**state["params"], **state.get("buffers", {})})

    def resume_checkpoint(self, resume_file):
        state = self._load_state(resume_file)
        self.start_epoch = state["epoch"] + 1
        self.cur_step = state.get("cur_step", 0)
        self.train_loss_dict = dict(state.get("train_loss_dict", {}))
        self.best_valid_score = state["best_valid_score"]
        self.best_valid_result = state.get("best_valid_result")
        self._load_params(state)
        self.opt_state = {k: ({n: t.to(self.device) for n, t in v.items()}
                              if isinstance(v, dict) else v)
                          for k, v in state["opt_state"].items()}
        self.generator.set_state(state["rng"])
        if state["config"].get("model") != self.config["model"]:
            self.logger.warning("Architecture configuration given in config file is "
                                "different from that of checkpoint.")
        self.logger.info("Checkpoint loaded. Resume training from epoch %d",
                         self.start_epoch)

    def load_params(self, model_file):
        self._load_params(self._load_state(model_file))

    # ------------------------------------------------------------- evaluation

    def _make_full_sort_eval_step(self, eval_data, metrics, max_k, needs_gauc=False):
        """Full-sort step: the loader's device transform, then [PAD] masked
        always and the user's earlier-phase items unless the loader has
        ``mask_history = False``, then the hits reduce to metric partial
        sums. A model with ``full_sort_query`` in its own class, or with the
        sequential base's ``full_sort_predict`` and ``full_sort_query``
        unchanged, takes the fused path (parity: trainer.py:934-1004, the
        ``opted_in or base_stack`` rule :938-951): its query and item table
        go through the masked top-k, or, at a width or k the kernel does not
        take (``masked_topk_fits``), their product through the non-fused
        step. A model with ``full_sort_predict`` only
        takes the non-fused
        one (parity: trainer.py:1052-1075): float32 scores from
        ``full_sort_predict`` or, for a model with neither, from chunks of
        ``score_items`` (a ``full_sort_fallback`` model's always); NEG_INF in
        the [PAD] column and added at the history, ``torch.topk``.

        ``eval_score_dtype: bfloat16`` (parity: trainer.py:936, :981-983,
        :1028-1038): the fused step rounds the query and the table to
        bfloat16 (exact products, fp32 sums: the kernel's bf16 instance);
        the chunked ``score_items`` step runs with every float32 parameter
        rounded to bfloat16 (``bf16_parameters``); ``full_sort_predict`` is
        unchanged. With GAUC (``needs_gauc``) the non-fused step runs and
        its masked scores also give ``gauc_metric_sums`` over all n_items
        (parity: :960-963, :1075-1081)."""
        model = self.model
        uid_f = self.config["USER_ID_FIELD"]
        bf16 = eval_bf16(self.config)
        # a model's full_sort_fallback (KGCN past one hop) sends it to the
        # chunked score_items step (parity: trainer.py:930-932, :951)
        fallback = bool(getattr(model, "full_sort_fallback", False))
        fused = fused_full_sort(type(model)) and not fallback and not needs_gauc
        has_full_sort = (type(model).full_sort_predict
                         is not AbstractRecommender.full_sort_predict and not fallback)
        consts = {"hist": None, "hlen": None}
        if getattr(eval_data, "mask_history", True):
            consts["hist"], consts["hlen"] = eval_data.phase_history.device_tables(
                eval_data.mask_phase, self.device)
        transform = getattr(eval_data, "device_transform", None)
        if transform is not None:
            consts.update(transform.consts(self.device))
        n_items = eval_data.n_items

        def all_item_scores(batch):
            """(B, n_items) scores: full_sort_predict, or the model's
            score_items over chunks of the item axis (parity: trainer.py:
            1006-1045, the reference's _spilt_predict): a chunk of 2,048
            items, or as many as keep B x chunk x ``eval_pair_bytes`` within
            512 MB (a multiple of 128, at least 128); the last chunk wraps
            around to item 0 and its extra columns are cut."""
            if has_full_sort:
                return model.full_sort_predict(batch)
            B = batch[uid_f].shape[0]
            pair_bytes = int(getattr(model, "eval_pair_bytes", 0) or 0)
            if pair_bytes:
                chunk = min(n_items, max(128, (512 << 20) // (B * pair_bytes) // 128 * 128))
            else:
                chunk = min(2048, n_items)
            n_chunks = -(-n_items // chunk)
            items = (torch.arange(n_chunks * chunk, device=self.device) % n_items).reshape(
                n_chunks, chunk)
            with bf16_parameters(model, bf16):
                scores = [model.score_items(batch, c[None, :].expand(B, chunk)).to(torch.float32)
                          for c in items]
            return torch.cat(scores, dim=1)[:, :n_items]

        def eval_step(consts, batch):
            pos_items = batch.pop("pos_items")
            pos_len = batch.pop("pos_len")
            mask = batch.pop("_mask")
            if transform is not None:
                batch = transform(batch, consts)
            user_id = batch[uid_f]
            scores = None
            if fused:
                query, table = model.full_sort_query(batch)
                if bf16:
                    query, table = query.to(torch.bfloat16), table.to(torch.bfloat16)
                if masked_topk_fits(query.shape[1], max_k):
                    invalid = invalid_item_mask(user_id, consts["hist"], consts["hlen"],
                                                n_items)
                    _, topk_idx = masked_topk(query.contiguous(), table.contiguous(),
                                              invalid, max_k)
                else:
                    # wider than the kernel's 512 or k past its 128: the
                    # non-fused step on the same query, the product that
                    # full_sort_predict gives for a model on the fused rule
                    # (rounded operands: exact products summed in fp32)
                    scores = query.to(torch.float32) @ table.to(torch.float32).T
            else:
                scores = all_item_scores(batch)
            if scores is not None:
                scores = history_masked_scores(scores, user_id, consts["hist"], consts["hlen"])
                _, topk_idx = torch.topk(scores, max_k, dim=1)
            pos_valid = (torch.arange(pos_items.shape[1], device=pos_items.device)[None, :]
                         < pos_len[:, None])
            pos_index = ((topk_idx[:, :, None].long() == pos_items[:, None, :])
                         & pos_valid[:, None, :]).any(dim=-1).to(torch.int32)
            sums = topk_metric_sums(metrics, pos_index, pos_len, mask)
            if needs_gauc:
                B = user_id.shape[0]
                pos_matrix = torch.zeros((B, n_items), dtype=torch.int32, device=scores.device)
                pos_matrix.scatter_reduce_(1, pos_items.long(), pos_valid.to(torch.int32), "amax")
                user_len = torch.full((B,), float(n_items), device=scores.device)
                sums.update(gauc_metric_sums(scores, pos_matrix, pos_len, user_len, mask))
            return sums

        return eval_step, consts

    def _upload_eval_batch(self, batch):
        return {k: torch.as_tensor(v, device=self.device).to(
                    torch.int64 if np.issubdtype(v.dtype, np.integer) else torch.float32)
                for k, v in batch.items()}

    def _evaluate_individual(self, eval_data):
        """Value-metric path: predictions against labels over plain rows
        (parity: trainer.py:1205-1257; reference LossEvaluator,
        evaluators.py:289-367). The eval table is uploaded once and kept
        with the loader; batches are sliced on the device; the metrics are
        computed there and only their values return to the host. The upload
        is keyed on the device, not on the trainer, so that a loader shared
        by several trainers keeps none of them (nor their models) alive."""
        label_f = self.config["LABEL_FIELD"]
        cached = getattr(eval_data, "_individual_cache", None)
        if cached is None or cached[0] != self.device:
            cached = (self.device, self._upload_table(eval_data.fields))
            eval_data._individual_cache = cached
        tables = cached[1]
        n, B = eval_data.n, eval_data.batch_size
        collector = ValueCollector(self.config)
        self.model.eval()
        with torch.no_grad():
            for start in range(0, n, B):
                batch = self._take_batch(tables, slice(start, start + B))
                collector.collect(batch[label_f], self.model.predict(batch))
        return collector.evaluate()

    def _make_sampled_eval_step(self, eval_data, metrics, max_k, needs_gauc=False):
        """Sampled step (uni<k>/pop<k>; parity: trainer.py:1086-1154): each
        user's P positive slots, then P*k negatives drawn on the device by
        ``draw_negatives``, k for each valid positive; the model's
        ``score_items`` over the candidates, ranked by ``candidate_metric_sums``."""
        model = self.model
        cfg = self.config
        uid_f = cfg["USER_ID_FIELD"]
        n_items = eval_data.n_items
        P, k = eval_data.max_pos, eval_data.neg_k
        rounds = cfg["neg_sampling_resample_rounds"]
        repeatable = getattr(eval_data, "repeatable_sampling", False)
        consts = {}
        if not repeatable:
            eval_data.phase_history.assert_sampleable(eval_data.sample_phase)
            consts["hist"], consts["hlen"] = eval_data.phase_history.device_tables(
                eval_data.sample_phase, self.device)
        transform = getattr(eval_data, "device_transform", None)
        if transform is not None:
            consts.update(transform.consts(self.device))
        if eval_data.distribution == "popularity":
            consts["pop"] = torch.as_tensor(
                eval_data.phase_history.pop_items[eval_data.sample_phase], device=self.device)

        def eval_step(consts, batch):
            pos_items = batch.pop("pos_items")
            pos_len = batch.pop("pos_len")
            mask = batch.pop("_mask")
            if transform is not None:
                batch = transform(batch, consts)
            user_id = batch[uid_f]
            negs = draw_negatives(self.generator, user_id, consts, P * k, n_items, rounds,
                                  repeatable)
            cand = torch.cat([pos_items, negs.to(pos_items.dtype)], dim=1)
            slot = torch.arange(P * (1 + k), device=cand.device)[None, :]
            cand_valid = torch.where(slot < P, slot < pos_len[:, None],
                                     slot - P < (pos_len * k)[:, None])
            return candidate_metric_sums(
                metrics, model.score_items(batch, cand), cand_valid, pos_len, P, max_k, mask,
                (pos_len * (1 + k)).to(torch.float32) if needs_gauc else None)

        return eval_step, consts

    def _make_labeled_eval_step(self, eval_data, metrics, max_k, needs_gauc=False):
        """Ranking over the dataset's own labeled candidates (the fork's
        GeneralNegFromDatasetDataLoader protocol; parity: trainer.py:
        1156-1203): each user's label-1 items, then their label-0 items, no
        history mask, ranked by ``candidate_metric_sums``."""
        model = self.model

        def eval_step(consts, batch):
            pos_items = batch.pop("pos_items")
            pos_len = batch.pop("pos_len")
            neg_items = batch.pop("neg_items")
            neg_len = batch.pop("neg_len")
            mask = batch.pop("_mask")
            P, N = pos_items.shape[1], neg_items.shape[1]
            cand = torch.cat([pos_items, neg_items], dim=1)
            slot = torch.arange(P + N, device=cand.device)[None, :]
            cand_valid = torch.where(slot < P, slot < pos_len[:, None],
                                     slot - P < neg_len[:, None])
            return candidate_metric_sums(
                metrics, model.score_items(batch, cand), cand_valid, pos_len, P, max_k, mask,
                (pos_len + neg_len).to(torch.float32) if needs_gauc else None)

        return eval_step, {}

    def evaluate(self, eval_data, load_best_model=True, model_file=None,
                 show_progress=False):
        if load_best_model:
            self.load_params(model_file or self.saved_model_file)
        if isinstance(eval_data, RowEvalLoader):
            return self._evaluate_individual(eval_data)
        collector = TopKCollector(self.config)
        metrics = tuple(collector.topk_metrics)
        max_k = collector.max_k
        needs_gauc = collector.needs_gauc
        # routed by the loader, as the JAX trainer does (trainer.py:1297-1308)
        if hasattr(eval_data, "neg_items"):
            make = self._make_labeled_eval_step
        elif hasattr(eval_data, "neg_k"):
            make = self._make_sampled_eval_step
        else:
            make = self._make_full_sort_eval_step
        key = (id(eval_data), metrics, max_k, needs_gauc)
        cached = self._eval_step_cache.get(key)
        if cached is None or cached[0] is not eval_data:
            cached = (eval_data,) + make(eval_data, metrics, max_k, needs_gauc)
            self._eval_step_cache[key] = cached
        _, step, consts = cached
        # metric partial sums accumulate on the device; one host transfer
        total = None
        with torch.no_grad():
            for batch in eval_data:
                sums = step(consts, self._upload_eval_batch(batch))
                total = sums if total is None else {
                    k: total[k] + v for k, v in sums.items()}
        if total is not None:
            collector.collect({k: v.cpu().numpy() for k, v in total.items()})
        return collector.evaluate()


class KGTrainer(Trainer):
    """The knowledge family's loop policy (parity: trainer.py:1354-1388,
    reference KGTrainer, trainer.py:455-481): with ``train_rec_step`` or
    ``train_kg_step`` unset every epoch is rskg (rec batches with KG rows
    added); otherwise epochs run in blocks of ``train_rec_step`` rs epochs
    then ``train_kg_step`` kg epochs."""

    def __init__(self, config, model):
        super().__init__(config, model)
        self.train_rec_step = config["train_rec_step"]
        self.train_kg_step = config["train_kg_step"]

    @property
    def default_train_mode(self):
        if self.train_rec_step is None or self.train_kg_step is None:
            return "rskg"
        return "rs"

    def epoch_mode(self, epoch_idx):
        """The train mode of epoch ``epoch_idx``."""
        if self.train_rec_step is None or self.train_kg_step is None:
            return "rskg"
        if epoch_idx % (self.train_rec_step + self.train_kg_step) < self.train_rec_step:
            return "rs"
        return "kg"

    def _train_epoch(self, train_data, epoch_idx, mode=None):
        return super()._train_epoch(train_data, epoch_idx, self.epoch_mode(epoch_idx))


class MKRTrainer(Trainer):
    """MKR's loop policy (parity: trainer.py:1417-1433, reference
    MKRTrainer, trainer.py:570-597): every epoch an rs_only_loss pass
    (``calculate_rs_loss``), and every ``kge_interval``-th epoch (3 unless
    set) a kg pass after it; the epoch reports both parts (the kg part 0 on
    an epoch without one)."""

    default_train_mode = "rs_only_loss"

    def __init__(self, config, model):
        super().__init__(config, model)
        self.kge_interval = config["kge_interval"] or 3

    def epoch_modes(self, epoch_idx):
        """The train modes of epoch ``epoch_idx``, in order."""
        if epoch_idx % self.kge_interval == 0:
            return ("rs_only_loss", "kg")
        return ("rs_only_loss",)

    def _train_epoch(self, train_data, epoch_idx, mode=None):
        modes = self.epoch_modes(epoch_idx)
        parts = ()
        for m in ("rs_only_loss", "kg"):
            loss = super()._train_epoch(train_data, epoch_idx, m) if m in modes else 0.0
            parts += loss if isinstance(loss, tuple) else (loss,)
        return parts


class KGATTrainer(Trainer):
    """KGAT's loop policy (parity: trainer.py:1390-1415, reference
    KGATTrainer, trainer.py:484-508): every epoch an rs pass, a kg pass,
    then the model's ``update_attentive_A`` (no gradient); the epoch reports
    both losses."""

    def _train_epoch(self, train_data, epoch_idx, mode=None):
        rs = super()._train_epoch(train_data, epoch_idx, "rs")
        kg = super()._train_epoch(train_data, epoch_idx, "kg")
        self.model.update_attentive_A()
        return ((rs if isinstance(rs, tuple) else (rs,))
                + (kg if isinstance(kg, tuple) else (kg,)))


class S3RecTrainer(Trainer):
    """S3Rec's two stages (parity: trainer.py:1548-1576, reference
    S3RecTrainer, trainer.py:511-567): with ``train_stage: pretrain`` the
    epochs run with no validation and the model is saved every
    ``save_step`` epochs (10 unless set) and at the last one, the checkpoint
    a finetuning run names as ``pre_model_path``; finetuning is the normal
    ``fit``."""

    def fit(self, train_data, valid_data=None, verbose=True, saved=True,
            show_progress=False, callback_fn=None):
        if getattr(self.model, "train_stage", "finetune") != "pretrain":
            return super().fit(train_data, valid_data, verbose, saved, show_progress,
                               callback_fn)
        if saved:
            ensure_dir(self.checkpoint_dir)
        self.prepare(train_data)
        save_step = self.config["save_step"] or 10
        for epoch_idx in range(self.start_epoch, self.epochs):
            t0 = time.time()
            loss = self._train_epoch(train_data, epoch_idx)
            self.train_loss_dict[epoch_idx] = sum(loss) if isinstance(loss, tuple) else loss
            if verbose:
                self.logger.info("pretrain epoch %d [time: %.2fs, loss: %.4f]", epoch_idx,
                                 time.time() - t0, self.train_loss_dict[epoch_idx])
            if saved and ((epoch_idx + 1) % save_step == 0 or epoch_idx == self.epochs - 1):
                self._save_checkpoint(epoch_idx)
                if verbose:
                    self.logger.info("Saving pretrained model: %s", self.saved_model_file)
        return self.best_valid_score, self.best_valid_result


_MODEL_TRAINERS = {"MKR": MKRTrainer, "KGAT": KGATTrainer, "S3Rec": S3RecTrainer}


def get_trainer(model_type, model_name):
    """parity: reference get_trainer (utils/utils.py:78-96), the JAX
    package's trainer.py:1675-1690. The port has the base Trainer, which
    serves the general, context and sequential families, KGTrainer, the
    knowledge family's default, MKRTrainer, KGATTrainer and S3RecTrainer."""
    if model_name in _MODEL_TRAINERS:
        return _MODEL_TRAINERS[model_name]
    if model_type is ModelType.KNOWLEDGE:
        return KGTrainer
    if model_type not in (ModelType.GENERAL, ModelType.CONTEXT, ModelType.SEQUENTIAL):
        raise NotImplementedError(
            f"trainers for {model_type} models are not ported yet (ROADMAP "
            "Queue 1)")
    return Trainer
