"""Trainer: train step, epoch loop, checkpoints, full-sort and value-metric
evaluation.

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
    sequential family, whose items may repeat); labeled rows (the CTR
    protocols: no sampling, or no user/item ids at all) pass through as they
    are; a loader's ``device_transform`` (the sequential family's
    padded-sequence gather) runs first;
  * a model may return its loss as a tuple of parts: the step sums them for
    the gradient and the epoch reports each part (parity: trainer.py:367);
  * train modes (``_build_mode``, parity: trainer.py:447-500): ``rs`` (rec
    batches, ``calculate_loss``), ``kg`` (KG triples with a negative tail
    each, ``calculate_kg_loss``), ``rskg`` (rec batches with random KG rows
    added, ``calculate_loss``) and ``rs_only_loss`` (``calculate_rs_loss``);
    ``KGTrainer`` picks one per epoch;
  * row 0 of every ``pad_zero_params`` gradient is zeroed before Adam, so a
    [PAD] embedding row never trains;
  * the model is in train mode only inside the step, and draws its dropout
    masks from the trainer's generator;
  * Adam is the single-pass in-place sweep of ops/fused_adam.py for every
    float32 leaf (``_fused_adam_apply``);
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
  * value-metric evaluation (``_evaluate_individual``) uploads the eval
    table once, predicts in device-sliced batches, and computes AUC/LogLoss
    on the device.

``get_trainer`` serves the general, context and sequential families with
``Trainer`` and the knowledge family with ``KGTrainer``. Still raising:
other learners, gradient clipping, weight decay, dataset negatives and the
both-way sampler, the sampled and labeled eval steps, bfloat16 eval scores
and the other trainer subclasses (KGAT's, MKR's and the rest: ROADMAP
Queue 1).
"""

import os
import time

import numpy as np
import torch

from ..models.base import AbstractRecommender, SequentialRecommender
from ..utils.enums import InputType, ModelType
from ..utils.logger import get_logger, get_local_time, set_color
from ..utils.utils import early_stopping, calculate_valid_score, dict2str, ensure_dir
from ..data.loaders import RowEvalLoader
from ..evaluator.evaluator import topk_metric_sums, TopKCollector, ValueCollector
from ..sampler.sampler import sample_negatives, sample_negatives_unchecked
from ..ops.fused_adam import adam_leaf
from ..ops.masked_topk import masked_topk

# the score of a masked item in the non-fused full-sort step (parity:
# trainer.py:36)
NEG_INF = -1e15


def build_optimizer(config):
    """Validate the optimizer settings (parity: _build_optimizer,
    trainer.py:109-130). The port has the fused Adam path only."""
    name = str(config["learner"]).lower()
    if name != "adam":
        raise NotImplementedError(
            f"learner {config['learner']!r} is not ported yet (ROADMAP "
            "Queue 1, item 5); the port trains with adam")
    if config["clip_grad_norm"] or config["weight_decay"]:
        raise NotImplementedError(
            "clip_grad_norm and weight_decay are not ported yet (ROADMAP "
            "Queue 1, item 5)")
    return {"lr": float(config["learning_rate"])}


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
        pure-feature protocol, and no sampling); pairwise models get a
        sampled negative column; pointwise ones their rows (labelled from the
        data, or by ``_weight``, or 1) followed by k rows of sampled
        negatives labelled 0. Returns (augment, consts)."""
        model = self.model
        cfg = self.config
        uid_f = cfg["USER_ID_FIELD"]
        iid_f = cfg["ITEM_ID_FIELD"]
        if cfg["train_use_dataset_negatives"] or cfg["train_use_bothway_sampler"]:
            raise NotImplementedError(
                "train_use_dataset_negatives and train_use_bothway_sampler are "
                "not ported yet (ROADMAP Queue 1, item 3)")
        neg_args = cfg["train_neg_sample_args"]
        k = int(neg_args.get("by") or 0) if neg_args["strategy"] == "by" else 0
        transform = getattr(train_data, "device_transform", None)
        if uid_f is None or iid_f is None or (
                k == 0 and model.input_type is not InputType.PAIRWISE):
            # pure-feature CTR protocol (Criteo/Avazu: USER_ID_FIELD: ~), or
            # labeled rows used as they are: nothing to sample
            if transform is None:
                return (lambda batch, generator, consts: batch), {}
            return ((lambda batch, generator, consts: transform(batch, consts)),
                    dict(transform.consts(self.device)))
        pointwise = model.input_type is InputType.POINTWISE
        if not pointwise and model.input_type is not InputType.PAIRWISE:
            raise NotImplementedError(
                f"{model.input_type} training with sampled negatives is not "
                "ported yet (ROADMAP Queue 1, item 3)")
        if k < 1:
            raise ValueError("pairwise training needs training_neg_sample_num >= 1")
        rounds = cfg["neg_sampling_resample_rounds"]
        neg_f = cfg["NEG_PREFIX"] + iid_f
        label_f = cfg["LABEL_FIELD"]
        n_items = train_data.n_items
        # sequential models sample without used-id exclusion: items may repeat
        # in a history (parity: RepeatableSampler, sampler.py:341-420)
        repeatable = model.type is ModelType.SEQUENTIAL
        consts = {}
        if not repeatable:
            train_data.phase_history.assert_sampleable("train")
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
            if repeatable:
                negs = sample_negatives_unchecked(
                    generator, (batch[uid_f].shape[0], k), n_items,
                    pop_items=consts.get("pop"), device=self.device)
            else:
                negs = sample_negatives(generator, batch[uid_f], consts["hist"],
                                        consts["hlen"], n_items, k, rounds=rounds,
                                        pop_items=consts.get("pop"))
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
        params = dict(self.model.named_parameters())
        bad = [n for n, p in params.items() if p.dtype != torch.float32]
        if bad:
            raise NotImplementedError(f"non-float32 parameters {bad}: the port's "
                                      "Adam sweeps float32 leaves only")
        zeros = {n: torch.zeros_like(p) for n, p in params.items()}
        return {"count": 0, "mu": zeros,
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def _fused_adam_apply(self, grads):
        """One Adam step over every parameter, in place (parity:
        trainer.py:317-354, same defaults as optax.adam). c1 and c2 come from
        the integer step count on the host, so nothing waits on the device."""
        b1, b2, eps = self.ADAM_B1, self.ADAM_B2, self.ADAM_EPS
        lr = self.optimizer["lr"]
        self.opt_state["count"] += 1
        t = self.opt_state["count"]
        c1 = 1.0 / (1.0 - b1 ** t)
        c2 = 1.0 / (1.0 - b2 ** t)
        for name, p in self.model.named_parameters():
            adam_leaf(p.data, self.opt_state["mu"][name],
                      self.opt_state["nu"][name], grads[name], c1, c2,
                      b1=b1, b2=b2, lr=lr, eps=eps)

    def _make_step_core(self, augment, loss_method):
        """step_core(batch, consts) -> detached loss (a vector of its parts
        when the loss method returns a tuple): augment, loss, gradients and
        the fused Adam update, drawing randomness (negatives, dropout masks)
        from ``self.generator`` (parity: trainer.py:356-395). The model is in
        train mode for the loss only."""
        params = dict(self.model.named_parameters())
        pad_zero = [k for k in getattr(self.model, "pad_zero_params", ()) if k in params]

        def step_core(batch, consts):
            batch = augment(batch, self.generator, consts)
            self.model.train()
            try:
                out = loss_method(batch, generator=self.generator)
            finally:
                self.model.eval()
            # a tuple of loss parts: their sum is the loss, each is reported
            loss = sum(out) if isinstance(out, tuple) else out
            # a leaf the loss does not reach (LR never reads the embedding
            # of a float field) gets a zero gradient, as jax.grad gives it
            grads = {name: torch.zeros_like(params[name]) if g is None else g
                     for name, g in zip(params, torch.autograd.grad(
                         loss, list(params.values()), allow_unused=True))}
            # the reference's Embedding(padding_idx=0) never updates row 0:
            # with a zero gradient the [PAD] row and its moments stay zero
            for name in pad_zero:
                grads[name][0] = 0.0
            self._fused_adam_apply(grads)
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

    def _save_checkpoint(self, epoch):
        """torch.save of the learned state, moments and generator state
        (parity: trainer.py:805-826; single device)."""
        state = {
            "config": dict(self.config.final),
            "epoch": epoch,
            "cur_step": self.cur_step,
            "train_loss_dict": dict(self.train_loss_dict),
            "best_valid_score": self.best_valid_score,
            "best_valid_result": self.best_valid_result,
            "params": {n: p.detach().cpu() for n, p in self.model.named_parameters()},
            "opt_state": {
                "count": self.opt_state["count"],
                "mu": {n: t.cpu() for n, t in self.opt_state["mu"].items()},
                "nu": {n: t.cpu() for n, t in self.opt_state["nu"].items()},
            },
            "rng": self.generator.get_state(),
        }
        torch.save(state, self.saved_model_file)

    def _load_state(self, path):
        # the file is one this trainer wrote: its config holds enums, which
        # torch.load's weights_only mode refuses
        return torch.load(path, map_location="cpu", weights_only=False)

    def _load_params(self, params):
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(params[n])

    def resume_checkpoint(self, resume_file):
        state = self._load_state(resume_file)
        self.start_epoch = state["epoch"] + 1
        self.cur_step = state.get("cur_step", 0)
        self.train_loss_dict = dict(state.get("train_loss_dict", {}))
        self.best_valid_score = state["best_valid_score"]
        self.best_valid_result = state.get("best_valid_result")
        self._load_params(state["params"])
        opt = state["opt_state"]
        self.opt_state = {
            "count": opt["count"],
            "mu": {n: t.to(self.device) for n, t in opt["mu"].items()},
            "nu": {n: t.to(self.device) for n, t in opt["nu"].items()},
        }
        self.generator.set_state(state["rng"])
        if state["config"].get("model") != self.config["model"]:
            self.logger.warning("Architecture configuration given in config file is "
                                "different from that of checkpoint.")
        self.logger.info("Checkpoint loaded. Resume training from epoch %d",
                         self.start_epoch)

    def load_params(self, model_file):
        self._load_params(self._load_state(model_file)["params"])

    # ------------------------------------------------------------- evaluation

    def _make_full_sort_eval_step(self, eval_data, metrics, max_k):
        """Full-sort step: the loader's device transform, then [PAD] masked
        always and the user's earlier-phase items unless the loader has
        ``mask_history = False``, then the hits reduce to metric partial
        sums. A model with ``full_sort_query`` in its own class, or with the
        sequential base's ``full_sort_predict`` and ``full_sort_query``
        unchanged, takes the fused path (parity: trainer.py:934-1004, the
        ``opted_in or base_stack`` rule :938-951): its query and item table
        go through the masked top-k. A model with ``full_sort_predict`` only
        takes the non-fused
        one (parity: trainer.py:1052-1075): float32 scores from
        ``full_sort_predict`` or, for a model with neither, from chunks of
        ``score_items``; NEG_INF in the [PAD] column and added at the
        history, ``torch.topk``."""
        model = self.model
        uid_f = self.config["USER_ID_FIELD"]
        if str(self.config["eval_score_dtype"]).lower() != "float32":
            raise NotImplementedError(
                "eval_score_dtype other than float32 is not ported yet "
                "(ROADMAP Queue 1, item 5)")
        fused = fused_full_sort(type(model))
        has_full_sort = (type(model).full_sort_predict
                         is not AbstractRecommender.full_sort_predict)
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
            scores = [model.score_items(batch, c[None, :].expand(B, chunk)) for c in items]
            return torch.cat(scores, dim=1)[:, :n_items]

        def eval_step(consts, batch):
            pos_items = batch.pop("pos_items")
            pos_len = batch.pop("pos_len")
            mask = batch.pop("_mask")
            if transform is not None:
                batch = transform(batch, consts)
            user_id = batch[uid_f]
            invalid = invalid_item_mask(user_id, consts["hist"], consts["hlen"],
                                        n_items)
            if fused:
                query, table = model.full_sort_query(batch)
                _, topk_idx = masked_topk(query.contiguous(), table.contiguous(),
                                          invalid, max_k)
            else:
                scores = all_item_scores(batch).to(torch.float32)
                scores = torch.where(invalid > 0, scores + NEG_INF, scores)
                scores[:, 0] = NEG_INF
                _, topk_idx = torch.topk(scores, max_k, dim=1)
            pos_valid = (torch.arange(pos_items.shape[1], device=pos_items.device)[None, :]
                         < pos_len[:, None])
            pos_index = ((topk_idx[:, :, None].long() == pos_items[:, None, :])
                         & pos_valid[:, None, :]).any(dim=-1).to(torch.int32)
            return topk_metric_sums(metrics, pos_index, pos_len, mask)

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
        computed there and only their values return to the host."""
        label_f = self.config["LABEL_FIELD"]
        cached = getattr(eval_data, "_individual_cache", None)
        if cached is None or cached[0] is not self:
            cached = (self, self._upload_table(eval_data.fields))
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

    def evaluate(self, eval_data, load_best_model=True, model_file=None,
                 show_progress=False):
        if load_best_model:
            self.load_params(model_file or self.saved_model_file)
        if isinstance(eval_data, RowEvalLoader):
            return self._evaluate_individual(eval_data)
        collector = TopKCollector(self.config)
        metrics = tuple(collector.topk_metrics)
        max_k = collector.max_k
        key = (id(eval_data), metrics, max_k)
        cached = self._eval_step_cache.get(key)
        if cached is None or cached[0] is not eval_data:
            cached = (eval_data,) + self._make_full_sort_eval_step(
                eval_data, metrics, max_k)
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


# knowledge models whose own trainers are not ported yet
_KG_TRAINERS_NOT_PORTED = ("KGAT", "MKR")


def get_trainer(model_type, model_name):
    """parity: reference get_trainer (utils/utils.py:78-96), the JAX
    package's trainer.py:1675-1690. The port has the base Trainer, which
    serves the general, context and sequential families, and KGTrainer, the
    knowledge family's default."""
    if model_name in _KG_TRAINERS_NOT_PORTED:
        raise NotImplementedError(
            f"{model_name}'s trainer is not ported yet (ROADMAP Queue 1, item 9)")
    if model_type is ModelType.KNOWLEDGE:
        return KGTrainer
    if model_type not in (ModelType.GENERAL, ModelType.CONTEXT, ModelType.SEQUENTIAL):
        raise NotImplementedError(
            f"trainers for {model_type} models are not ported yet (ROADMAP "
            "Queue 1)")
    return Trainer
