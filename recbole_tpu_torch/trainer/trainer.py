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
  * negatives are drawn on the device inside the step (``_make_rec_augment``,
    the pairwise branch; without exclusion for the sequential family, whose
    items may repeat); labeled rows (the CTR protocols: no sampling, or no
    user/item ids at all) pass through as they are; a loader's
    ``device_transform`` (the sequential family's padded-sequence gather)
    runs first;
  * row 0 of every ``pad_zero_params`` gradient is zeroed before Adam, so a
    [PAD] embedding row never trains;
  * the model is in train mode only inside the step, and draws its dropout
    masks from the trainer's generator;
  * Adam is the single-pass in-place sweep of ops/fused_adam.py for every
    float32 leaf (``_fused_adam_apply``);
  * full-sort evaluation always goes through ops/masked_topk.py, masking
    [PAD] and, unless the loader says ``mask_history = False`` (sequential
    splits), the user's earlier-phase items; each batch reduces to
    per-metric partial sums on the device;
  * value-metric evaluation (``_evaluate_individual``) uploads the eval
    table once, predicts in device-sliced batches, and computes AUC/LogLoss
    on the device.

``get_trainer`` serves the general, context and sequential families. Still
raising: other learners, gradient clipping, weight decay, the POINTWISE branch that
samples negatives, dataset negatives and the both-way sampler, the sampled
and labeled eval steps, the non-fused ``all_item_scores`` path, bfloat16
eval scores and the trainer subclasses (ROADMAP Queue 1).
"""

import os
import time

import numpy as np
import torch

from ..utils.enums import InputType, ModelType
from ..utils.logger import get_logger, get_local_time, set_color
from ..utils.utils import early_stopping, calculate_valid_score, dict2str, ensure_dir
from ..data.loaders import RowEvalLoader
from ..evaluator.evaluator import topk_metric_sums, TopKCollector, ValueCollector
from ..sampler.sampler import sample_negatives, sample_negatives_unchecked
from ..ops.fused_adam import adam_leaf
from ..ops.masked_topk import masked_topk


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
        self._mode = None
        self._eval_step_cache = {}
        # shuffling and negatives draw from their own stream, apart from the
        # model's init stream (seeded with ``seed``)
        seed = config["seed"] or 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    # ------------------------------------------------------------- train step

    def _make_rec_augment(self, train_data):
        """Device-side batch shaping (parity: trainer.py:166-289): the
        loader's device transform first; then labeled rows pass through (the
        pure-feature protocol, and no sampling) and pairwise models get
        sampled negatives. Returns (augment, consts)."""
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
        if model.input_type is not InputType.PAIRWISE:
            raise NotImplementedError(
                f"{model.input_type} training with sampled negatives is not "
                "ported yet (ROADMAP Queue 1, item 3)")
        if k < 1:
            raise ValueError("pairwise training needs training_neg_sample_num >= 1")
        rounds = cfg["neg_sampling_resample_rounds"]
        neg_f = cfg["NEG_PREFIX"] + iid_f
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
        """step_core(batch, consts) -> detached loss: augment, loss, gradients
        and the fused Adam update, drawing randomness (negatives, dropout
        masks) from ``self.generator`` (parity: trainer.py:356-395). The
        model is in train mode for the loss only."""
        params = dict(self.model.named_parameters())
        pad_zero = [k for k in getattr(self.model, "pad_zero_params", ()) if k in params]

        def step_core(batch, consts):
            batch = augment(batch, self.generator, consts)
            self.model.train()
            try:
                loss = loss_method(batch, generator=self.generator)
            finally:
                self.model.eval()
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

    def _build_mode(self, train_data):
        if self._mode is None:
            augment, consts = self._make_rec_augment(train_data)
            self._mode = {"step": self._make_step_core(augment, self.model.calculate_loss),
                          "consts": consts,
                          "tables": self._upload_table(train_data.columns())}
        return self._mode

    def _train_epoch(self, train_data, epoch_idx):
        """One epoch of shuffled batches sliced on the device. The loss stays
        on the device until the epoch ends; the NaN check (parity: reference
        trainer.py:234-236) runs once per epoch on the total."""
        mode = self._build_mode(train_data)
        n, B = train_data.n, train_data.batch_size
        if train_data.shuffle:
            order = torch.randperm(n, generator=self.generator, device=self.device)
        else:
            order = torch.arange(n, device=self.device)
        total = torch.zeros((), device=self.device)
        for start in range(0, n, B):
            idx = order[start:start + B]
            total += mode["step"](self._take_batch(mode["tables"], idx), mode["consts"])
        total = float(total)
        if np.isnan(total):
            raise ValueError(f"Training loss is nan at epoch {epoch_idx}")
        return total

    def prepare(self, train_data):
        """Initialize the optimizer state and build the train step."""
        if self.opt_state is None:
            self.opt_state = self._fused_adam_init()
        self._mode = None
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
            self.train_loss_dict[epoch_idx] = train_loss
            t1 = time.time()
            if verbose:
                self.logger.info("epoch %d training [time: %.2fs, train loss: %.4f]",
                                 epoch_idx, t1 - t0, train_loss)

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
        """Fused full-sort step (parity: trainer.py:934-1004): the loader's
        device transform, then the model's query and item table go through
        the masked top-k ([PAD] masked always, the user's earlier-phase items
        unless the loader has ``mask_history = False``), then the hits reduce
        to metric partial sums."""
        model = self.model
        uid_f = self.config["USER_ID_FIELD"]
        if str(self.config["eval_score_dtype"]).lower() != "float32":
            raise NotImplementedError(
                "eval_score_dtype other than float32 is not ported yet "
                "(ROADMAP Queue 1, item 5)")
        if not hasattr(model, "full_sort_query"):
            raise NotImplementedError(
                "full-sort eval of models without full_sort_query (the "
                "all_item_scores path) is not ported yet (ROADMAP Queue 1, item 5)")
        consts = {"hist": None, "hlen": None}
        if getattr(eval_data, "mask_history", True):
            consts["hist"], consts["hlen"] = eval_data.phase_history.device_tables(
                eval_data.mask_phase, self.device)
        transform = getattr(eval_data, "device_transform", None)
        if transform is not None:
            consts.update(transform.consts(self.device))
        n_items = eval_data.n_items

        def eval_step(consts, batch):
            pos_items = batch.pop("pos_items")
            pos_len = batch.pop("pos_len")
            mask = batch.pop("_mask")
            if transform is not None:
                batch = transform(batch, consts)
            user_id = batch[uid_f]
            query, table = model.full_sort_query(batch)
            invalid = invalid_item_mask(user_id, consts["hist"], consts["hlen"],
                                        n_items)
            _, topk_idx = masked_topk(query.contiguous(), table.contiguous(),
                                      invalid, max_k)
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


def get_trainer(model_type, model_name):
    """parity: reference get_trainer (utils/utils.py:78-96). The port has
    the base Trainer, which serves the general, context and sequential
    families."""
    if model_type not in (ModelType.GENERAL, ModelType.CONTEXT, ModelType.SEQUENTIAL):
        raise NotImplementedError(
            f"trainers for {model_type} models are not ported yet (ROADMAP "
            "Queue 1)")
    return Trainer
