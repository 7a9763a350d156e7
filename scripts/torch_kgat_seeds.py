"""Train the port's KGAT on the bundled ml-100k under the knowledge models'
quality protocol (RO_RS full sort, 10 epochs, early stopping on mrr@10,
``valid_full_to_uni1000: False``) at one seed, and score the test split of
the best epoch two ways:

* ``test``: as ``run_recbole`` scores it, the best checkpoint's weights and
  attention, with the dense (users x items) attention blocks rebuilt from
  that attention;
* ``test_initial_dense_blocks``: the same weights and attention, with the
  dense blocks the model was built with (the row-normalised adjacency), as
  the JAX package's reload leaves them: its checkpoint drops the blocks with
  its dataset-derived constants, and its reload rebuilds those from a fresh
  model.

    python scripts/torch_kgat_seeds.py --seed 2020 [--device cpu] [--out DIR]

Prints each epoch's losses and valid score, the best epoch, and one JSON line
``{"seed": ..., "best_epoch": ..., "valid": [...], "test": {...},
"test_initial_dense_blocks": {...}}``. On the CPU a seed takes about ten
minutes with four threads.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2020)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None, help="checkpoint folder (default: a temporary one)")
    args = ap.parse_args()

    import torch
    from recbole_tpu_torch.config.configurator import Config
    from recbole_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_tpu_torch.models import get_model
    from recbole_tpu_torch.trainer.trainer import get_trainer
    from recbole_tpu_torch.utils.utils import init_device, init_seed

    torch.set_num_threads(args.threads)
    out = args.out or tempfile.mkdtemp(prefix="kgat_seeds_")
    config = Config(model="KGAT", dataset="ml-100k", config_dict={
        "epochs": 10, "valid_full_to_uni1000": False, "device": args.device,
        "seed": args.seed, "state": "ERROR", "show_progress": False,
        "checkpoint_dir": out}, _parse_cmd_line=False)
    init_device(config)
    init_seed(config["seed"], config["reproducibility"])
    train, valid, test = data_preparation(config, create_dataset(config))
    model = get_model("KGAT")(config, train.dataset)
    initial = (model.att_ui_dense.clone(), model.att_iu_dense.clone())
    trainer = get_trainer(config["MODEL_TYPE"], "KGAT")(config, model)
    curve = []

    def record(epoch, score):
        curve.append(score)
        print(f"epoch {epoch} valid mrr@10 {score:.4f} losses "
              f"{trainer.train_loss_dict.get(epoch)}", flush=True)

    trainer.fit(train, valid, saved=True, verbose=False, callback_fn=record)
    result = trainer.evaluate(test, load_best_model=True)
    model.att_ui_dense.copy_(initial[0])
    model.att_iu_dense.copy_(initial[1])
    jax_like = trainer.evaluate(test, load_best_model=False)
    print(json.dumps({"seed": args.seed, "device": args.device,
                      "best_epoch": max(range(len(curve)), key=lambda e: (curve[e], -e)),
                      "valid": curve, "test": result,
                      "test_initial_dense_blocks": jax_like}))


if __name__ == "__main__":
    main()
