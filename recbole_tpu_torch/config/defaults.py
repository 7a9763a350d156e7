"""Built-in default configuration.

Port of recbole_tpu/config/defaults.py. The key set is the JAX package's,
so config files written for it load unchanged; keys that only steer JAX
(``platform``, ``scan_epochs``, ``prng_impl``, ``use_pallas_topk``,
``compute_dtype``, ...) keep their names and are read as the README's port
section says. ``device`` is the port's own key.
"""

# --- global defaults (parity: recbole/properties/overall.yaml) ---
GENERAL_DEFAULTS = {
    "gpu_id": 0,            # kept for config compat; use device: "cuda:<n>"
    "use_gpu": True,        # kept for config compat; use device: "cpu"
    # torch device of the run: "cuda" (or "cuda:<n>") unless "cpu" is asked
    # for explicitly; asking for CUDA without a card raises
    "device": "cuda",
    "platform": None,       # JAX platform override; no effect in the port
    "seed": 2020,
    "state": "INFO",
    "reproducibility": True,
    "data_path": "dataset/",
    "checkpoint_dir": "saved",
    "show_progress": True,
    "log_dir": "./log",
}

TRAINING_DEFAULTS = {
    "epochs": 300,
    "train_batch_size": 2048,
    "learner": "adam",
    "learning_rate": 0.001,
    "training_neg_sample_num": 1,
    "training_neg_sample_distribution": "uniform",
    "eval_step": 1,
    "stopping_step": 10,
    "clip_grad_norm": None,
    "weight_decay": 0.0,
    "draw_loss_pic": False,
    # --- keys added by the JAX package; see the README's port section ---
    "param_dtype": "float32",       # master params
    "compute_dtype": "auto",        # float32; bfloat16 for the sequential family
    "neg_sampling_resample_rounds": 8,  # bounded device-side rejection rounds
    "prng_impl": "rbg",             # JAX key type; the port uses torch.Generator
    "donate_buffers": True,         # JAX buffer donation; no effect in the port
    # JAX's scanned epoch; the port always keeps the train columns on the
    # device and slices shuffled batches there, whatever these say
    "scan_epochs": True,
    "scan_epochs_max_bytes": 2 << 30,
    "profile_trace_dir": None,      # not ported yet (ROADMAP Queue 1, item 12)
    "fused_attention": "layer2",    # the whole-layer transformer kernel
    # KG trainer loop policies (parity: KGTrainer/MKRTrainer config keys)
    "train_rec_step": None,
    "train_kg_step": None,
    "kge_interval": 3,
}

EVALUATION_DEFAULTS = {
    "eval_setting": "RO_RS,full",
    "group_by_user": True,
    "split_ratio": [0.8, 0.1, 0.1],
    "leave_one_num": 2,
    "real_time_process": False,
    "metrics": ["Recall", "MRR", "NDCG", "Hit", "Precision"],
    "topk": [10],
    "valid_metric": "MRR@10",
    "valid_metric_bigger": True,
    "eval_batch_size": 4096,
    # full-sort eval scores: float32, or "bfloat16" (the masked top-k's
    # bf16-operand instance; bf16-rounded parameters in the chunked step);
    # the port has one full-sort path, the masked top-k kernel on the card,
    # so use_pallas_topk has no effect
    "eval_score_dtype": "float32",
    "use_pallas_topk": False,
    "compilation_cache_dir": "/tmp/recbole_tpu_xla_cache",  # JAX only
    "loss_decimal_place": 4,
    "metric_decimal_place": 4,
    # fork behavior (reference data/utils.py:84-88): when eval is full-sort and no
    # benchmark files exist, validation is downgraded to uniform-1000 sampled eval.
    "valid_full_to_uni1000": False,
    # fork flags (reference data/utils.py:244-252)
    "train_use_dataset_negatives": False,
    "eval_use_dataset_negatives": False,
    "train_use_bothway_sampler": False,
    "eval_use_bothway_sampler": False,
}

DATASET_DEFAULTS = {
    # atomic file format
    "field_separator": "\t",
    "seq_separator": " ",
    # common fields
    "USER_ID_FIELD": "user_id",
    "ITEM_ID_FIELD": "item_id",
    "RATING_FIELD": "rating",
    "TIME_FIELD": "timestamp",
    "seq_len": None,
    # pointwise label
    "LABEL_FIELD": "label",
    "threshold": None,
    # pairwise negative prefix
    "NEG_PREFIX": "neg_",
    # selective loading
    "load_col": {"inter": ["user_id", "item_id"]},
    "unload_col": None,
    "unused_col": None,
    "additional_feat_suffix": None,
    # filtering
    "rm_dup_inter": None,
    "lowest_val": None,
    "highest_val": None,
    "equal_val": None,
    "not_equal_val": None,
    "filter_inter_by_user_or_item": True,
    "max_user_inter_num": None,
    "min_user_inter_num": 0,
    "max_item_inter_num": None,
    "min_item_inter_num": 0,
    # preprocessing
    "fields_in_same_space": None,
    "preload_weight": None,
    "normalize_field": None,
    "normalize_all": None,
    # sequential
    "ITEM_LIST_LENGTH_FIELD": "item_length",
    "LIST_SUFFIX": "_list",
    "MAX_ITEM_LIST_LENGTH": 50,
    "POSITION_FIELD": "position_id",
    # knowledge graph
    "HEAD_ENTITY_ID_FIELD": "head_id",
    "TAIL_ENTITY_ID_FIELD": "tail_id",
    "RELATION_ID_FIELD": "relation_id",
    "ENTITY_ID_FIELD": "entity_id",
    # social
    "SOURCE_ID_FIELD": "source_id",
    "TARGET_ID_FIELD": "target_id",
    # pre-split benchmark files
    "benchmark_filename": None,
}

PARALLEL_DEFAULTS = {
    # scale-out keys of the JAX package; the port runs on one device, and
    # setting mesh_shape or the distributed keys raises until parallel/ is
    # ported (ROADMAP Queue 1, item 11)
    "mesh_shape": None,
    "shard_item_embeddings": False,
    "shard_full_sort": True,
    "distributed_auto_init": False,
    "distributed_coordinator": None,   # "host0:1234"
    "distributed_num_processes": None,
    "distributed_process_id": None,
}

DEFAULTS = {
    **GENERAL_DEFAULTS,
    **TRAINING_DEFAULTS,
    **EVALUATION_DEFAULTS,
    **DATASET_DEFAULTS,
    **PARALLEL_DEFAULTS,
}

# categorized key lists for pretty-printing (parity: recbole/utils/argument_list.py)
ARGUMENT_CATEGORIES = {
    "General Hyper Parameters": list(GENERAL_DEFAULTS),
    "Training Hyper Parameters": list(TRAINING_DEFAULTS),
    "Evaluation Hyper Parameters": list(EVALUATION_DEFAULTS),
    "Dataset Hyper Parameters": list(DATASET_DEFAULTS),
    "Parallelism Hyper Parameters": list(PARALLEL_DEFAULTS),
}
