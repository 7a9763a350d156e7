"""STAMP and SRGNN on the port against the JAX package: calculate_loss,
every parameter's gradient and the full-sort / ``score_items`` scores at
rtol 2e-4 on the same converted weights (STAMP with CE and BPR, SRGNN at
two GNN steps), and ``run_recbole`` for each on the CPU. The checks are
those of ``tests/test_torch_gru_users.py``."""

import pytest

# _one_thread: the same autouse fixture, one torch thread a test
from tests.test_torch_gru_users import _one_thread, check_case, check_run_recbole  # noqa: F401

CASES = {
    "STAMP": ("STAMP", {}),
    "STAMP-BPR": ("STAMP", {"loss_type": "BPR", "training_neg_sample_num": 1}),
    "SRGNN": ("SRGNN", {"step": 2}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_gradients_and_scores_match_jax(case, synth_dataset_dir, tmp_path):
    check_case(case, *CASES[case], synth_dataset_dir, tmp_path)


@pytest.mark.parametrize("model", ["STAMP", "SRGNN"])
def test_run_recbole_on_cpu(model, synth_dataset_dir, tmp_path):
    check_run_recbole(model, synth_dataset_dir, tmp_path)
