"""Benchmark suites reproducing the reference's published experiments:
the paper's §4.1 answer-given setting (:mod:`.answer_given`) and the
offline evaluator of its checkpoints (:mod:`.eval_answer_given`, run it
with ``python -m arcle_tpu_torch.benchmarks.eval_answer_given``)."""

from .answer_given import (
    AnswerGivenConfig, RandomPairLoader, answer_given_agent,
    answer_given_env, answer_obs, color_table, make_policy,
    shaping_potential, small_arc_loader,
)

__all__ = [
    "AnswerGivenConfig", "RandomPairLoader", "answer_given_agent",
    "answer_given_env", "answer_obs", "color_table", "make_policy",
    "shaping_potential", "small_arc_loader",
]
