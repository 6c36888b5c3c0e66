from .groups import G, OBJ, answers_match
from .table import (
    OpTable, raw_table, arc_table, o2arc_table, transition_deferred,
    finish_flood, step_deferred, step, answers_match_any, pixel_reward,
    dense_reward, FLOOD_UNROLL,
)
from .step_kernel import (
    complete_step, cuda_step_deferred, plain_step_deferred,
)

__all__ = [
    "G", "OBJ", "answers_match", "OpTable", "raw_table", "arc_table",
    "o2arc_table", "transition_deferred", "finish_flood", "step_deferred",
    "step", "answers_match_any", "pixel_reward", "dense_reward",
    "FLOOD_UNROLL", "complete_step", "cuda_step_deferred",
    "plain_step_deferred",
]
