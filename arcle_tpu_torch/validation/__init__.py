from .trace_replay import (
    convert_ui_action, replay_trace, replay_trace_firstsel,
    generate_golden_traces, generate_adversarial_traces, ReplayReport,
)

__all__ = ["convert_ui_action", "replay_trace", "replay_trace_firstsel",
           "generate_golden_traces", "generate_adversarial_traces",
           "ReplayReport"]
