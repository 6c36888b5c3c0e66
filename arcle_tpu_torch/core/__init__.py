from .state import (
    EnvState, Action, init_state, empty_state, state_from_numpy,
    state_to_numpy, FIELDS, make_action,
)
from .geometry import (
    bbox, inside_dims, shift2d, window_mask, place_patch, bbox_selection,
    bbox_selection_flat, point_selection, point_selection_flat, row_col_iota,
)
from .floodfill import (
    sweep, connected_component, connected_component_partial, flood_region,
)

__all__ = [
    "EnvState", "Action", "init_state", "empty_state", "state_from_numpy",
    "state_to_numpy", "FIELDS", "make_action",
    "bbox", "inside_dims", "shift2d", "window_mask", "place_patch",
    "bbox_selection", "bbox_selection_flat", "point_selection",
    "point_selection_flat", "row_col_iota",
    "sweep", "connected_component", "connected_component_partial",
    "flood_region",
]
