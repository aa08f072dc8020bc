from . import closed_form, pose_graph  # noqa: F401
from .closed_form import refine_lum, refine_slerp, refine_slerp_lum  # noqa: F401
from .pose_graph import PoseGraph, build_circuit_graph, global_optimization  # noqa: F401
