from magics_tpu_torch.planner.global_planner import GlobalPlanner

__all__ = ["GlobalPlanner"]
