from magics_tpu_torch.viz.render import record_frames, render_frame, render_trajectories

__all__ = ["render_frame", "render_trajectories", "record_frames"]
