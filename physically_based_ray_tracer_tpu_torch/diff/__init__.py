from physically_based_ray_tracer_tpu_torch.diff.grad import apply_params, render_color  # noqa: F401
