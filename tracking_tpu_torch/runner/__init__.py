from tracking_tpu_torch.runner.scan import make_step_fn, run_video  # noqa: F401
