from tracking_tpu_torch.io.video import VideoSource, read_cdnet_dir, read_frame_dir, read_video  # noqa: F401
