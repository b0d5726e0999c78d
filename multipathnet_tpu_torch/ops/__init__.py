from multipathnet_tpu_torch.ops import boxes, nms  # noqa: F401
