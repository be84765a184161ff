from .ruiz import ruiz_scale, scale_batch

__all__ = ["ruiz_scale", "scale_batch"]
