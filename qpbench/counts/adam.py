"""Work of the optimizer step (``train/harness.py::ClippedAdam``): the
global norm (2 operations a parameter), the clip (1) and Adam (about 12),
float32.  Bytes: the parameters, gradients and both moments read, the
parameters and moments written."""


def work(s):
    P = s["params"]
    return dict(bytes=4 * P * 7, bf16_ops=0.0, f32_ops=15.0 * P)
