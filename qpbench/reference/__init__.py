"""The plain reference: straightforward PyTorch of the same mathematics as
the program, float32 with TF32 off, imports nothing of the program and
takes nothing the program made.  The bf16 profile's rounding points are
the configuration's, applied by :mod:`.precision`."""
